"""Transfer cost model — the analytical backbone of Fig. 4/5.

The paper's measured curves follow the classic two-parameter DMA model

    t(n) = t0 + n / BW          (per transfer)
    t(n)/n = t0/n + 1/BW        (per byte, the Fig. 5 view)

where ``t0`` is the fixed software overhead of the driver path (descriptor
setup, syscalls/context switches for the kernel driver, polling-loop entry for
the user driver) and ``BW`` the asymptotic link bandwidth. BLOCKS partitioning
with chunk size ``c`` pays the overhead per chunk but overlaps transfers when
DOUBLE-buffered:

    t_blocks(n) = ceil(n/c) * t0 + n/BW                      (single buffer)
    t_blocks(n) = t0 + max(ceil(n/c)-1, 0)*max(t0, c/BW) + c/BW   (double)

The model is used three ways:
1. fit measured host-side sweeps (benchmarks/transfer_sweep.py) and report the
   crossover size between driver modes — the paper's headline observation;
2. napkin math during §Perf hillclimbing (predict chunking deltas).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.transfer import Buffering, Partitioning, TransferPolicy


@dataclass(frozen=True)
class TransferCostModel:
    """t(n) = t0 + n/bw, with policy-aware composition."""

    t0_s: float  # fixed per-transfer overhead (s)
    bw_Bps: float  # asymptotic bandwidth (bytes/s)

    def time_unique(self, nbytes: int) -> float:
        return self.t0_s + nbytes / self.bw_Bps

    def time_blocks(self, nbytes: int, block_bytes: int,
                    buffering: Buffering = Buffering.DOUBLE) -> float:
        n_chunks = max(1, math.ceil(nbytes / block_bytes))
        chunk_t = block_bytes / self.bw_Bps
        if buffering is Buffering.SINGLE:
            return n_chunks * (self.t0_s + chunk_t)
        # double buffer: first chunk pays setup+transfer, the rest pipeline at
        # the max of (setup, transfer) rate, plus the final drain.
        steady = max(self.t0_s, chunk_t)
        return self.t0_s + chunk_t + max(n_chunks - 1, 0) * steady

    def time(self, nbytes: int, policy: TransferPolicy) -> float:
        if policy.partitioning is Partitioning.UNIQUE:
            return self.time_unique(nbytes)
        return self.time_blocks(nbytes, policy.block_bytes, policy.buffering)

    def us_per_byte(self, nbytes: int, policy: TransferPolicy) -> float:
        return self.time(nbytes, policy) * 1e6 / max(nbytes, 1)

    def optimal_block_bytes(self, nbytes: int) -> int:
        """Block size that balances per-chunk overhead against overlap.

        With double buffering, steady-state throughput is limited by
        max(t0, c/BW); the smallest c with c/BW >= t0 (i.e. c = t0*BW) keeps
        the pipe full with minimum buffer memory. The paper's 'longer enough
        packets' criterion is exactly n >> t0*BW."""
        c = int(self.t0_s * self.bw_Bps)
        # clamp to [4KiB, nbytes]
        return max(4096, min(max(c, 4096), max(nbytes, 4096)))

    def preempt_chunk_bytes(self, target_service_s: float = 500e-6) -> int:
        """Segment size for preemptive chunked dispatch.

        A parked latency descriptor waits at most one in-service segment,
        so the segment should move for ~``target_service_s`` on the fitted
        link (``BW * target``). But splitting below ~4 fixed overheads per
        segment burns throughput for latency we cannot realize, so the
        overhead floor ``4 * t0 * BW`` wins when the fit says segments that
        small are not free. Rounded up to a power of two so refitted plans
        with near-identical fits compare equal (no swap flapping on
        noise)."""
        by_latency = int(self.bw_Bps * target_service_s)
        floor = int(4.0 * self.t0_s * self.bw_Bps)
        raw = max(4096, floor, by_latency)
        return 1 << int(raw - 1).bit_length()

    # ---- fitting ----------------------------------------------------------
    @staticmethod
    def fit(nbytes: np.ndarray, seconds: np.ndarray) -> "TransferCostModel":
        """Least-squares fit of t = t0 + n/bw over measured (n, t) samples."""
        return TransferCostModel.fit_weighted(nbytes, seconds, None)

    @staticmethod
    def fit_weighted(nbytes: np.ndarray, seconds: np.ndarray,
                     weights: np.ndarray | None) -> "TransferCostModel":
        """Weighted least-squares fit of t = t0 + n/bw.

        ``weights`` (same length as the samples) biases the fit toward
        recent samples — the online refit passes EWMA-decayed weights so a
        drifting t0/BW shows up within a window instead of being averaged
        away by stale history."""
        nbytes = np.asarray(nbytes, dtype=np.float64)
        seconds = np.asarray(seconds, dtype=np.float64)
        a = np.stack([np.ones_like(nbytes), nbytes], axis=1)
        b = seconds
        if weights is not None:
            w = np.sqrt(np.asarray(weights, dtype=np.float64))
            a = a * w[:, None]
            b = b * w
        coef, *_ = np.linalg.lstsq(a, b, rcond=None)
        t0 = float(max(coef[0], 1e-9))
        inv_bw = float(max(coef[1], 1e-15))
        return TransferCostModel(t0_s=t0, bw_Bps=1.0 / inv_bw)

    @staticmethod
    def drift_ratio(a: "TransferCostModel", b: "TransferCostModel") -> float:
        """Largest factor change between two fits, over t0 and BW (>= 1).

        The online controller replans only when this exceeds its hysteresis
        threshold — the 'did the host actually change' test."""
        rt = max(a.t0_s / max(b.t0_s, 1e-12), b.t0_s / max(a.t0_s, 1e-12))
        rb = max(a.bw_Bps / max(b.bw_Bps, 1e-3),
                 b.bw_Bps / max(a.bw_Bps, 1e-3))
        return max(rt, rb)

    def time_pack(self, total_bytes: int, copy_bw_Bps: float) -> float:
        """Staged-pack cost of one layer set: the host memcpy into the
        staging buffer (``total/copy_BW``) plus one UNIQUE descriptor over
        the packed payload — the hot-path price scatter-gather removes."""
        return total_bytes / max(copy_bw_Bps, 1.0) + self.time_unique(
            total_bytes)

    def time_sg(self, sizes: "list[int] | tuple[int, ...]",
                seg_t0_s: float | None = None) -> float:
        """Scatter-gather cost of the same layer set: ONE ring transaction
        whose descriptor walk visits K segments (``seg_t0`` each — the
        ISSUE_RD/WAIT_CPL loop iteration; defaults to the full ``t0``
        until a live refit shrinks it), zero staging copy."""
        seg_t0 = self.t0_s if seg_t0_s is None else seg_t0_s
        return self.t0_s + len(sizes) * seg_t0 + sum(sizes) / self.bw_Bps

    def amortized(self, batch: float) -> "TransferCostModel":
        """The per-descriptor cost model under batched submission: a group
        of ``batch`` descriptors pays the fixed management overhead ONCE
        (one ring transaction, one completion handoff), so each logical
        descriptor sees ``t0 / batch``; bandwidth is unchanged — the
        paper's management-overhead amortization in model form."""
        return TransferCostModel(self.t0_s / max(float(batch), 1.0),
                                 self.bw_Bps)

    @staticmethod
    def crossover_bytes(a: "TransferCostModel", b: "TransferCostModel") -> float:
        """Payload size where model b becomes faster than model a (UNIQUE).

        Solves t0_a + n/bw_a = t0_b + n/bw_b. Returns inf if b never wins,
        0 if b always wins. This is the paper's 'kernel driver wins for
        longer enough packets' threshold."""
        dt0 = b.t0_s - a.t0_s
        dinv = (1.0 / a.bw_Bps) - (1.0 / b.bw_Bps)
        if dinv <= 0:
            return 0.0 if dt0 < 0 else float("inf")
        return max(dt0 / dinv, 0.0)
