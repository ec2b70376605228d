"""Online transfer adaptation: rolling cost-model refit + safe plan swaps.

The paper's central observation is that delivered PS<->PL throughput is set
by the *software management* of the DMA engine, not by the AXI bus — and
that the right management flips with packet size. The user-level polling
driver has the lowest fixed overhead ``t0`` but blocks the host; the
kernel-level interrupt driver pays a much larger ``t0`` (syscall, context
switch, IRQ dispatch) yet sustains better bandwidth and overlap, so it wins
only for "longer enough packets": the crossover payload solves

    t0_poll + n / BW_poll  =  t0_intr + n / BW_intr.

:class:`~repro_torch.core.channels.ChannelGroup` fits that two-parameter
model ``t(n) = t0 + n/BW`` ONCE, at construction. But ``t0`` and ``BW``
are not constants of the machine: they drift with host load, allocator
state, and thermal/cgroup throttling, so the plan goes stale (NEURAghe and
ZynqNet both re-partition per layer for the same reason). This module
closes the loop:

:class:`RollingFit`
    Bounded window of measured (nbytes, seconds) *chunk* samples with
    EWMA-decayed weighted least squares — recent samples dominate, so a
    step change in t0/BW is visible within a window instead of being
    averaged into history. Fits are kept separately per direction and per
    :class:`~repro_torch.core.transfer.Management` mode, since the paper's whole
    point is that those curves differ.

:class:`OnlineTransferController`
    Consumes per-descriptor chunk samples (every
    :class:`~repro_torch.core.transfer.TransferEngine` records them) plus
    logical :class:`~repro_torch.core.transfer.TransferStats`, refits on a
    cadence, and proposes a new :class:`~repro_torch.core.channels.ChannelPlan`
    only when the fitted t0/BW drifted past a hysteresis ratio — noisy
    samples must not flap the plan. The proposal re-runs
    :func:`~repro_torch.core.channels.plan_channels` (channel count, block_bytes,
    ring_depth) and re-evaluates the polling-vs-interrupt crossover from
    the per-mode fits.

:class:`AdaptiveChannelGroup`
    An engine facade that duck-types :class:`TransferEngine` /
    :class:`ChannelGroup` (``policy`` / ``layouts`` / ``tx`` / ``rx`` /
    ``tx_async`` / ``rx_async`` / ``close`` / ``summary``) and applies
    accepted plans ONLY at safe points: a generation is swapped when no
    transfer issued through the facade is still in flight — the ring is
    drained, no slots are held, so the swap can never orphan a descriptor
    or corrupt a staging buffer. Staging layouts and the staging pool
    persist across generations (a replan must not re-pay the one-time
    layout cost). Uniform traffic (every payload the same size) cannot
    separate t0 from BW, so the facade injects a few tiny probe transfers
    when the window is size-degenerate — the online equivalent of the
    paper's packet-size sweep.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.validated import assert_held, make_lock, make_rlock
from repro_torch.core.channels import (
    ChannelGroup,
    ChannelPlan,
    StagingPool,
    calibrate_transfer,
    plan_channels,
)
from repro_torch.core.cost_model import TransferCostModel
from repro_torch.core.faults import RecoveryConfig
from repro_torch.core.qos import QosSpec, resolve_submit_qos
from repro_torch.core.runtime import PriorityClass, TransferRuntime
from repro_torch.dist.fault import TransferFaultState
from repro_torch.core.transfer import (
    Buffering,
    Partitioning,
    LayoutCache,
    Management,
    SGTicket,
    StagedLayout,
    Ticket,
    TransferEngine,
    TransferPolicy,
    TransferStats,
    _sg_segment_views,
    carve_flat_out,
    choose_sg,
    reassemble_chunks,
    sg_crossover_segments,
)
from repro_torch.device import default_device


@dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the online controller."""

    window: int = 256          # chunk samples kept per (direction, mode)
    min_samples: int = 12      # no refit below this many samples
    refit_every: int = 8       # consider a refit every N logical transfers
    hysteresis: float = 1.5    # replan only past this t0/BW factor drift
    ewma_halflife: float = 32  # sample-age halflife for fit weights
    min_size_spread: float = 4.0  # max/min sample size needed to fit t0+BW
    # wall-clock TTL: samples older than this leave the fit window. When
    # the only small-size samples (probes) expire, the window goes
    # size-degenerate and the facade re-probes — so probe freshness is
    # self-regulating with cadence ~ttl, and a regime change can never be
    # straddled by mixing old-regime smalls with new-regime larges (which
    # fits a spurious slope).
    sample_ttl_s: float = 5.0
    max_channels: int = 4
    completion_workers: int = 2   # per-engine workers in replanned policies
    probe_sizes: tuple = (16 << 10, 128 << 10)  # degenerate-window probes
    # preemptive chunked dispatch: target per-segment service time for the
    # fitted TransferPolicy.preempt_chunk_bytes on every plan (adaptive
    # consumers share the runtime with latency traffic, so mid-chunk yield
    # points are worth their per-dispatch cost here). None disables —
    # plan_channels keeps preemption OFF by default for streaming-only
    # groups. Conservative 1 ms: the fitted overhead floor wins below it.
    preempt_target_s: float | None = 1e-3


class RollingFit:
    """Rolling (nbytes, seconds) window + EWMA-weighted least squares.

    Samples carry a wall-clock stamp and expire after ``ttl_s``: a fit must
    never straddle a regime change by pairing old-regime small transfers
    with new-regime large ones — that fits a steep spurious slope instead
    of the new t0/BW."""

    def __init__(self, window: int = 256, ewma_halflife: float = 32,
                 min_size_spread: float = 4.0, ttl_s: float = 5.0):
        self._lock = make_lock("RollingFit._lock")
        self._samples: "collections.deque[tuple[int, float, float]]" = (
            collections.deque(maxlen=window))  # guarded-by: _lock
        self.ewma_halflife = max(float(ewma_halflife), 1.0)
        self.min_size_spread = min_size_spread
        self.ttl_s = float(ttl_s)

    def add(self, nbytes: int, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        with self._lock:
            self._samples.append((int(nbytes), float(seconds),
                                  time.monotonic()))

    def _fresh(self) -> list[tuple[int, float]]:
        cutoff = time.monotonic() - self.ttl_s
        with self._lock:
            while self._samples and self._samples[0][2] < cutoff:
                self._samples.popleft()
            return [(n, t) for n, t, _ in self._samples]

    def __len__(self) -> int:
        return len(self._fresh())

    @property
    def size_spread(self) -> float:
        ns = [n for n, _ in self._fresh()]
        if not ns:
            return 1.0
        return max(ns) / max(min(ns), 1)

    def fit(self, min_samples: int = 2) -> TransferCostModel | None:
        """Weighted fit of t = t0 + n/BW over the fresh window; ``None``
        when the window is too small or size-degenerate (a single payload
        size cannot separate fixed overhead from per-byte cost — the
        caller should probe)."""
        samples = self._fresh()
        if len(samples) < max(min_samples, 2):
            return None
        ns = np.array([n for n, _ in samples], np.float64)
        ts = np.array([t for _, t in samples], np.float64)
        if ns.max() / max(ns.min(), 1.0) < self.min_size_spread:
            return None
        # newest sample gets weight 1, a sample ``halflife`` entries older
        # gets 1/2 — the drifted regime out-weighs the stale one quickly.
        age = np.arange(len(samples) - 1, -1, -1, dtype=np.float64)
        w = 0.5 ** (age / self.ewma_halflife)
        m = TransferCostModel.fit_weighted(ns, ts, w)
        # a non-positive fitted slope (one stalled small-chunk sample can
        # make small transfers look slower than large ones) gets clamped
        # to an absurd bandwidth by fit_weighted; adopting it would read
        # as enormous fake drift and force a spurious replan. A fitted BW
        # far above anything actually OBSERVED is the same pathology.
        bw_observed = float((ns / ts).max())
        if m.bw_Bps > 50.0 * bw_observed:
            return None
        return m

    # -- warm-start persistence ---------------------------------------------
    def to_state(self) -> dict:
        """Serializable snapshot: samples carry their AGE (monotonic stamps
        don't survive a process), newest last."""
        now = time.monotonic()
        with self._lock:
            return {"samples": [[int(n), float(t), round(now - ts, 6)]
                                for n, t, ts in self._samples]}

    @classmethod
    def from_state(cls, state: dict, *, window: int = 256,
                   ewma_halflife: float = 32, min_size_spread: float = 4.0,
                   ttl_s: float = 5.0, refresh: bool = True) -> "RollingFit":
        """Rebuild a window from :meth:`to_state`. With ``refresh`` (the
        warm-start default) samples are restamped as fresh — the point is
        seeding the NEW session's first fit from the old session's
        steady state, not replaying wall-clock ages that the TTL would
        expire on arrival. Live traffic then out-weighs the seed within a
        halflife."""
        fit = cls(window=window, ewma_halflife=ewma_halflife,
                  min_size_spread=min_size_spread, ttl_s=ttl_s)
        now = time.monotonic()
        for n, t, age in state.get("samples", []):
            stamp = now if refresh else now - float(age)
            fit._samples.append((int(n), float(t), stamp))
        return fit


def choose_management(tx_fits: dict[str, TransferCostModel],
                      payload_bytes: int,
                      current: Management = Management.INTERRUPT,
                      interrupt_extra_t0_s: float = 0.0,
                      batch: float = 1.0
                      ) -> Management:
    """Polling-vs-interrupt crossover from the per-mode TX fits.

    The paper's Fig. 4: the user-level polling driver wins below the
    crossover payload, the kernel interrupt driver above it. With a fit
    for only one mode there is nothing to compare — keep ``current``
    (the mode we're running produces samples, the other mode's window
    empties after its TTL; flipping on missing data would evict a
    measured-good choice for an unmeasured one).

    ``interrupt_extra_t0_s``: queue-wait the interrupt path pays beyond
    its per-descriptor service time — the shared runtime's measured
    per-class dispatch latency under the CURRENT traffic mix. Polling
    never queues, so under contention the crossover moves right (exactly
    the paper's arbitration-overhead term, now measured from real serving
    traces instead of assumed zero).

    ``batch``: observed tx_many/rx_many group size of this stream (EWMA;
    1.0 = singles). A batched group pays the interrupt path's dispatch
    wait ONCE for the whole group, so the per-descriptor extra-t0 is
    amortized by ``batch`` and the crossover moves back LEFT — batching
    makes the interrupt driver win at smaller payloads, the point of
    batched submission. The fitted t0 is NOT divided here: batched chunk
    samples already carry amortized per-descriptor times, and dividing again
    would double-count the saving."""
    poll = tx_fits.get(Management.POLLING.value)
    intr = tx_fits.get(Management.INTERRUPT.value)
    if poll is None or intr is None:
        return current
    if interrupt_extra_t0_s > 0.0:
        extra = interrupt_extra_t0_s / max(float(batch), 1.0)
        intr = TransferCostModel(t0_s=intr.t0_s + extra,
                                 bw_Bps=intr.bw_Bps)
    n_star = TransferCostModel.crossover_bytes(poll, intr)
    return Management.POLLING if payload_bytes < n_star else Management.INTERRUPT


class OnlineTransferController:
    """Refit-and-replan logic, separated from transfer plumbing for tests.

    ``record`` ingests logical transfer stats (payload sizing + cadence);
    ``ingest_chunks`` drains per-descriptor samples from engines into the
    per-(direction, mode) :class:`RollingFit` windows; ``propose`` refits
    and returns a new plan only when drift beats the hysteresis."""

    def __init__(self, payload_bytes: int, *,
                 model: TransferCostModel | None = None,
                 cfg: AdaptiveConfig | None = None,
                 device: "torch.device | str | None" = None):
        self.cfg = cfg or AdaptiveConfig()
        # RLock: propose() holds it end-to-end (plan/counter updates must
        # be atomic across concurrent submitters) and calls _fit_for, which
        # also guards the fits dict for the sample-ingestion paths.
        self._lock = make_rlock("OnlineTransferController._lock")
        if model is None:
            model = calibrate_transfer(device)
        self.plan: ChannelPlan = plan_channels(  # guarded-by: _lock
            payload_bytes, model=model, max_channels=self.cfg.max_channels,
            completion_workers=self.cfg.completion_workers,
            preempt_target_s=self.cfg.preempt_target_s)
        # drift references: the per-direction fits the current plan was
        # adopted under. RX gets its own reference — serving decode is
        # RX-dominated, and TX-only drift detection would never see an
        # RX slowdown (the ring/block policy governs both directions).
        self._tx_ref: TransferCostModel = model  # guarded-by: _lock
        self._rx_ref: TransferCostModel | None = None  # guarded-by: _lock
        self._fits: dict[tuple[str, str], RollingFit] = {}  # guarded-by: _lock
        # guarded-by: _lock
        self._payloads: "collections.deque[int]" = collections.deque(maxlen=32)
        self._payloads.append(max(int(payload_bytes), 1))
        self._since_refit = 0  # guarded-by: _lock
        self._has_logical = False  # guarded-by: _lock (stats own cadence)
        # EWMA of the shared runtime's per-class dispatch latency for this
        # stream — the interrupt driver's measured queue-wait, folded into
        # the crossover decision (see choose_management).
        self._dispatch_t0_s = 0.0  # guarded-by: _lock
        # EWMA of the tx_many/rx_many group size observed on this stream
        # (1.0 = singles): the dispatch queue-wait above is paid once per
        # GROUP, so the crossover amortizes it by this factor.
        self._batch_ewma = 1.0  # guarded-by: _lock
        # enforced bytes/s ceiling on this stream's priority class (the
        # runtime's set_class_cap): plans are sized against the EFFECTIVE
        # (post-cap) bandwidth — a capped stream must not chase block/
        # channel choices tuned for throughput it is not allowed to have.
        # Drift detection still runs on the RAW fits (the link itself did
        # not change when an operator set a cap).
        self._bw_cap_Bps: float | None = None  # guarded-by: _lock
        # healthy-channel ceiling from the self-healing layer: when the
        # channel group quarantines rings, plans must be sized for the
        # channels actually in rotation, not the configured maximum —
        # "replan around the reduced channel set". None = no restriction.
        self._channel_limit: int | None = None  # guarded-by: _lock
        # EWMA of the per-segment descriptor-walk cost under grouped (SG /
        # tx_many) submission, refit from live grouped-transaction samples:
        # the pack-vs-SG crossover prices the SG side with this instead of
        # assuming a full t0 per segment. None until the first SG/batched
        # transaction lands.
        self._sg_seg_t0_s: float | None = None  # guarded-by: _lock
        # the seg-t0 value the last memoized pack-vs-SG decisions were
        # priced with; drifting past the hysteresis signals consumers to
        # drop their per-layer-set memos (LayoutCache.invalidate_sg).
        self._sg_ref_seg_t0_s: float | None = None  # guarded-by: _lock
        self.refits = 0  # guarded-by: _lock
        self.replans = 0  # guarded-by: _lock
        self.suppressed = 0  # guarded-by: _lock (hysteresis kept the plan)
        self.needs_probe = False  # guarded-by: _lock

    def _fit_for(self, direction: str, mode: str) -> RollingFit:
        key = (direction, mode)
        with self._lock:
            fit = self._fits.get(key)
            if fit is None:
                fit = self._fits[key] = RollingFit(
                    self.cfg.window, self.cfg.ewma_halflife,
                    self.cfg.min_size_spread, self.cfg.sample_ttl_s)
            return fit

    # -- sample ingestion ---------------------------------------------------
    def record(self, stats: TransferStats) -> None:
        """Observer hook for logical transfers: tracks the payload mix the
        plan should be sized for, and the refit cadence."""
        with self._lock:
            if stats.direction == "tx":
                self._payloads.append(stats.nbytes)
            self._has_logical = True
            self._since_refit += 1

    def add_chunk_sample(self, direction: str, mode: str, nbytes: int,
                         seconds: float) -> None:
        self._fit_for(direction, mode).add(nbytes, seconds)
        with self._lock:
            # chunk arrivals drive the refit cadence ONLY when no logical
            # stats flow (a controller fed samples directly: tests,
            # replayed traces). With live traffic, counting both would
            # refit nearly every transfer — documented cadence is per
            # logical transfer.
            if not self._has_logical:
                self._since_refit += 1

    def ingest_chunks(self, engines: Sequence[TransferEngine]) -> int:
        """Drain every engine's chunk-sample deque into the fit windows."""
        n = 0
        for eng in engines:
            dq = eng.chunk_samples
            while True:
                try:
                    direction, mode, nbytes, seconds = dq.popleft()
                except IndexError:
                    break
                self.add_chunk_sample(direction, mode, nbytes, seconds)
                n += 1
        return n

    def note_dispatch_latency(self, seconds: float,
                              alpha: float = 0.25) -> None:
        """Fold a measured runtime dispatch latency (queue wait before a
        descriptor starts service) into the interrupt-mode effective t0
        used by the crossover decision. EWMA so serving bursts show up
        quickly and idle periods decay back toward zero."""
        if seconds < 0:
            return
        with self._lock:
            self._dispatch_t0_s = ((1 - alpha) * self._dispatch_t0_s
                                   + alpha * float(seconds))

    def note_submit_batch(self, n: int, alpha: float = 0.25) -> None:
        """Fold an observed tx_many/rx_many group size into the batch EWMA
        the crossover amortizes dispatch latency by. Single submits call
        this with 1 (or not at all — the EWMA decays toward 1 only through
        explicit singles, so a steady batched stream keeps its factor)."""
        if n < 1:
            return
        with self._lock:
            self._batch_ewma = ((1 - alpha) * self._batch_ewma
                                + alpha * float(n))

    # -- pack-vs-SG crossover -----------------------------------------------
    def ingest_sg(self, engines: Sequence[TransferEngine]) -> bool:
        """Drain every engine's grouped-transaction samples and refit the
        per-segment walk cost the pack-vs-SG crossover prices with: each
        ``(k, total, wall)`` sample gives ``seg_t0 ~= (wall - t0 -
        total/BW)/k`` against the current plan's fitted model, folded into
        an EWMA. Returns True when the refit cost drifted past the config
        hysteresis since the last True — callers drop their memoized
        per-layer-set decisions (``LayoutCache.invalidate_sg``) then."""
        with self._lock:
            m = self.plan.model
        for eng in engines:
            dq = getattr(eng, "sg_samples", None)
            if dq is None:
                continue
            while True:
                try:
                    _d, k, total, wall = dq.popleft()
                except IndexError:
                    break
                if k <= 1 or wall <= 0.0:
                    continue
                est = max((wall - m.t0_s - total / m.bw_Bps) / k, 1e-7)
                with self._lock:
                    cur = self._sg_seg_t0_s
                    self._sg_seg_t0_s = (est if cur is None
                                         else 0.75 * cur + 0.25 * est)
        with self._lock:
            cur, ref = self._sg_seg_t0_s, self._sg_ref_seg_t0_s
            if cur is None:
                return False
            if ref is not None and max(cur / ref, ref / cur) \
                    < self.cfg.hysteresis:
                return False
            self._sg_ref_seg_t0_s = cur
            return ref is not None  # first fit: nothing memoized yet

    def sg_seg_t0_s(self) -> float | None:
        """Current refit per-segment walk cost (None before any grouped
        transaction landed — consumers fall back to the full t0)."""
        with self._lock:
            return self._sg_seg_t0_s

    def prefer_sg(self, sizes: Sequence[int]) -> bool:
        """Live pack-vs-SG decision for one layer set: prices
        :func:`~repro_torch.core.transfer.choose_sg` with the plan's fitted
        model and the refit per-segment walk cost."""
        with self._lock:
            m = self.plan.model
            seg = self._sg_seg_t0_s
        return choose_sg(sizes, m, seg_t0_s=seg)

    def sg_crossover(self, total_bytes: int) -> float:
        """Segment count where pack starts beating SG for ``total_bytes``,
        under the current fits (the recorded crossover point)."""
        with self._lock:
            m = self.plan.model
            seg = self._sg_seg_t0_s
        return sg_crossover_segments(total_bytes, m, seg_t0_s=seg)

    def set_bandwidth_cap(self, bytes_per_s: float | None) -> None:
        """Tell the planner this stream's class is capped at ``bytes_per_s``
        (None clears). Subsequent :meth:`propose` calls size plans against
        min(fitted BW, cap)."""
        with self._lock:
            self._bw_cap_Bps = (float(bytes_per_s)
                                if bytes_per_s and bytes_per_s > 0 else None)

    # -- self-healing hooks -------------------------------------------------
    @property
    def _max_channels(self) -> int:
        with self._lock:  # reentrant: also read under replan/propose
            limit = self._channel_limit
        if limit is None:
            return self.cfg.max_channels
        return max(1, min(self.cfg.max_channels, limit))

    def set_channel_limit(self, n: int | None) -> None:
        """Bound future plans to ``n`` channels (None clears). Set by the
        facade when the channel group quarantines/releases rings."""
        with self._lock:
            self._channel_limit = None if n is None else max(1, int(n))

    def replan_channels(self, limit: int | None) -> ChannelPlan | None:
        """Immediate channel-count replan for a quarantine transition: keep
        the current fitted model and policy family, rebuild the plan bounded
        to ``limit`` healthy channels. Unlike :meth:`propose` this does not
        wait for refit cadence or drift — losing a ring to quarantine IS the
        event, no hysteresis applies. Returns the new plan, or None when the
        current plan already fits the bound (e.g. polling's single channel,
        or a limit at/above the planned channel count)."""
        with self._lock:
            self.set_channel_limit(limit)
            if self.plan.policy.management is not Management.INTERRUPT:
                return None
            model = self.plan.model
            if (self._bw_cap_Bps is not None
                    and model.bw_Bps > self._bw_cap_Bps):
                model = TransferCostModel(t0_s=model.t0_s,
                                          bw_Bps=self._bw_cap_Bps)
            plan = plan_channels(  # lock-ok: model= given, calibrate unreachable
                self.payload_bytes, model=model,
                max_channels=self._max_channels,
                completion_workers=self.cfg.completion_workers,
                preempt_target_s=self.cfg.preempt_target_s)
            if (plan.policy == self.plan.policy
                    and plan.n_channels == self.plan.n_channels):
                return None
            self.replans += 1
            self.plan = plan
            return plan

    # -- fitted state -------------------------------------------------------
    def models(self) -> dict[tuple[str, str], TransferCostModel]:
        """Latest per-(direction, mode) fits (only windows that can fit)."""
        with self._lock:
            fits = dict(self._fits)
        out = {}
        for key, fit in fits.items():
            m = fit.fit(self.cfg.min_samples)
            if m is not None:
                out[key] = m
        return out

    @property
    def payload_bytes(self) -> int:
        """Plan for the LARGE payloads in the recent mix: striping decisions
        are about the big transfers, not the token-sized ones between."""
        with self._lock:  # reentrant: propose/replan read it under the lock
            return max(self._payloads) if self._payloads else 1

    # -- the decision -------------------------------------------------------
    def propose(self, *, force: bool = False) -> ChannelPlan | None:
        """Refit; return a replacement plan iff t0/BW drifted past the
        hysteresis threshold (or ``force``). ``None`` means: keep flying.

        Holds the controller lock end-to-end: concurrent submitters must
        not interleave plan/counter updates, or ``self.plan`` could end up
        holding a different fit than the plan actually installed."""
        with self._lock:
            if not force and self._since_refit < self.cfg.refit_every:
                return None
            self._since_refit = 0
            mode = self.plan.policy.management.value
            fit = self._fit_for("tx", mode)
            m = fit.fit(self.cfg.min_samples)
            if m is None:
                # window too small or size-degenerate: facade should probe
                self.needs_probe = len(fit) >= self.cfg.min_samples
                return None
            self.needs_probe = False
            self.refits += 1
            rx_m = self._fit_for("rx", mode).fit(self.cfg.min_samples)
            drift = TransferCostModel.drift_ratio(self._tx_ref, m)
            if rx_m is not None:
                if self._rx_ref is None:
                    self._rx_ref = rx_m  # first RX visibility: baseline it
                else:
                    drift = max(drift, TransferCostModel.drift_ratio(
                        self._rx_ref, rx_m))
            if not force and drift < self.cfg.hysteresis:
                self.suppressed += 1
                return None
            payload = self.payload_bytes
            tx_fits = {md: mm for (d, md), mm in self.models().items()
                       if d == "tx"}
            tx_fits.setdefault(mode, m)
            mgmt = choose_management(
                tx_fits, payload, current=self.plan.policy.management,
                interrupt_extra_t0_s=self._dispatch_t0_s,
                batch=self._batch_ewma)
            if mgmt is Management.POLLING:
                # below the crossover the user-level polling driver wins:
                # one channel, one un-partitioned transfer, no worker pool.
                plan = ChannelPlan(n_channels=1,
                                   policy=TransferPolicy.user_level_polling(),
                                   model=tx_fits.get(mgmt.value, m),
                                   payload_bytes=payload)
            else:
                # size the plan from the fit of the mode it will RUN under
                # (flipping polling->interrupt must not size blocks from
                # polling's tiny t0), folded with the RX fit — the ring
                # serves both directions, so plan for the slower one.
                m_tx = tx_fits.get(Management.INTERRUPT.value, m)
                m_plan = m_tx if rx_m is None else TransferCostModel(
                    t0_s=max(m_tx.t0_s, rx_m.t0_s),
                    bw_Bps=min(m_tx.bw_Bps, rx_m.bw_Bps))
                if (self._bw_cap_Bps is not None
                        and m_plan.bw_Bps > self._bw_cap_Bps):
                    # effective (post-cap) bandwidth: the runtime's token
                    # bucket is the binding constraint, not the link fit —
                    # blocks/channels sized past the ceiling would just
                    # queue behind the bucket.
                    m_plan = TransferCostModel(t0_s=m_plan.t0_s,
                                               bw_Bps=self._bw_cap_Bps)
                plan = plan_channels(  # lock-ok: model= given, calibrate unreachable
                    payload, model=m_plan, max_channels=self._max_channels,
                    completion_workers=self.cfg.completion_workers,
                    preempt_target_s=self.cfg.preempt_target_s)
            # adoption (either outcome below) re-baselines drift detection
            # on the fits that produced this decision.
            self._tx_ref = tx_fits.get(plan.policy.management.value, m)
            if rx_m is not None:
                self._rx_ref = rx_m
            if (plan.policy == self.plan.policy
                    and plan.n_channels == self.plan.n_channels):
                # same physical plan, refreshed model: adopt the fit (so
                # future drift is measured against it) but don't swap
                # generations — rebuilding identical rings buys nothing
                # and perturbs traffic.
                self.plan = plan
                self.suppressed += 1
                return None
            self.replans += 1
            self.plan = plan
            return plan

    # -- warm-start persistence ---------------------------------------------
    _STATE_VERSION = 1

    def save(self, path: "str | os.PathLike") -> None:
        """Persist the fitted state (plan, drift references, per-mode fit
        windows) so the NEXT session seeds its first :class:`ChannelPlan`
        from this session's steady state instead of re-calibrating.
        Atomic write (tmp + rename): a crash mid-save never corrupts the
        warm-start file."""
        with self._lock:
            state = {
                "version": self._STATE_VERSION,
                "payload_bytes": self.payload_bytes,
                "plan": _plan_to_state(self.plan),
                "tx_ref": {"t0_s": self._tx_ref.t0_s,
                           "bw_Bps": self._tx_ref.bw_Bps},
                "rx_ref": (None if self._rx_ref is None else
                           {"t0_s": self._rx_ref.t0_s,
                            "bw_Bps": self._rx_ref.bw_Bps}),
                "fits": {f"{d}:{m}": fit.to_state()
                         for (d, m), fit in self._fits.items()},
            }
        path = pathlib.Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(state, indent=2) + "\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: "str | os.PathLike", *,
             cfg: AdaptiveConfig | None = None,
             device: "torch.device | str | None" = None
             ) -> "OnlineTransferController":
        """Rebuild a controller from :meth:`save` — NO calibration sweep:
        the saved fit is the model, the saved plan is the first plan, and
        the fit windows are re-seeded (restamped fresh) so the first
        ``propose()`` has data to detect drift against."""
        state = json.loads(pathlib.Path(path).read_text())
        if state.get("version") != cls._STATE_VERSION:
            raise ValueError(
                f"warm-start state version {state.get('version')!r} != "
                f"{cls._STATE_VERSION} ({path})")
        cfg = cfg or AdaptiveConfig()
        model = TransferCostModel(**state["tx_ref"])
        ctl = cls(state["payload_bytes"], model=model, cfg=cfg, device=device)
        ctl.plan = _plan_from_state(state["plan"])
        ctl._tx_ref = model
        ctl._rx_ref = (None if state.get("rx_ref") is None else
                       TransferCostModel(**state["rx_ref"]))
        for key, fstate in state.get("fits", {}).items():
            direction, mode = key.split(":", 1)
            ctl._fits[(direction, mode)] = RollingFit.from_state(
                fstate, window=cfg.window, ewma_halflife=cfg.ewma_halflife,
                min_size_spread=cfg.min_size_spread, ttl_s=cfg.sample_ttl_s)
        return ctl


def _plan_to_state(plan: ChannelPlan) -> dict:
    p = plan.policy
    return {
        "n_channels": plan.n_channels,
        "payload_bytes": plan.payload_bytes,
        "model": {"t0_s": plan.model.t0_s, "bw_Bps": plan.model.bw_Bps},
        "policy": {
            "management": p.management.value,
            "buffering": p.buffering.value,
            "partitioning": p.partitioning.value,
            "block_bytes": p.block_bytes,
            "ring_depth": p.ring_depth,
            "completion_workers": p.completion_workers,
            "preempt_chunk_bytes": p.preempt_chunk_bytes,
        },
    }


def _plan_from_state(state: dict) -> ChannelPlan:
    ps = state["policy"]
    policy = TransferPolicy(
        management=Management(ps["management"]),
        buffering=Buffering(ps["buffering"]),
        partitioning=Partitioning(ps["partitioning"]),
        block_bytes=int(ps["block_bytes"]),
        ring_depth=int(ps["ring_depth"]),
        completion_workers=int(ps["completion_workers"]),
        # absent in pre-cap/preemption state files: those plans ran with
        # whole-chunk dispatch, keep that on warm start.
        preempt_chunk_bytes=int(ps.get("preempt_chunk_bytes", 0)),
    )
    return ChannelPlan(n_channels=int(state["n_channels"]), policy=policy,
                       model=TransferCostModel(**state["model"]),
                       payload_bytes=int(state["payload_bytes"]))


class AdaptiveChannelGroup:
    """Self-tuning transfer engine: a :class:`ChannelGroup` (or, below the
    polling crossover, a bare :class:`TransferEngine`) per plan generation,
    swapped at safe points as the online controller replans.

    Duck-types the engine surface the executors use. Safe-point rule: a new
    generation is installed only when every ticket issued through this
    facade has completed — ring drained, no slots in flight — and the swap
    happens on the *submitting* thread, never on a completion worker (a
    worker closing its own pool would self-deadlock). The layout cache and
    staging pool are facade-owned and survive swaps.

    ``devices``: the one device every generation's channels target (every
    entry the same device, as ``ChannelGroup`` asks, or it raises; ``None``:
    the current CUDA card, raising when there is none) — the facade's
    ``device``. A retired generation's engines close
    with their copy streams at the swap."""

    def __init__(self, payload_bytes: int, *,
                 cfg: AdaptiveConfig | None = None,
                 model: TransferCostModel | None = None,
                 devices: "Sequence[torch.device | str] | None" = None,
                 pool: StagingPool | None = None,
                 engine_factory: Callable[..., TransferEngine] | None = None,
                 runtime: TransferRuntime | None = None,
                 priority: PriorityClass = PriorityClass.LAYER,
                 state_path: "str | os.PathLike | None" = None,
                 recovery: RecoveryConfig | None = None,
                 fault_state: TransferFaultState | None = None,
                 qos: QosSpec | None = None):
        self.cfg = cfg or AdaptiveConfig()
        if devices and len({torch.device(d) for d in devices}) != 1:
            raise ValueError(
                f"an AdaptiveChannelGroup's channels share one device; got "
                f"{list(devices)}")
        self.device = default_device(devices[0] if devices else None)
        self._factory = engine_factory
        self._runtime = runtime
        self.qos = QosSpec(priority=priority).merged(qos)
        self.priority = self.qos.priority
        self.state_path = state_path
        # ONE fault ledger across every plan generation: counters must
        # survive safe-point swaps, or a replan would erase the very
        # fault history that triggered it.
        self.recovery = recovery or RecoveryConfig()
        self.fault_state = fault_state or TransferFaultState()
        self.staging_pool = pool or StagingPool(
            pin_memory=self.device.type == "cuda")
        self.layouts = LayoutCache(pool=self.staging_pool)
        # warm start: a previous session's steady-state fit seeds the first
        # plan (no calibration sweep); otherwise calibrate as before. The
        # state file is a CACHE: corrupt, version-mismatched, or sized for
        # a very different payload -> fall back to a cold start, never
        # fail construction over it.
        self.controller = None
        self.warm_started = False
        if (state_path is not None and model is None
                and os.path.exists(state_path)):
            try:
                ctl = OnlineTransferController.load(
                    state_path, cfg=self.cfg, device=self.device)
                saved = ctl.payload_bytes
                if not (payload_bytes / 4 <= saved <= payload_bytes * 4):
                    raise ValueError(
                        f"saved plan sized for {saved} bytes, caller asked "
                        f"for {payload_bytes} — too far apart to reuse")
                # the new session's payload joins the mix the planner sees
                ctl._payloads.append(max(int(payload_bytes), 1))
                self.controller = ctl
                self.warm_started = True
            except Exception:  # noqa: BLE001 — stale cache, cold-start
                self.controller = None
        if self.controller is None:
            self.controller = OnlineTransferController(
                payload_bytes, model=model, cfg=self.cfg, device=self.device)
        # bounded: one record lands here per logical transfer (per decoded
        # token in serving) — an unbounded list would grow forever in a
        # long-running server and defeat the zero-alloc steady state.
        self._lock = make_lock("AdaptiveChannelGroup._lock")
        self.stats: "collections.deque[TransferStats]" = collections.deque(
            maxlen=4096)  # guarded-by: _lock
        self._outstanding: list[Ticket] = []  # guarded-by: _lock
        # submitters currently between _enter() and their ticket being
        # tracked (or their sync transfer finishing): the swap must also
        # wait these out, or it could close an engine under a submit.
        self._entrants = 0  # guarded-by: _lock
        self._pending_plan: ChannelPlan | None = None  # guarded-by: _lock
        self.generation = 0  # guarded-by: _lock
        self.swaps = 0  # guarded-by: _lock
        self.all_engines: list[TransferEngine] = []  # every generation's
        self._group = self._build(self.controller.plan)

    # -- generation lifecycle ------------------------------------------------
    def _build(self, plan: ChannelPlan):
        if plan.policy.management is Management.INTERRUPT:
            g = ChannelGroup(plan.policy, n_channels=plan.n_channels,
                             devices=[self.device] * plan.n_channels,
                             pool=self.staging_pool,
                             plan=plan, engine_factory=self._factory,
                             layouts=self.layouts, runtime=self._runtime,
                             priority=self.priority,
                             recovery=self.recovery,
                             fault_state=self.fault_state,
                             qos=self.qos)
            engines = list(g.engines)
        else:
            factory = self._factory or TransferEngine
            g = factory(plan.policy, device=self.device,
                        runtime=self._runtime, priority=self.priority)
            engines = [g]
        self.all_engines.extend(engines)
        # keep only the most recent generations' engines (diagnostics /
        # invariant checks); retired engines pinned forever would leak
        # their stats lists across many swaps.
        del self.all_engines[:-32]
        g.add_observer(self._on_stats)
        return g

    def _on_stats(self, stats: TransferStats) -> None:
        with self._lock:
            self.stats.append(stats)
        self.controller.record(stats)

    @property
    def plan(self) -> ChannelPlan:
        return self.controller.plan

    @property
    def policy(self) -> TransferPolicy:
        return self._group.policy

    @property
    def n_channels(self) -> int:
        return getattr(self._group, "n_channels", 1)

    @property
    def engines(self) -> list[TransferEngine]:
        return getattr(self._group, "engines", [self._group])

    def close(self) -> None:
        """Idempotent; persists the fitted state first when ``state_path``
        was given (the next session warm-starts from it)."""
        if getattr(self, "_facade_closed", False):
            return
        self._facade_closed = True
        try:
            if self.state_path is not None:
                try:
                    self.save_state(self.state_path)
                except Exception:  # noqa: BLE001 — persistence is
                    pass           # best-effort; teardown must not fail
        finally:
            self._group.close()  # engines MUST deregister even if save blew

    def save_state(self, path: "str | os.PathLike | None" = None) -> None:
        """Persist the controller's fitted state for warm-starting."""
        target = path if path is not None else self.state_path
        if target is None:
            raise ValueError("no state path given")
        self.controller.save(target)

    def __enter__(self) -> "AdaptiveChannelGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- adaptation ----------------------------------------------------------
    def _drained(self) -> bool:  # requires-lock: _lock
        """True when nothing issued through the facade is still in flight
        (no live ticket, no submitter mid-issue). Caller must hold the
        lock."""
        assert_held(self._lock, "_drained")
        self._outstanding = [t for t in self._outstanding if not t.complete]
        return not self._outstanding and self._entrants == 0

    def _swap_locked(self) -> None:  # requires-lock: _lock
        """Install the pending generation. Caller holds the lock and has
        verified the drain; runs on a submitting thread only."""
        assert_held(self._lock, "_swap_locked")
        plan, self._pending_plan = self._pending_plan, None
        old = self._group
        self._group = self._build(plan)
        self.generation += 1
        self.swaps += 1
        # a new generation means a new cost world (mode/chunking changed):
        # memoized pack-vs-SG decisions were priced against the old plan.
        self.layouts.invalidate_sg()
        # old generation is fully drained, so close() drain-deregisters
        # immediately; the retired engines permanently reject submits
        # (nothing holds them — the facade now routes to the new build).
        old.close()

    @property
    def runtime(self) -> TransferRuntime | None:
        """The shared runtime the current generation dispatches on."""
        if self._runtime is not None:
            return self._runtime
        return getattr(self._group, "runtime", None)

    def _ingest_dispatch_latency(self) -> None:
        """Feed the runtime's per-class signals into the controller: the
        dispatch latency (the queue wait this stream's completions pay
        under the current traffic mix) shifts the polling/interrupt
        crossover — real serving traces, not an assumed-zero arbitration
        cost; the enforced class cap bounds the bandwidth plans are sized
        for. No recent latency samples means the contention is over:
        decay toward zero instead of holding the burst-era value forever
        (a stale inflated t0 would pin the plan at POLLING long after
        the queue emptied)."""
        rt = self.runtime
        if rt is None:
            return
        lat = rt.recent_dispatch_latency(self.priority)
        self.controller.note_dispatch_latency(lat if lat is not None else 0.0)
        self.controller.set_bandwidth_cap(rt.class_cap(self.priority))

    def set_class_cap(self, cls: "PriorityClass",
                      bytes_per_s: float | None) -> None:
        """Cap one class on the shared runtime. A cap on THIS stream's own
        class also informs the online planner immediately (plans size for
        the effective, post-cap bandwidth)."""
        rt = self.runtime
        if rt is None:
            raise RuntimeError("AdaptiveChannelGroup has no runtime to cap")
        rt.set_class_cap(cls, bytes_per_s)
        if cls is self.priority:
            self.controller.set_bandwidth_cap(bytes_per_s)

    def _ingest_chunks(self) -> None:
        """Drain engine chunk samples into the controller's fit windows —
        but let the group's health tracker PEEK them first (it reads
        non-destructively via ``chunk_seq``; the controller's drain pops).
        Every facade-side drain must go through here, or quarantine drift
        detection would starve."""
        peek = getattr(self._group, "_ingest_health_samples", None)
        if peek is not None:
            # the health windows are guarded by the group's _health_lock
            # (check_channel_health ingests under it too); try-acquire so a
            # concurrent health pass — already ingesting — just wins.
            health_lock = self._group._health_lock
            if health_lock.acquire(blocking=False):
                try:
                    peek()
                finally:
                    health_lock.release()
        self.controller.ingest_chunks(self.engines)
        if self.controller.ingest_sg(self.engines):
            # the per-segment walk cost drifted past hysteresis: memoized
            # per-layer-set pack-vs-SG decisions are stale — re-price.
            self.layouts.invalidate_sg()

    def _check_group_health(self) -> bool:
        """Run the current generation's quarantine/probe health pass; when
        the set of healthy channels changed, replan immediately around the
        reduced (or restored) channel set — losing a ring to quarantine is
        an event, not drift, so no hysteresis applies. Returns True when
        quarantine state changed."""
        g = self._group
        check = getattr(g, "check_channel_health", None)
        if check is None:
            return False  # polling generation: single bare engine
        changed = check()
        if changed:
            n_active = len(g._active_indices())
            plan = self.controller.replan_channels(n_active)
            if plan is not None:
                with self._lock:
                    self._pending_plan = plan
        return changed

    def maybe_adapt(self, *, force: bool = False) -> bool:
        """Refit from the live samples and swap plans if drift warrants it.

        Called from executors at their natural safe points (end of frame /
        batch boundary) — and implicitly before every submit. Health
        (quarantine/probe) runs first: a quarantine transition replans
        around the healthy channel set immediately, ahead of any drift
        decision. Returns True when a new generation was installed."""
        self._ingest_chunks()
        self._ingest_dispatch_latency()
        self._check_group_health()
        with self._lock:
            pending = self._pending_plan is not None
        if not pending:
            plan = self.controller.propose(force=force)
            if plan is not None:
                with self._lock:
                    self._pending_plan = plan
            elif self.controller.needs_probe:
                self._probe()
        with self._lock:
            if self._pending_plan is not None and self._drained():
                self._swap_locked()
                return True
        return False

    def _probe(self) -> None:
        """Uniform traffic can't separate t0 from BW: issue a couple of tiny
        transfers (the paper's packet-size sweep, online and cheap) so the
        window regains size diversity."""
        for nbytes in self.cfg.probe_sizes:
            x = np.zeros(nbytes, np.uint8)
            self._issue_tx(x, None, None).wait()
        self._ingest_chunks()

    # -- engine surface ------------------------------------------------------
    def _resolve_qos(self, where: str, qos: QosSpec | None,
                     priority: PriorityClass | None) -> QosSpec:
        """One facade call's effective submit context (see
        :meth:`TransferEngine._resolve_qos` — same shim, facade default)."""
        spec = resolve_submit_qos(f"{type(self).__name__}.{where}",
                                  qos, priority)
        return self.qos.merged(spec)

    def _enter(self):
        """Per-submit safe-point check: apply a pending swap if the ring is
        drained, then return the engine of the current generation. The
        caller holds an entrant reference until its ticket is tracked (or
        its sync transfer finished) — see :meth:`_leave`."""
        with self._lock:
            pending = self._pending_plan is not None
        if not pending:
            self._ingest_chunks()
            plan = self.controller.propose()
            if plan is not None:
                with self._lock:
                    self._pending_plan = plan
        with self._lock:
            if self._pending_plan is not None and self._drained():
                self._swap_locked()
            self._entrants += 1
            return self._group

    def _leave(self, ticket: Ticket | None) -> None:
        with self._lock:
            self._entrants -= 1
            self._outstanding = [t for t in self._outstanding
                                 if not t.complete]
            if ticket is not None:
                self._outstanding.append(ticket)

    def _leave_many(self, tickets: "Sequence[Ticket] | None") -> None:
        # batched variant of _leave: every per-descriptor ticket of the
        # group pins the current generation until it resolves (a swap must
        # never rebuild rings under an in-flight batch).
        with self._lock:
            self._entrants -= 1
            self._outstanding = [t for t in self._outstanding
                                 if not t.complete]
            if tickets:
                self._outstanding.extend(t for t in tickets
                                         if t is not None)

    @staticmethod
    def _done_ticket(result: list) -> Ticket:
        ev = threading.Event()
        ev.set()
        return Ticket(ev, [result])

    def _issue_tx(self, arr: np.ndarray,
                  callback: Callable[[list], None] | None,
                  layout: StagedLayout | None,
                  qos: QosSpec | None = None) -> Ticket:
        eng = self._enter()
        ticket = None
        try:
            if eng.policy.management is Management.INTERRUPT:
                ticket = eng.tx_async(arr, callback=callback, layout=layout,
                                      qos=qos)
                return ticket
            # polling generation: the submit IS the transfer (the paper's
            # user-level driver blocks the host); hand back a done ticket.
            chunks = eng.tx(np.asarray(arr))
            if callback is not None:
                callback(chunks)
            return self._done_ticket(chunks)
        finally:
            self._leave(ticket)

    def tx_async(self, host_array: np.ndarray,
                 callback: Callable[[list], None] | None = None,
                 layout: StagedLayout | None = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None) -> Ticket:
        spec = self._resolve_qos("tx_async", qos, priority)
        return self._issue_tx(host_array, callback, layout, qos=spec)

    def tx(self, host_array: np.ndarray,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None) -> list[torch.Tensor]:
        spec = self._resolve_qos("tx", qos, priority)
        return self.tx_async(host_array, qos=spec).wait()

    def rx_async(self, device_arrays: Sequence[torch.Tensor],
                 callback: Callable[[list], None] | None = None,
                 out: "np.ndarray | Sequence[np.ndarray] | None" = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None
                 ) -> Ticket:
        spec = self._resolve_qos("rx_async", qos, priority)
        eng = self._enter()
        ticket = None
        try:
            if eng.policy.management is Management.INTERRUPT:
                ticket = eng.rx_async(device_arrays, callback=callback,
                                      out=out, qos=spec)
                return ticket
            arrays = list(device_arrays)
            if out is not None and isinstance(out, np.ndarray):
                # bare engines take per-array buffers; carve the flat array
                out = carve_flat_out(out, arrays)
            results = eng.rx(arrays, out=out)
            if callback is not None:
                callback(results)
            return self._done_ticket(results)
        finally:
            self._leave(ticket)

    def rx(self, device_arrays: Sequence[torch.Tensor],
           out: "np.ndarray | Sequence[np.ndarray] | None" = None,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None
           ) -> list[np.ndarray]:
        spec = self._resolve_qos("rx", qos, priority)
        return self.rx_async(device_arrays, out=out, qos=spec).wait()

    # -- batched descriptor submission ---------------------------------------
    def tx_many(self, host_arrays: "Sequence[np.ndarray]",
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched TX through the current generation; the observed group
        size feeds the controller's batch EWMA so the polling/interrupt
        crossover prices batched dispatch correctly. On a polling
        generation each submit IS the transfer (done tickets)."""
        spec = self._resolve_qos("tx_many", qos, priority)
        grp = self._enter()
        tickets = None
        try:
            if grp.policy.management is Management.INTERRUPT:
                tickets = grp.tx_many(host_arrays, qos=spec)
                self.controller.note_submit_batch(len(tickets))
                return tickets
            done = []
            for a in host_arrays:
                chunks = grp.tx(np.asarray(a))
                done.append(self._done_ticket(
                    chunks[0] if len(chunks) == 1 else chunks))
            return done
        finally:
            self._leave_many(tickets)

    def rx_many(self, device_arrays: Sequence[torch.Tensor],
                out: "np.ndarray | Sequence[np.ndarray] | None" = None,
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched RX through the current generation (see :meth:`tx_many`);
        ``out`` keeps the flat-carve / per-array zero-copy contract."""
        spec = self._resolve_qos("rx_many", qos, priority)
        grp = self._enter()
        tickets = None
        try:
            if grp.policy.management is Management.INTERRUPT:
                tickets = grp.rx_many(device_arrays, out=out, qos=spec)
                self.controller.note_submit_batch(len(tickets))
                return tickets
            arrays = list(device_arrays)
            if out is not None and isinstance(out, np.ndarray):
                out = carve_flat_out(out, arrays)
            results = grp.rx(arrays, out=out)
            return [self._done_ticket(r) for r in results]
        finally:
            self._leave_many(tickets)

    # -- scatter-gather ------------------------------------------------------
    def prefer_sg(self, sizes: "Sequence[int]") -> bool:
        """Pack-vs-SG decision priced against the CURRENT fitted plan plus
        the live per-segment walk estimate (see the controller)."""
        return self.controller.prefer_sg(list(sizes))

    def tx_sg(self, segments: Sequence,
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather TX through the current generation: one logical
        transfer over the segment list, zero staging copy. On a polling
        generation each segment IS transferred inline (done tickets)."""
        spec = self._resolve_qos("tx_sg", qos, priority)
        grp = self._enter()
        sg = None
        try:
            if (grp.policy.management is Management.INTERRUPT
                    and hasattr(grp, "tx_sg")):
                sg = grp.tx_sg(segments, qos=spec)
                self.controller.note_submit_batch(len(sg))
                return sg
            views, _sizes = _sg_segment_views(segments, "tx")
            done = []
            for v in views:
                chunks = grp.tx(v)
                flat = reassemble_chunks(chunks)
                done.append(self._done_ticket(flat.reshape(v.shape)))
            return SGTicket(done)
        finally:
            self._leave_many(sg.tickets if sg is not None else None)

    def rx_sg(self, segments: Sequence,
              out: "np.ndarray | Sequence[np.ndarray] | None" = None,
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather RX (see :meth:`tx_sg`); ``out`` keeps the
        flat-carve / per-segment zero-copy contract."""
        spec = self._resolve_qos("rx_sg", qos, priority)
        grp = self._enter()
        sg = None
        try:
            if (grp.policy.management is Management.INTERRUPT
                    and hasattr(grp, "rx_sg")):
                sg = grp.rx_sg(segments, out=out, qos=spec)
                self.controller.note_submit_batch(len(sg))
                return sg
            views, _sizes = _sg_segment_views(segments, "rx")
            outs = out
            if out is not None and isinstance(out, np.ndarray):
                outs = carve_flat_out(out, views)
            results = grp.rx(views, out=outs)
            return SGTicket([self._done_ticket(r) for r in results])
        finally:
            self._leave_many(sg.tickets if sg is not None else None)

    # -- reporting -----------------------------------------------------------
    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            stats = list(self.stats)
        tx = [s for s in stats if s.direction == "tx"]
        rx = [s for s in stats if s.direction == "rx"]

        def agg(ss):
            if not ss:
                return {"us_per_byte": float("nan"), "gbps": float("nan")}
            tot_b = sum(s.nbytes for s in ss)
            tot_t = sum(s.wall_s for s in ss)
            return {"us_per_byte": tot_t * 1e6 / max(tot_b, 1),
                    "gbps": tot_b / max(tot_t, 1e-12) / 1e9}

        return {"tx": agg(tx), "rx": agg(rx)}

    def adapt_summary(self) -> dict[str, Any]:
        """Controller state for benchmarks/ROADMAP reporting."""
        c = self.controller
        with self._lock:
            generation, swaps = self.generation, self.swaps
        with c._lock:
            return {
                "generation": generation,
                "swaps": swaps,
                "refits": c.refits,
                "replans": c.replans,
                "suppressed": c.suppressed,
                "plan": c.plan.row(),
                "channel_limit": c._channel_limit,
            }

    def fault_summary(self) -> dict[str, Any]:
        """The shared fault ledger plus the CURRENT generation's quarantine
        set (the ledger spans generations; the set is per-group)."""
        return {
            "faults": self.fault_state.summary(),
            "quarantined": sorted(getattr(self._group, "quarantined", ())),
        }
