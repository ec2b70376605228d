"""Multi-channel transfer rings + cost-model-adaptive policy selection.

The paper's single AXI-DMA engine tops out well below the bus limit; NEURAghe
and ZynqNet both reach peak PS<->PL throughput only by spreading one logical
stream across *multiple* DMA channels and sizing blocks to the measured
fixed-overhead/per-byte crossover. This module is that lesson at host<->device
scale:

:class:`ChannelGroup`
    Shards one logical TX/RX across N :class:`~repro_torch.core.transfer.
    TransferEngine` descriptor rings ("channels"). TX stripes the flat
    payload into N contiguous byte ranges (bytes-balanced, zero-copy views)
    and issues them concurrently, one ring per channel; RX spreads device
    tensors over the channels greedily by byte load. Chunk order is
    preserved (stripes are contiguous and concatenated in channel order), so
    :func:`~repro_torch.core.transfer.reassemble_chunks` and
    :meth:`~repro_torch.core.transfer.StagedLayout.unpack` work unchanged — a
    ChannelGroup duck-types a TransferEngine everywhere the executors care
    (``device`` / ``policy`` / ``layouts`` / ``tx`` / ``rx`` / ``tx_async``
    / ``rx_async`` / ``close`` / ``summary``). Every channel targets ONE
    device — stripes must share a device to be concatenated back into one
    tensor — so on a CUDA card the channels are N member engines, each with
    its own host->device and device->host copy stream; whether N streams
    move more bytes than one is the card's to say (the link and its copy
    engines are shared).

:class:`StagingPool`
    Size-classed free list of staging buffers shared by every channel's
    :class:`~repro_torch.core.transfer.LayoutCache`, so striped
    :class:`~repro_torch.core.transfer.StagedLayout` slots recycle
    allocations on shape changes instead of reallocating per frame. On a
    CUDA group the buffers are page-locked, so a copy out of them is a true
    asynchronous DMA.

:func:`calibrate_transfer` / :func:`plan_channels`
    The adaptive policy chooser: a short TX sweep at construction fits the
    paper's two-parameter model ``t(n) = t0 + n/BW``
    (:class:`~repro_torch.core.cost_model.TransferCostModel`), and the plan
    derives ``block_bytes`` (the t0*BW crossover), ``ring_depth`` (enough
    slots to cover the stripe) and the channel count (stripe only while each
    stripe still amortizes its fixed overhead) instead of static policy
    constants. :meth:`ChannelGroup.auto` wires the whole thing together.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.validated import assert_held, make_lock
from repro_torch.core.cost_model import TransferCostModel
from repro_torch.core.faults import RecoveryConfig
from repro_torch.core.qos import QosSpec, resolve_submit_qos
from repro_torch.core.runtime import (
    PriorityClass,
    TransferChecksumError,
    TransferFaultError,
    TransferRuntime,
    TransferTimeoutError,
)
from repro_torch.core.transfer import (
    Buffering,
    LayoutCache,
    Management,
    Partitioning,
    SGTicket,
    StagedLayout,
    Ticket,
    TransferEngine,
    TransferPolicy,
    TransferStats,
    _STATS_WINDOW,
    _check_out,
    _nbytes,
    _sg_segment_views,
    carve_flat_out,
)
from repro_torch.device import default_device
from repro_torch.dist.fault import TransferFaultState


class _IndexTicket(Ticket):
    """Per-segment view over one striped scatter-gather join: all segments
    share the joiner's master event/result, each ticket projecting out its
    own ordered slot. A post-retry join failure surfaces on every segment
    (the group already retried the faulted share on siblings)."""

    def __init__(self, done: threading.Event, out: list, index: int):
        super().__init__(done, out)
        self._index = index

    def wait(self, timeout: float | None = None) -> Any:
        return super().wait(timeout)[self._index]

_MIN_STRIPE_BYTES = 1 << 20  # below this a second channel costs more than t0
_CAL_SIZES = (16 << 10, 128 << 10, 1 << 20, 8 << 20)
_OVERHEAD_AMORT = 8.0  # a stripe must be worth >= this many t0's of wire time


# ---------------------------------------------------------------------------
# Shared staging-buffer pool
# ---------------------------------------------------------------------------

class StagingPool:
    """Size-classed (power-of-two) free list of reusable staging buffers.

    Shared across the layout caches of a :class:`ChannelGroup` so a layout
    eviction (shape change between frames) returns its buffer for the next
    layout of a similar size instead of hitting the allocator.

    ``pin_memory``: hand out page-locked buffers (a CUDA group's pool). A
    layout that has a pool takes its staging from it, and a ``non_blocking``
    host->device copy out of pageable memory is synchronous, so on the card
    the pool must pin. Each buffer is the numpy view of a pinned uint8
    tensor, which the view keeps alive. Pinning costs milliseconds a
    buffer, which is why the pool recycles."""

    def __init__(self, *, pin_memory: bool = False) -> None:
        self._lock = make_lock("StagingPool._lock")
        self._free: dict[int, list[np.ndarray]] = {}  # guarded-by: _lock
        self.allocations = 0                          # guarded-by: _lock
        self.reuses = 0                               # guarded-by: _lock
        self.pin_memory = pin_memory

    @staticmethod
    def _size_class(nbytes: int) -> int:
        return 1 << max(12, int(nbytes - 1).bit_length())

    def acquire(self, nbytes: int) -> np.ndarray:
        sc = self._size_class(max(nbytes, 1))
        with self._lock:
            lst = self._free.get(sc)
            if lst:
                self.reuses += 1
                return lst.pop()
            self.allocations += 1
        if self.pin_memory:
            return torch.empty(sc, dtype=torch.uint8, pin_memory=True).numpy()
        return np.empty(sc, np.uint8)

    def release(self, buf: np.ndarray) -> None:
        with self._lock:
            self._free.setdefault(buf.nbytes, []).append(buf)


# ---------------------------------------------------------------------------
# Adaptive policy chooser
# ---------------------------------------------------------------------------

def calibration_samples(device: "torch.device | str | None" = None,
                        sizes: Sequence[int] = _CAL_SIZES,
                        repeats: int = 3
                        ) -> list[tuple[int, float, float | None]]:
    """The calibration sweep's measurements: for each payload size, the
    best of ``repeats`` host-felt seconds of one TX (``perf_counter``
    around issuing the copy and waiting for it) and, on a card, the best
    CUDA-event seconds of the same copy (the DMA alone; ``None`` on the
    host). ``(nbytes, host_s, event_s)`` per size.

    On a card each payload is a pinned host buffer copied into a device
    tensor on a dedicated copy stream, ended by the copy's event — what a
    transfer engine's TX does. ``device="cpu"`` times a host copy.
    ``device=None`` is the current card, and raises without one."""
    device = default_device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    out = []
    for nbytes in sizes:
        src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
        best = best_ev = float("inf")
        for _ in range(max(1, repeats)):
            if not cuda:
                t0 = time.perf_counter()
                dst.copy_(src)
                best = min(best, time.perf_counter() - t0)
                continue
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                start.record()
                dst.copy_(src, non_blocking=True)
                done.record()
            done.synchronize()
            best = min(best, time.perf_counter() - t0)
            best_ev = min(best_ev, start.elapsed_time(done) * 1e-3)
        out.append((int(nbytes), best, best_ev if cuda else None))
    return out


def calibrate_transfer(device: "torch.device | str | None" = None,
                       sizes: Sequence[int] = _CAL_SIZES,
                       repeats: int = 3) -> TransferCostModel:
    """Short calibration sweep: measure TX at a few payload sizes and fit
    ``t(n) = t0 + n/BW``. Runs once at group construction (~tens of ms).

    ``t0`` is the host-felt per-descriptor cost — issuing the copy and
    waiting for its completion, timed by the host clock — since that is
    what a transfer engine's caller pays; the CUDA events of the same copies
    (:func:`calibration_samples`) leave it out.

    Under load the samples can come back non-monotonic and the least-squares
    slope degenerates (bw blows past any physical link). When that happens,
    fall back to the two-point estimate: bandwidth from the largest sample
    (t0 folded in, so it *under*-estimates — safe for planning) and overhead
    from the smallest."""
    samples = calibration_samples(device, sizes, repeats)
    ns = [n for n, _, _ in samples]
    ts = [t for _, t, _ in samples]
    model = TransferCostModel.fit(np.asarray(ns, np.float64),
                                  np.asarray(ts, np.float64))
    bw_direct = ns[-1] / max(ts[-1], 1e-9)
    if model.bw_Bps > 10.0 * bw_direct or model.t0_s >= 0.5 * ts[-1]:
        t0_direct = max(ts[0] - ns[0] / bw_direct, 1e-7)
        model = TransferCostModel(t0_s=t0_direct, bw_Bps=bw_direct)
    return model


@dataclass(frozen=True)
class ChannelPlan:
    """Fitted policy point: what the cost model chose and why."""

    n_channels: int
    policy: TransferPolicy
    model: TransferCostModel
    payload_bytes: int

    @property
    def tag(self) -> str:
        return f"adaptive-{self.n_channels}ch-{self.policy.tag}"

    def row(self) -> dict:
        """BENCH-friendly summary of the fitted choice."""
        return {
            "n_channels": self.n_channels,
            "block_bytes": self.policy.block_bytes,
            "ring_depth": self.policy.depth,
            "partitioning": self.policy.partitioning.value,
            "preempt_chunk_bytes": self.policy.preempt_chunk_bytes,
            "fit_t0_us": round(self.model.t0_s * 1e6, 3),
            "fit_gbps": round(self.model.bw_Bps / 1e9, 3),
            "payload_bytes": self.payload_bytes,
        }


def plan_channels(payload_bytes: int, *,
                  model: TransferCostModel | None = None,
                  device: "torch.device | str | None" = None,
                  max_channels: int = 4,
                  min_stripe_bytes: int = _MIN_STRIPE_BYTES,
                  completion_workers: int = 2,
                  preempt_target_s: float | None = None) -> ChannelPlan:
    """Pick channel count / ring depth / block size from the fitted model.

    - channel count: stripe as wide as ``max_channels`` allows while (a)
      the host has a copy engine (core) per channel — channels beyond that
      just thrash the scheduler, the NEURAghe rule of one stream per HP
      port — and (b) each stripe's wire time still amortizes the fixed
      overhead (``stripe/BW >= _OVERHEAD_AMORT * t0``) and stays >= the
      minimum stripe;
    - block size: at least the ``t0*BW`` crossover (the paper's 'longer
      enough packets' criterion), and large enough that a stripe splits
      into only ~2x``completion_workers`` chunks — enough chunks to
      double-buffer every worker, few enough to amortize per-chunk setup;
    - ring depth: enough slots to cover the stripe's chunk count, clamped
      to [2, 8] (depth 1 forfeits overlap; past ~8 slots buy nothing but
      staging memory);
    - preemptive chunking: with ``preempt_target_s`` set, chunks carry a
      fitted segment size so the shared runtime can yield mid-chunk to
      latency traffic within roughly that service bound. Default OFF:
      every extra segment pays a real per-dispatch cost, which a
      streaming-only workload (no latency classes sharing the runtime)
      would pay for nothing — mixed-traffic consumers (AdaptiveConfig /
      serving) opt in.
    """
    if model is None:
        model = calibrate_transfer(device)
    payload_bytes = max(int(payload_bytes), 1)
    amortized = model.bw_Bps * model.t0_s * _OVERHEAD_AMORT
    n = min(
        max_channels,
        max(1, os.cpu_count() or 1),
        max(1, int(payload_bytes / max(amortized, 1.0))),
        max(1, payload_bytes // max(min_stripe_bytes, 1)),
    )
    stripe = math.ceil(payload_bytes / n)
    target_chunks = 2 * max(1, completion_workers)
    block = max(model.optimal_block_bytes(stripe),
                math.ceil(stripe / target_chunks))
    n_chunks = math.ceil(stripe / block)
    # preemptive chunked dispatch: size the runtime's mid-chunk yield
    # granularity from the same fit (bounded per-segment service time),
    # so a TOKEN arrival never waits out a whole block_bytes memcpy.
    preempt = (model.preempt_chunk_bytes(preempt_target_s)
               if preempt_target_s else 0)
    if n_chunks <= 1:
        policy = TransferPolicy(Management.INTERRUPT, Buffering.RING,
                                Partitioning.UNIQUE, block_bytes=block,
                                ring_depth=2,
                                completion_workers=completion_workers,
                                preempt_chunk_bytes=preempt)
    else:
        depth = max(2, min(8, n_chunks))
        policy = TransferPolicy(Management.INTERRUPT, Buffering.RING,
                                Partitioning.BLOCKS, block_bytes=block,
                                ring_depth=depth,
                                completion_workers=completion_workers,
                                preempt_chunk_bytes=preempt)
    return ChannelPlan(n_channels=n, policy=policy, model=model,
                       payload_bytes=payload_bytes)


# ---------------------------------------------------------------------------
# The channel group
# ---------------------------------------------------------------------------

class ChannelGroup:
    """N descriptor-ring engines serving one logical transfer stream.

    Duck-types :class:`TransferEngine` for the executors: same ``device`` /
    ``policy`` / ``layouts`` / ``tx`` / ``rx`` / ``tx_async`` / ``rx_async``
    / ``close`` surface, with payloads striped across the member rings.

    ``devices``: one per channel, all the same device (``None``: the
    current CUDA card for every channel, raising when there is none). Each
    member engine owns its own copy streams on that device."""

    def __init__(self, policy: TransferPolicy | None = None, *,
                 n_channels: int = 2,
                 devices: "Sequence[torch.device | str] | None" = None,
                 pool: StagingPool | None = None,
                 min_stripe_bytes: int = _MIN_STRIPE_BYTES,
                 plan: ChannelPlan | None = None,
                 engine_factory: Callable[..., TransferEngine] | None = None,
                 layouts: LayoutCache | None = None,
                 runtime: TransferRuntime | None = None,
                 priority: PriorityClass = PriorityClass.LAYER,
                 recovery: RecoveryConfig | None = None,
                 fault_state: TransferFaultState | None = None,
                 qos: QosSpec | None = None):
        policy = policy or TransferPolicy.kernel_level_ring()
        if policy.management is not Management.INTERRUPT:
            raise ValueError(
                "ChannelGroup stripes via tx_async/rx_async and therefore "
                f"requires INTERRUPT management (got {policy.tag})")
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        # all channels target ONE device: consumers concatenate the
        # striped chunks into a single tensor (reassemble_chunks /
        # StagedLayout.unpack), which requires the chunks to share a
        # device, and the executors read the group's one ``device``. This
        # is the multi-channel-DMA-on-one-port analogue.
        if devices is None:
            devices = [default_device(None)] * n_channels
        devices = [torch.device(d) for d in devices]
        if len(devices) != n_channels or len(set(devices)) != 1:
            raise ValueError(
                f"a ChannelGroup's {n_channels} channels need one device "
                f"each, all the same; got {devices}")
        self.device = devices[0]
        self.policy = policy
        self.plan = plan
        self.n_channels = n_channels
        self.min_stripe_bytes = max(int(min_stripe_bytes), 1)
        self.staging_pool = pool or StagingPool(
            pin_memory=self.device.type == "cuda")
        # ``layouts`` may be handed in so plan generations (the online
        # adaptive controller rebuilds the group on drift) keep their cached
        # staging layouts instead of re-deriving every pack plan.
        self.layouts = layouts or LayoutCache(pool=self.staging_pool)
        # ``engine_factory`` builds each member ring; tests and the drift
        # benchmark inject engines with synthetic timing through it. ALL
        # stripes share one runtime (None = the process default): striping
        # multiplies channels, never completion pools.
        self.qos = QosSpec(priority=priority).merged(qos)
        self.priority = self.qos.priority
        self._runtime = runtime
        factory = engine_factory or TransferEngine
        # factories keep the narrow (policy, device, runtime, priority)
        # signature — per-call qos= carries the rest down at submit time.
        self.engines = [factory(policy, device=d, runtime=runtime,
                                priority=self.priority) for d in devices]
        self._closed = False
        # bounded recent history (see TransferEngine.stats); aggregate
        # totals live on the member engines' counters.
        self._stats_lock = make_lock("ChannelGroup._stats_lock")
        self.stats: "collections.deque[TransferStats]" = collections.deque(
            maxlen=_STATS_WINDOW)          # guarded-by: _stats_lock
        self._observers: list[Callable[[TransferStats], None]] = \
            []                             # guarded-by: _stats_lock
        # round-robin cursor for sub-stripe payloads
        self._rr = 0                       # guarded-by: _stats_lock
        self._joiners: list[threading.Thread] = []  # guarded-by: _stats_lock
        # -- self-healing state ----------------------------------------------
        # ``fault_state`` may be handed in so an adaptive facade's plan
        # generations share ONE ledger across safe-point swaps.
        self.recovery = recovery or RecoveryConfig()
        self.fault_state = fault_state or TransferFaultState()
        self._quarantined: set[int] = set()        # guarded-by: _stats_lock
        self._consec_faults = [0] * n_channels     # guarded-by: _stats_lock
        self._health_lock = make_lock("ChannelGroup._health_lock")
        # per-channel descriptor-health windows, fed by PEEKING each
        # engine's chunk_samples via its monotone chunk_seq (the refit
        # consumer pops the same deque destructively — we must not race
        # it for samples, only read the tail it has not yet consumed).
        self._health_seen = [0] * n_channels       # guarded-by: _health_lock
        self._health: list["collections.deque[tuple[int, float]]"] = [
            collections.deque(maxlen=64)
            for _ in range(n_channels)]            # guarded-by: _health_lock
        self._probe_stamp = [float("-inf")] * n_channels  # guarded-by: _health_lock

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def auto(cls, payload_bytes: int, *,
             max_channels: int = 4,
             devices: "Sequence[torch.device | str] | None" = None,
             model: TransferCostModel | None = None,
             pool: StagingPool | None = None,
             engine_factory: Callable[..., TransferEngine] | None = None,
             runtime: TransferRuntime | None = None,
             priority: PriorityClass = PriorityClass.LAYER,
             recovery: RecoveryConfig | None = None,
             fault_state: TransferFaultState | None = None
             ) -> "ChannelGroup":
        """Calibrate, fit, and build the group the cost model recommends
        (on ``devices[0]``, the one device of every channel)."""
        device = devices[0] if devices else None
        plan = plan_channels(payload_bytes, model=model, device=device,
                             max_channels=max_channels)
        return cls(plan.policy, n_channels=plan.n_channels,
                   devices=(None if device is None
                            else [device] * plan.n_channels),
                   pool=pool, plan=plan, engine_factory=engine_factory,
                   runtime=runtime, priority=priority, recovery=recovery,
                   fault_state=fault_state)

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: joiners first (they wait on engine tickets, which
        need live runtime workers), then member engines deregister. The
        whole drain respects ``timeout`` per stage — a wedged descriptor
        is cancelled, never waited on forever."""
        if self._closed:
            return
        self._closed = True
        with self._stats_lock:
            joiners, self._joiners = self._joiners, []
        for t in joiners:
            t.join(timeout=timeout)
        for eng in self.engines:
            eng.close(timeout)

    @property
    def runtime(self) -> TransferRuntime | None:
        """The (shared) runtime the member engines dispatch on."""
        if self._runtime is not None:
            return self._runtime
        for eng in self.engines:
            rt = getattr(eng, "runtime", None)
            if rt is not None:
                return rt
        return None

    def __enter__(self) -> "ChannelGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def maybe_adapt(self, *, force: bool = False) -> bool:
        """Safe-point hook. A plain group's PLAN is fixed at construction,
        but its channel-health machinery still runs here: drift detection
        (a silently degraded channel is pulled from the stripe rotation)
        and probe-based un-quarantine. Returns True when the active channel
        set changed (AdaptiveChannelGroup extends this with replanning)."""
        return self.check_channel_health()

    # -- channel quarantine (self-healing) -----------------------------------
    @property
    def quarantined(self) -> set[int]:
        """Channel indices currently pulled from the stripe rotation."""
        with self._stats_lock:
            return set(self._quarantined)

    def _active_indices(self) -> list[int]:
        with self._stats_lock:
            act = [i for i in range(self.n_channels)
                   if i not in self._quarantined]
        return act or list(range(self.n_channels))  # never zero channels

    def _resolve_qos(self, where: str, qos: QosSpec | None,
                     priority: PriorityClass | None) -> QosSpec:
        """One group call's effective submit context (see
        :meth:`TransferEngine._resolve_qos` — same shim, group default)."""
        spec = resolve_submit_qos(f"{type(self).__name__}.{where}",
                                  qos, priority)
        return self.qos.merged(spec)

    def _note_runtime_fault(self, tenant: str | None = None,
                            **counts) -> None:
        rt = self.runtime
        if rt is not None:
            rt.note_fault(self.priority, tenant=tenant, **counts)

    def _note_fault(self, ch: int, err: BaseException,
                    tenant: str | None = None) -> None:
        """Attribute one fault to channel ``ch`` (and to ``tenant`` when
        the stripe carried one); quarantine the channel after
        ``recovery.quarantine_after`` consecutive faults (never the last
        active channel — a degraded channel beats no channel)."""
        self.fault_state.record_fault(
            ch, timeout=isinstance(err, TransferTimeoutError),
            checksum=isinstance(err, TransferChecksumError),
            tenant=tenant)
        self._note_runtime_fault(
            tenant=tenant,
            faults=1, timeouts=int(isinstance(err, TransferTimeoutError)))
        quarantined = False
        with self._stats_lock:
            self._consec_faults[ch] += 1
            if (self._consec_faults[ch] >= self.recovery.quarantine_after
                    and ch not in self._quarantined
                    and len(self._quarantined) < self.n_channels - 1):
                self._quarantined.add(ch)
                quarantined = True
        if quarantined:
            self.fault_state.record_quarantine(ch, on=True, tenant=tenant)
            self._note_runtime_fault(tenant=tenant, quarantines=1)

    def _note_success(self, ch: int) -> None:
        with self._stats_lock:
            self._consec_faults[ch] = 0

    def _sibling_for_retry(self, ch: int) -> int | None:
        """An active channel other than ``ch`` to resubmit a failed stripe
        on (round-robin over the healthy set); None when ``ch`` is the
        only channel left."""
        with self._stats_lock:
            cands = [i for i in range(self.n_channels)
                     if i != ch and i not in self._quarantined]
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    # requires-lock: _health_lock
    def _ingest_health_samples(self) -> None:
        """Peek each engine's NEW chunk samples (chunk_seq-delimited tail;
        never pops — the adaptive refit consumer owns the destructive
        read) into the per-channel health windows."""
        assert_held(self._health_lock, "_ingest_health_samples")
        for i, eng in enumerate(self.engines):
            seq = getattr(eng, "chunk_seq", None)
            if seq is None:
                continue
            new = seq - self._health_seen[i]
            if new <= 0:
                continue
            self._health_seen[i] = seq
            tail = list(eng.chunk_samples)[-new:]
            for (_d, _m, nbytes, dt) in tail:
                if nbytes > 0:
                    self._health[i].append((nbytes, dt))

    @staticmethod
    def _median_s_per_b(window: "collections.deque[tuple[int, float]]"
                        ) -> float | None:
        if not window:
            return None
        rates = sorted(dt / nb for nb, dt in window)
        return rates[len(rates) // 2]

    def check_channel_health(self) -> bool:
        """Drift quarantine + probe-based un-quarantine. Median seconds/
        byte per channel over recent descriptors, compared to the healthy
        group's median — deliberately NOT the RollingFit t0/BW fit, whose
        size-spread gate goes degenerate under uniform chunk sizes (the
        steady state of striped traffic). Returns True when the active
        channel set changed."""
        rec = self.recovery
        if not self._health_lock.acquire(blocking=False):
            return False  # another safe point is already running checks
        try:
            changed = False
            if rec.drift_quarantine_ratio is not None:
                changed |= self._drift_check()
            changed |= self._probe_quarantined()
            return changed
        finally:
            self._health_lock.release()

    def _drift_check(self) -> bool:  # requires-lock: _health_lock
        rec = self.recovery
        self._ingest_health_samples()
        with self._stats_lock:
            active = [i for i in range(self.n_channels)
                      if i not in self._quarantined]
        medians = {i: self._median_s_per_b(self._health[i]) for i in active
                   if len(self._health[i]) >= rec.health_min_samples}
        if len(medians) < 2:
            return False  # nothing to compare against
        group = sorted(medians.values())[len(medians) // 2]
        if group <= 0:
            return False
        changed = False
        for i, m in medians.items():
            if m / group < rec.drift_quarantine_ratio:
                continue
            with self._stats_lock:
                if (i in self._quarantined
                        or len(self._quarantined) >= self.n_channels - 1):
                    continue
                self._quarantined.add(i)
                self._consec_faults[i] = 0
            self.fault_state.record_quarantine(i, on=True)
            self._note_runtime_fault(quarantines=1)
            changed = True
        return changed

    # requires-lock: _health_lock
    def _probe_quarantined(self) -> bool:
        """Issue a small bounded probe TX on each quarantined channel (rate
        limited); a probe that completes at a healthy rate returns the
        channel to the stripe rotation."""
        assert_held(self._health_lock, "_probe_quarantined")
        rec = self.recovery
        now = time.monotonic()
        with self._stats_lock:
            due = [i for i in sorted(self._quarantined)
                   if now - self._probe_stamp[i] >= rec.probe_interval_s]
        changed = False
        for i in due:
            self._probe_stamp[i] = time.monotonic()
            eng = self.engines[i]
            payload = np.zeros(max(rec.probe_bytes, 1), np.uint8)
            wait_s = rec.stripe_timeout_s or 1.0
            t0 = time.perf_counter()
            try:
                eng.tx_async(payload).wait(wait_s)  # lock-ok: _health_lock is a non-blocking
                # try-acquire exclusion guard; submitters never contend on it
            except BaseException:
                continue  # still sick: stays quarantined
            probe_s = time.perf_counter() - t0
            # a completing probe is necessary but not sufficient: a merely
            # SLOW channel (the stall fault) completes probes too. Race the
            # IDENTICAL payload on a healthy sibling — same size, same t0
            # share — so the comparison is apples-to-apples (a chunk-median
            # baseline would unfairly penalize the probe's fixed overhead).
            with self._stats_lock:
                active = [j for j in range(self.n_channels)
                          if j not in self._quarantined]
                rr = self._rr
            if active and rec.drift_quarantine_ratio is not None:
                ref = self.engines[active[rr % len(active)]]
                t0 = time.perf_counter()
                try:
                    ref.tx_async(payload).wait(wait_s)  # lock-ok: see probe above
                    ref_s = time.perf_counter() - t0
                except BaseException:  # sibling flaked: skip the rate gate
                    ref_s = None
                if (ref_s is not None and ref_s > 0
                        and probe_s / ref_s >= rec.drift_quarantine_ratio):
                    continue  # completed, but still drifted: stay out
            with self._stats_lock:
                self._quarantined.discard(i)
                self._consec_faults[i] = 0
                self._health[i].clear()  # stale sick-era samples must not
                # immediately re-trip the drift check
            self.fault_state.record_quarantine(i, on=False)
            changed = True
        return changed

    def set_class_cap(self, cls: PriorityClass,
                      bytes_per_s: float | None) -> None:
        """Per-class bandwidth cap on the SHARED runtime every member ring
        dispatches on (one cap covers all stripes — striping multiplies
        channels, never bandwidth budgets)."""
        rt = self.runtime
        if rt is None:
            raise RuntimeError("ChannelGroup has no runtime to cap")
        rt.set_class_cap(cls, bytes_per_s)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def tag(self) -> str:
        return f"{self.n_channels}ch-{self.policy.tag}"

    @property
    def max_inflight(self) -> int:
        return max((e.max_inflight for e in self.engines), default=0)

    def add_observer(self, fn: Callable[[TransferStats], None]) -> None:
        """Subscribe to every group-level recorded stat (the refit feed)."""
        with self._stats_lock:
            self._observers.append(fn)

    def _record(self, stats: TransferStats) -> None:
        if not stats.management:
            stats.management = self.policy.management.value
        with self._stats_lock:
            self.stats.append(stats)
            observers = list(self._observers)
        for fn in observers:
            fn(stats)

    def _next_channel(self) -> TransferEngine:
        with self._stats_lock:
            act = [i for i in range(self.n_channels)
                   if i not in self._quarantined] or list(
                       range(self.n_channels))
            eng = self.engines[act[self._rr % len(act)]]
            self._rr += 1
        return eng

    def _delegated(self, direction: str, nbytes: int, n_items: int,
                   callback: Callable[[list], None] | None):
        """Completion callback for single-channel (sub-stripe) transfers:
        records a group-level stat so ``summary()`` sees small transfers
        too, then chains the caller's callback."""
        t0 = time.perf_counter()

        def cb(results: list) -> None:
            self._record(TransferStats(nbytes, time.perf_counter() - t0,
                                       n_items, direction, self.tag))
            if callback is not None:
                callback(results)

        return cb

    def _order_rx_after_caller(self) -> None:
        """Called on the submitting thread before a striped RX: every
        member's device->host stream waits for the work queued so far on
        the caller's current stream. The stripes are issued from joiner
        threads, whose current stream is the default one, so a member's
        own ordering there would not see a kernel the caller queued on a
        stream it made current — a stripe could be read before it is
        written. Every member waits, not only the stripes' channels: a
        faulted stripe retries on a sibling."""
        if self.device.type != "cuda":
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        for eng in self.engines:
            eng._rx_stream.wait_event(ready)

    # -- striping ------------------------------------------------------------
    def _stripes(self, flat: np.ndarray,
                 n_channels: int | None = None) -> list[np.ndarray]:
        """Contiguous, bytes-balanced element ranges of ``flat`` — views, so
        striping itself copies nothing. Payloads below 2 minimum stripes use
        a single channel (a second channel would cost more than its t0).
        ``n_channels`` bounds the stripe count (the ACTIVE channel count —
        quarantined channels take no stripes)."""
        n = n_channels if n_channels is not None else self.n_channels
        if flat.nbytes >= 2 * self.min_stripe_bytes:
            n = min(n, max(1, flat.nbytes // self.min_stripe_bytes))
        else:
            n = 1
        if n == 1:
            return [flat]
        return [s for s in np.array_split(flat, n) if s.size]

    def _run_stripe(self, issue_fn: Callable[[TransferEngine], Ticket],
                    ch: int, tenant: str | None = None) -> Any:
        """Issue one stripe on channel ``ch``, wait (bounded by
        ``recovery.stripe_timeout_s``), and on a retryable fault resubmit
        on a sibling channel up to ``recovery.max_retries`` times.

        Only :class:`~repro_torch.core.runtime.TransferFaultError` retries
        (injected faults, checksum mismatches, timeouts); structural
        errors (closed engine, bad payload) surface immediately. A
        timed-out original attempt may still be in service — safe, because
        a faulted descriptor never lands payload bytes (drops raise before
        the copy) and a merely-slow duplicate lands the same bytes."""
        wait_s = self.recovery.stripe_timeout_s
        attempt = 0
        while True:
            try:
                result = issue_fn(self.engines[ch]).wait(wait_s)
            except TransferFaultError as e:
                self._note_fault(ch, e, tenant=tenant)
                if attempt > 0:
                    self.fault_state.record_retry(success=False,
                                                  tenant=tenant)
                    self._note_runtime_fault(tenant=tenant, retries=1)
                sibling = self._sibling_for_retry(ch)
                if attempt >= self.recovery.max_retries or sibling is None:
                    raise
                attempt += 1
                ch = sibling
                continue
            self._note_success(ch)
            if attempt > 0:
                self.fault_state.record_retry(success=True, tenant=tenant)
                self._note_runtime_fault(tenant=tenant, retries=1)
            return result

    def _join(self, issue: list[Callable[[TransferEngine], Ticket]],
              channels: list[int],
              assemble: Callable[[list], list],
              direction: str, nbytes: int, n_items: int,
              master: threading.Event, ticket_out: list,
              callback: Callable[[list], None] | None,
              t0: float, tenant: str | None = None) -> None:
        """Coordinator: issue every stripe's transfer from its OWN thread
        (a full ring back-pressures its submitter, so issuing serially from
        one thread would serialize the channels), wait bounded, retry
        faulted stripes on siblings, then reassemble in stripe order."""
        n = len(issue)
        per_channel: list = [None] * n
        errs: list = [None] * n

        def run_one(i: int) -> None:
            try:
                per_channel[i] = self._run_stripe(issue[i], channels[i],
                                                  tenant=tenant)
            except BaseException as e:  # noqa: BLE001 — surfaced at wait()
                errs[i] = e

        runners = [threading.Thread(target=run_one, args=(i,), daemon=True)
                   for i in range(1, n)]
        for t in runners:
            t.start()
        run_one(0)
        for t in runners:
            t.join()

        err: BaseException | None = next(
            (e for e in errs if e is not None), None)
        if err is not None:
            ticket_out.append(err)
        else:
            results = assemble(per_channel)
            self._record(TransferStats(nbytes, time.perf_counter() - t0,
                                       n_items, direction, self.tag))
            ticket_out.append(results)
            if callback is not None:
                try:
                    callback(results)
                except BaseException as e:  # noqa: BLE001
                    ticket_out[0] = e
        master.set()

    def _spawn_joiner(self, issue, channels, assemble, direction, nbytes,
                      n_items, master, ticket_out, callback, t0,
                      tenant: str | None = None) -> None:
        # a few short-lived threads per *striped* transfer (~50 us spawn vs
        # the >= 2*min_stripe_bytes transfer they issue/join); sub-stripe
        # traffic takes the delegated path and never pays this.
        t = threading.Thread(
            target=self._join,
            args=(issue, channels, assemble, direction, nbytes, n_items,
                  master, ticket_out, callback, t0, tenant),
            daemon=True,
        )
        with self._stats_lock:
            self._joiners = [j for j in self._joiners if j.is_alive()]
            self._joiners.append(t)
        t.start()

    # -- TX -------------------------------------------------------------------
    def tx_async(self, host_array: np.ndarray,
                 callback: Callable[[list], None] | None = None,
                 layout: StagedLayout | None = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None) -> Ticket:
        """Striped asynchronous TX: each stripe rides its own channel's ring.

        The combined ticket completes when every channel drained; ``layout``
        (when given) is marked busy for the whole group transfer before any
        descriptor is submitted."""
        spec = self._resolve_qos("tx_async", qos, priority)
        arr = np.asarray(host_array)
        flat = arr.reshape(-1)
        active = self._active_indices()  # quarantined rings take no stripes
        stripes = self._stripes(flat, len(active))
        if len(stripes) == 1:
            # sub-stripe payload: no striping win — round-robin the channels
            # so concurrent small transfers (serving tokens) still spread.
            return self._next_channel().tx_async(
                flat, callback=self._delegated("tx", int(arr.nbytes), 1,
                                               callback),
                layout=layout, qos=spec)
        master = threading.Event()
        ticket_out: list = []
        t0 = time.perf_counter()
        if layout is not None:
            layout._busy = master  # busy BEFORE submit (whole-group window)
        # engine-parameterized issue closures: the joiner issues stripe i on
        # channels[i] first and may RE-issue it on a sibling after a fault.
        issue = [lambda eng, s=s: eng.tx_async(s, qos=spec)
                 for s in stripes]
        channels = active[:len(stripes)]

        def assemble(per_channel: list) -> list:
            # stripes are contiguous in stripe order: concatenating the
            # chunk lists reproduces the flat payload for reassemble_chunks.
            out: list = []
            for chunks in per_channel:
                out.extend(chunks)
            return out

        self._spawn_joiner(issue, channels, assemble, "tx", int(arr.nbytes),
                           len(stripes), master, ticket_out, callback, t0,
                           tenant=spec.tenant)
        return Ticket(master, ticket_out)

    def tx(self, host_array: np.ndarray,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None) -> list[torch.Tensor]:
        """Synchronous striped TX; returns the ordered device chunk list."""
        spec = self._resolve_qos("tx", qos, priority)
        return self.tx_async(host_array, qos=spec).wait()

    # -- RX -------------------------------------------------------------------
    def _rx_outs(self, arrays: list,
                 out: "np.ndarray | Sequence[np.ndarray] | None") -> list:
        """Normalise ``out=`` to one caller-owned buffer per device array.

        Accepts either a sequence of per-array buffers or ONE flat
        preallocated array covering the whole payload — the latter is carved
        into per-array byte-range views (zero-copy), so striped ordered
        reassembly lands each channel's result directly in the caller's
        array at its final offset."""
        if out is None:
            return [None] * len(arrays)
        if isinstance(out, np.ndarray):
            return carve_flat_out(out, arrays)
        # per-array buffers: validate count/writability/contiguity/sizes UP
        # FRONT — a bad list failing mid-stripe on an issuer thread would
        # surface as an opaque error after other channels already wrote.
        return _check_out(arrays, out)

    def rx_async(self, device_arrays: Sequence[torch.Tensor],
                 callback: Callable[[list], None] | None = None,
                 out: "np.ndarray | Sequence[np.ndarray] | None" = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None
                 ) -> Ticket:
        """Striped asynchronous RX: arrays spread over channels greedily by
        byte load; results come back in the original order.

        ``out``: caller-owned destination — per-array buffers or one flat
        array for the whole payload. Channels write their stripes straight
        into it; the ticket yields the caller's buffers (or the flat
        array's byte views), never fresh allocations."""
        spec = self._resolve_qos("rx_async", qos, priority)
        arrays = list(device_arrays)
        outs = self._rx_outs(arrays, out)
        nbytes = sum(_nbytes(a) for a in arrays)
        if len(arrays) <= 1 or nbytes < 2 * self.min_stripe_bytes:
            return self._next_channel().rx_async(
                arrays, callback=self._delegated("rx", nbytes, len(arrays),
                                                 callback),
                out=outs if out is not None else None, qos=spec)
        # greedy least-loaded assignment over the ACTIVE channels
        # (bytes-balanced striping; quarantined rings take no stripes)
        active = self._active_indices()
        assign: list[list[int]] = [[] for _ in active]
        loads = [0] * len(active)
        for i, a in enumerate(arrays):
            c = min(range(len(active)), key=loads.__getitem__)
            assign[c].append(i)
            loads[c] += _nbytes(a)
        master = threading.Event()
        ticket_out: list = []
        t0 = time.perf_counter()
        used = [(active[c], idxs) for c, idxs in enumerate(assign) if idxs]
        self._order_rx_after_caller()
        issue = [lambda eng, idxs=idxs: eng.rx_async(
            [arrays[i] for i in idxs],
            out=([outs[i] for i in idxs] if out is not None else None),
            qos=spec)
            for _c, idxs in used]
        channels = [c for c, _idxs in used]

        def assemble(per_channel: list) -> list:
            results: list = [None] * len(arrays)
            for (_, idxs), ch_out in zip(used, per_channel):
                for i, o in zip(idxs, ch_out):
                    results[i] = o
            return results

        self._spawn_joiner(issue, channels, assemble, "rx", nbytes,
                           len(arrays), master, ticket_out, callback, t0,
                           tenant=spec.tenant)
        return Ticket(master, ticket_out)

    def rx(self, device_arrays: Sequence[torch.Tensor],
           out: "np.ndarray | Sequence[np.ndarray] | None" = None,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None
           ) -> list[np.ndarray]:
        """Synchronous striped RX; host arrays in the original order. With
        ``out=`` the results land in the caller's preallocated buffers."""
        spec = self._resolve_qos("rx", qos, priority)
        return self.rx_async(device_arrays, out=out, qos=spec).wait()

    # -- batched descriptor submission ----------------------------------------
    def tx_many(self, host_arrays: Sequence[np.ndarray],
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched TX through the group: the K logical descriptors are
        round-robin partitioned over the ACTIVE channels and each channel's
        share goes down as ONE ring transaction (``TransferEngine.
        tx_many``); tickets come back in input order. Unlike the striped
        paths there is no sibling-retry here — a per-descriptor fault
        surfaces on its own ticket (the batch amortization contract is
        exactly-once submission); byte accounting lands on the per-channel
        engines."""
        spec = self._resolve_qos("tx_many", qos, priority)
        arrays = [np.asarray(a) for a in host_arrays]
        active = self._active_indices()
        if len(arrays) <= 1 or len(active) <= 1:
            return self._next_channel().tx_many(arrays, qos=spec)
        tickets: list[Ticket | None] = [None] * len(arrays)
        for c, ch in enumerate(active):
            idxs = list(range(c, len(arrays), len(active)))
            if not idxs:
                continue
            sub = self.engines[ch].tx_many([arrays[i] for i in idxs],
                                           qos=spec)
            for i, t in zip(idxs, sub):
                tickets[i] = t
        return tickets  # type: ignore[return-value]

    def rx_many(self, device_arrays: Sequence[torch.Tensor],
                out: "np.ndarray | Sequence[np.ndarray] | None" = None,
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched RX through the group, mirroring :meth:`tx_many`.
        ``out`` accepts per-array buffers or ONE flat array carved into
        per-descriptor views (zero-copy), exactly like :meth:`rx_async`."""
        spec = self._resolve_qos("rx_many", qos, priority)
        arrays = list(device_arrays)
        outs = self._rx_outs(arrays, out)
        active = self._active_indices()
        if len(arrays) <= 1 or len(active) <= 1:
            return self._next_channel().rx_many(
                arrays, out=outs if out is not None else None,
                qos=spec)
        tickets: list[Ticket | None] = [None] * len(arrays)
        for c, ch in enumerate(active):
            idxs = list(range(c, len(arrays), len(active)))
            if not idxs:
                continue
            sub = self.engines[ch].rx_many(
                [arrays[i] for i in idxs],
                out=([outs[i] for i in idxs] if out is not None else None),
                qos=spec)
            for i, t in zip(idxs, sub):
                tickets[i] = t
        return tickets  # type: ignore[return-value]

    # -- scatter-gather --------------------------------------------------------
    def prefer_sg(self, sizes: Sequence[int],
                  model: Any | None = None) -> bool:
        """Pack-vs-SG decision for the group: priced by the first ACTIVE
        channel's engine (all channels share the policy, so one engine's
        fit speaks for the group)."""
        active = self._active_indices()
        return self.engines[active[0] if active else 0].prefer_sg(
            sizes, model)

    def _sg_assign(self, sizes: list[int],
                   active: list[int]) -> list[tuple[int, list[int]]]:
        """Greedy least-loaded assignment of segments to ACTIVE channels —
        bytes-balanced at SEGMENT granularity; a segment never splits
        (splitting would reintroduce the partial-copy the SG form exists
        to avoid). Returns ``(channel, segment_indices)`` pairs."""
        assign: list[list[int]] = [[] for _ in active]
        loads = [0] * len(active)
        for i, nb in enumerate(sizes):
            c = min(range(len(active)), key=loads.__getitem__)
            assign[c].append(i)
            loads[c] += nb
        return [(active[c], idxs) for c, idxs in enumerate(assign) if idxs]

    def tx_sg(self, segments: Sequence,
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather TX through the group: the segment list is spread
        over the ACTIVE channels by byte load and each channel's share goes
        down as ONE ring slot (its engine's ``tx_sg``), zero staging copy.
        Results come back in the original segment order; a faulted share
        retries whole on a sibling channel (the striped-recovery contract),
        so striping and quarantine compose with the SG form."""
        spec = self._resolve_qos("tx_sg", qos, priority)
        views, sizes = _sg_segment_views(segments, "tx")
        active = self._active_indices()
        total = sum(sizes)
        if (len(views) <= 1 or len(active) <= 1
                or total < 2 * self.min_stripe_bytes):
            # sub-stripe or single-channel: delegate the whole chain —
            # round-robin keeps concurrent small SG submits spread.
            return self._next_channel().tx_sg(views, qos=spec)
        used = self._sg_assign(sizes, active)
        master = threading.Event()
        ticket_out: list = []
        t0 = time.perf_counter()
        issue = [lambda eng, idxs=idxs: eng.tx_sg(
            [views[i] for i in idxs], qos=spec)
            for _c, idxs in used]
        channels = [c for c, _idxs in used]

        def assemble(per_channel: list) -> list:
            results: list = [None] * len(views)
            for (_, idxs), ch_out in zip(used, per_channel):
                for i, o in zip(idxs, ch_out):
                    results[i] = o
            return results

        self._spawn_joiner(issue, channels, assemble, "tx", total,
                           len(views), master, ticket_out, None, t0,
                           tenant=spec.tenant)
        return SGTicket([_IndexTicket(master, ticket_out, i)
                         for i in range(len(views))])

    def rx_sg(self, segments: Sequence,
              out: "np.ndarray | Sequence[np.ndarray] | None" = None,
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather RX through the group (see :meth:`tx_sg`); ``out``
        accepts per-segment buffers or ONE flat array carved into
        per-segment views (zero-copy), exactly like :meth:`rx_async`."""
        spec = self._resolve_qos("rx_sg", qos, priority)
        views, sizes = _sg_segment_views(segments, "rx")
        outs = self._rx_outs(views, out)
        active = self._active_indices()
        total = sum(sizes)
        if (len(views) <= 1 or len(active) <= 1
                or total < 2 * self.min_stripe_bytes):
            return self._next_channel().rx_sg(
                views, out=outs if out is not None else None,
                qos=spec)
        used = self._sg_assign(sizes, active)
        self._order_rx_after_caller()
        master = threading.Event()
        ticket_out: list = []
        t0 = time.perf_counter()
        issue = [lambda eng, idxs=idxs: eng.rx_sg(
            [views[i] for i in idxs],
            out=([outs[i] for i in idxs] if out is not None else None),
            qos=spec)
            for _c, idxs in used]
        channels = [c for c, _idxs in used]

        def assemble(per_channel: list) -> list:
            results: list = [None] * len(views)
            for (_, idxs), ch_out in zip(used, per_channel):
                for i, o in zip(idxs, ch_out):
                    results[i] = o
            return results

        self._spawn_joiner(issue, channels, assemble, "rx", total,
                           len(views), master, ticket_out, None, t0,
                           tenant=spec.tenant)
        return SGTicket([_IndexTicket(master, ticket_out, i)
                         for i in range(len(views))])

    # -- reporting ------------------------------------------------------------
    def summary(self) -> dict[str, dict[str, float]]:
        # snapshot under the lock: stripe joiners append records
        # concurrently and deque iteration is not atomic vs appends
        with self._stats_lock:
            records = list(self.stats)
        tx = [s for s in records if s.direction == "tx"]
        rx = [s for s in records if s.direction == "rx"]

        def agg(ss):
            if not ss:
                return {"us_per_byte": float("nan"), "gbps": float("nan")}
            tot_b = sum(s.nbytes for s in ss)
            tot_t = sum(s.wall_s for s in ss)
            return {"us_per_byte": tot_t * 1e6 / max(tot_b, 1),
                    "gbps": tot_b / max(tot_t, 1e-12) / 1e9}

        return {"tx": agg(tx), "rx": agg(rx),
                "faults": self.fault_state.summary(),
                "quarantined": sorted(self.quarantined)}

    def fault_summary(self) -> dict[str, object]:
        """The group's fault ledger + current quarantine set (the uniform
        fault surface shared with AdaptiveChannelGroup / ServingEngine)."""
        return {"faults": self.fault_state.summary(),
                "quarantined": sorted(self.quarantined)}
