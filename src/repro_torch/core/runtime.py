"""Unified interrupt-style TransferRuntime with QoS arbitration.

The paper's headline result is that the kernel-level *interrupt-driven*
driver beats user-level polling because completion handling is centralized:
one interrupt controller arbitrates DMA completions against every other
task competing for the CPU (DVS event collection, frame normalisation),
instead of each transfer spinning in isolation. Before this module, our
repro had the opposite shape — every engine owned a private completion
pool (N engines x 2 workers of thread sprawl, zero cross-stream
arbitration). This module is the interrupt controller: ONE process-wide
event loop that owns completion dispatch for every INTERRUPT-mode engine
and channel, arbitrating between priority classes the way the paper's OS
arbitrates DMA IRQs against sensor collection.

The paper's three management modes are three *backends* of one submit
contract ``submit(fn, nbytes=..., priority=...) -> (Event, out_list)``:

====================  =====================================================
paper mode            backend
====================  =====================================================
user-level polling    :class:`PollingBackend` — the submit IS the transfer;
                      runs inline on the caller (lowest overhead, blocks
                      the host). Engines keep this path inline — polling
                      never touches the runtime.
user-level scheduled  :class:`ScheduledBackend` — wraps the (re-homed)
                      :class:`CooperativeScheduler`: single-threaded,
                      transfers interleave with registered background
                      tasks, ``drain()`` runs the queue on the caller.
kernel interrupt      :class:`TransferRuntime` — shared bounded worker
                      pool; ISR-style completion dispatch with
                      deadline-aware weighted-fair arbitration across
                      priority classes.
====================  =====================================================

Priority classes (:class:`PriorityClass`) map the workloads of the paper's
SoC — and of this repo's serving/training stack — onto IRQ levels:

- ``SENSOR``  frame/event ingest (the paper's DVS collection), registered
  as *background* tasks that run between completions;
- ``TOKEN``   decode-token RX — latency-critical serving traffic;
- ``LAYER``   layer parameter TX / feature-map RX — streaming inference;
- ``BULK``    prefetch, checkpoint staging — best-effort throughput.

Arbitration is three-level, and starvation-free by construction:

1. *reserved latency lane*: dispatch is non-preemptive (a worker mid-memcpy
   cannot be interrupted), so once a latency-critical source (TOKEN /
   SENSOR) is registered, the last worker slot refuses LAYER/BULK
   descriptors — exactly a DMA controller's reserved high-priority
   channel. Without it, every worker can be head-of-line-blocked on a
   bulk chunk when a token arrives. Disabled when ``workers == 1`` (it
   would deadlock bulk) and until a latency class appears (a bulk-only
   process keeps every worker); recency-gated, so the lane releases
   again once latency traffic has been quiet for a few seconds — an
   idle serving engine does not pin half the workers.
2. *deadline promotion*: any queued descriptor past its class deadline is
   dispatched first, earliest absolute deadline wins (EDF). Absolute
   deadlines mean an old BULK descriptor eventually outranks fresh TOKEN
   traffic — bounded staleness, no livelock.
3. otherwise *weighted fair queuing*: each class carries a virtual time
   that advances by ``nbytes / weight`` per dispatch; the busy class with
   the smallest virtual time goes next. TOKEN's high weight lets its tiny
   descriptors jump a BULK backlog; BULK still drains at its weighted
   share. A class that went idle re-enters at the busy classes' floor so
   it cannot burst on accumulated lag.

Preemptive chunked dispatch
---------------------------
Dispatch of a single descriptor body is non-preemptive — a worker
mid-memcpy cannot be interrupted. The *chunked-dispatch contract* bounds
how long that matters: a submitter may hand the runtime a
:class:`PreemptibleWork` instead of a plain callable — a sequence of
short *segments* (sub-slices of the chunk's memcpy, sized by the fitted
cost model for a bounded per-segment service time) plus a ``collect``
fold and a ``finalize`` hook. The worker runs segments back to back; the
moment a latency-class (TOKEN/SENSOR) descriptor is queued while every
worker is busy, it *parks* the work between two segments — the
descriptor re-enters the FRONT of its class queue (with a renewed
deadline, so EDF does not immediately un-park it past the waiting
token), the worker dispatches the latency descriptor, and the parked
work resumes where its iterator left off. Guarantees of the contract:

- segments of one descriptor never run concurrently (the work is either
  in service on exactly one worker or queued);
- ``finalize(err)`` runs exactly once when the work completes or errors
  in service; a descriptor cancelled while queued/parked gets
  ``on_cancel`` instead (never both) — ring-slot release hooks stay
  single-shot;
- a parked descriptor runs at least one segment between parks, so
  continuous latency traffic slows bulk work but cannot starve it;
- preemption counts and parked-time percentiles land in
  :meth:`TransferRuntime.class_summary` (``preemptions``,
  ``preempt_park_p99_ms``).

Per-class bandwidth caps
------------------------
:meth:`TransferRuntime.set_class_cap` enforces a bytes-per-second
ceiling per priority class via token-bucket accounting inside the fair
queue: a capped class whose bucket is empty is simply not eligible for
dispatch (its head *defers*, counted in ``cap_deferrals``), so uncapped
classes borrow the freed dispatch headroom automatically. Deadline
promotion does NOT override a cap — the ceiling is hard, which is the
point of the ZynqNet-style per-class accounting. Workers park on a
timed wait sized to the earliest bucket refill, so a cap never strands
queued work.

Tier 2: per-tenant flows inside each class
------------------------------------------
The class tier is blind *within* a class: one flooding submitter
collapses p99 for every other user of the same PriorityClass. So each
class queue (:class:`_ClassFlowQueue`) replays the same arbitration one
level down, over per-tenant *flows* (Anachron's two-level DMA
arbitration, generalized from round-robin to WFQ):

- every submission carries a tenant id + weight via the
  :class:`~repro_torch.core.qos.QosSpec` submit context (untagged traffic
  shares the ``DEFAULT_TENANT`` flow, which reproduces pre-tenancy
  scheduling exactly);
- a class nominates ONE candidate head per pick: parked resumes first
  (charge-once, they hold in-service state), then EDF over overdue
  tenant heads, then the tenant flow with the smallest byte-weighted
  virtual time (idle flows re-enter at the busy floor, same rule as the
  class tier);
- per-tenant token buckets (:meth:`TransferRuntime.set_tenant_cap`, or
  ``QosSpec.cap_bytes_per_s`` per submission) form a cap *tree*: a
  dispatch must clear BOTH its tenant bucket and the class bucket, so
  the class cap bounds the sum of its tenants' effective rates and
  uncapped tenants borrow whatever headroom the class bucket leaves;
- ``class_summary()`` grows a per-tenant ledger (``row["tenants"]``)
  and a windowed ``deadline_miss_rate``; together with
  :meth:`TransferRuntime.tenant_depth` these feed the serving layer's
  :class:`~repro_torch.core.qos.AdmissionController`, which sheds load
  host-side before the accelerator queue backs up.

``TransferRuntime(tenant_fair=False)`` collapses tier 2 (every
descriptor lands in one flow per class) — the single-tier baseline the
tenant-isolation benchmark measures against.

Completion coalescing (per-class completion vectors)
----------------------------------------------------
The paper's floor on small packets is *management* overhead, not bus
bandwidth — and once descriptors shrink to token size, the per-completion
wakeup itself becomes the dominant management cost. Real interrupt
controllers solve this with MSI-X-style *completion vectors*: many DMA
completions coalesce into one interrupt. This runtime mirrors that. Each
:class:`PriorityClass` owns a completion vector (:class:`CoalescePolicy`)
that batches up to ``max_batch`` finished descriptors *or* a ``budget_s``
time window into ONE delivery pass — one stats/ticket/outstanding sweep
instead of N. The policy is adaptive in two ways:

- *class-shaped defaults* (:data:`DEFAULT_COALESCE`): TOKEN/SENSOR
  coalesce almost nothing (batch 2, 100 us) to protect p99; LAYER/BULK
  coalesce aggressively (batch 8/32, 1-2 ms) to amortize dispatch;
- *arrival-gated*: a class whose inter-completion gap (EWMA) exceeds its
  budget delivers immediately — coalescing sparse traffic would only add
  latency, never save a wakeup.

Two safety rules keep coalescing invisible to correctness: an errored
descriptor always flushes its class vector immediately (fault paths are
never delayed), and a completion that leaves its class *pipeline-empty*
(no queued or in-service siblings) flushes too — a synchronous waiter at
the end of a wave never stalls on the budget timer. Engine-side
protocols (ring-slot release, master-ticket ``finish_one``) run in the
descriptor body itself and are therefore never deferred; only the
runtime-level (stats, done-event, outstanding) handoff coalesces.
Savings and added latency are visible per class in
:meth:`TransferRuntime.class_summary` (``completion_wakeups``,
``wakeups_saved``, ``coalesce_batch_p99``, ``coalesce_delay_p99_ms``).

NEURAghe (Meloni et al., 2017) shows the same lesson at system scale — a
single runtime arbitrating PS/PL work is what makes heterogeneous CNN
inference compose; ZynqNet (Gschwend, 2016) motivates the per-class
bandwidth accounting and enforcement (:meth:`TransferRuntime.
class_summary`, :meth:`TransferRuntime.set_class_cap`).

While a ``torch.profiler`` records, each descriptor is tagged with a
number, its class, ``interrupt`` and its bytes under the submitting
thread's innermost span, and marks ``xfer.queue`` (submit until a worker
takes it: the stamps of ``dispatch_lat_s``), ``xfer.service`` (its body's
last stint) and ``xfer.deliver`` (completion until its done event is set:
the coalescing delay); the waiter marks ``xfer.wake``
(:mod:`repro_torch.utils.trace`).
"""

from __future__ import annotations

import atexit
import collections
import enum
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.analysis.validated import assert_held, make_condition, make_lock
from repro_torch.utils import trace

# Per-class rolling window of dispatch/service latencies (bytes/counters are
# exact lifetime totals; latency percentiles come from this recent window).
_LAT_WINDOW = 2048
# Max shared workers a runtime will grow to (the whole point is bounding
# thread sprawl: the old per-engine pools were N_engines x 2, unbounded).
_MAX_WORKERS = 8
# How long an idle worker waits before exiting (no descriptors, no
# background tasks).
_IDLE_TIMEOUT_S = 30.0
# Wait granularity when background tasks are registered: an idle worker
# wakes this often to give the SENSOR-class tasks a slice.
_BG_IDLE_WAIT_S = 1e-3


class PriorityClass(enum.Enum):
    """QoS class of a transfer stream — the IRQ level of its completions."""

    SENSOR = "sensor"  # event/frame ingest (paper's DVS collection)
    TOKEN = "token"    # decode-token RX (latency-critical serving)
    LAYER = "layer"    # layer param TX / fmap RX (streaming inference)
    BULK = "bulk"      # prefetch / checkpoint staging (best-effort)


@dataclass(frozen=True)
class ClassQos:
    """Arbitration parameters of one priority class (renamed from the
    pre-PR-10 ``QosSpec`` — that name now belongs to the per-submission
    context object in :mod:`repro_torch.core.qos`).

    ``weight``: share of dispatch bandwidth under contention (virtual time
    advances by nbytes/weight). ``deadline_s``: target queue wait; a
    descriptor past it is promoted to EDF dispatch."""

    weight: float
    deadline_s: float


DEFAULT_QOS: dict[PriorityClass, ClassQos] = {
    PriorityClass.SENSOR: ClassQos(weight=4.0, deadline_s=5e-3),
    PriorityClass.TOKEN: ClassQos(weight=8.0, deadline_s=1e-3),
    PriorityClass.LAYER: ClassQos(weight=2.0, deadline_s=20e-3),
    PriorityClass.BULK: ClassQos(weight=1.0, deadline_s=100e-3),
}

# The tier-2 flow untagged submissions land in: one shared flow arbitrates
# exactly like the pre-tenancy runtime, so single-tenant processes see
# byte-identical scheduling. Re-exported by ``repro_torch.core.qos``.
DEFAULT_TENANT = "default"

# Per-tenant dispatch-latency window. Deliberately smaller than the class
# window (_LAT_WINDOW): a 1000-tenant serving process keeps 1000 of these.
_TENANT_LAT_WINDOW = 256

@dataclass(frozen=True)
class CoalescePolicy:
    """Completion-vector coalescing parameters of one priority class.

    ``max_batch``: flush the vector once this many completions coalesced
    (``<= 1`` disables coalescing for the class). ``budget_s``: flush no
    later than this long after the first completion entered the vector —
    the hard bound on latency a coalesced completion can be charged."""

    max_batch: int
    budget_s: float


# MSI-X-shaped defaults: latency classes coalesce a completion pair at
# most (protecting p99), throughput classes amortize a whole wave of
# small descriptors into one wakeup.
DEFAULT_COALESCE: dict[PriorityClass, CoalescePolicy] = {
    PriorityClass.SENSOR: CoalescePolicy(max_batch=2, budget_s=100e-6),
    PriorityClass.TOKEN: CoalescePolicy(max_batch=2, budget_s=100e-6),
    PriorityClass.LAYER: CoalescePolicy(max_batch=8, budget_s=1e-3),
    PriorityClass.BULK: CoalescePolicy(max_batch=32, budget_s=2e-3),
}

# Classes served by the reserved dispatch lane (see TransferRuntime): tiny,
# latency-critical descriptors that must never sit behind an in-service
# bulk chunk on every worker at once.
_LATENCY_CLASSES = (PriorityClass.TOKEN, PriorityClass.SENSOR)
# Classes whose descriptors may be submitted as PreemptibleWork (throughput
# traffic that yields to the latency classes mid-chunk).
PREEMPTIBLE_CLASSES = (PriorityClass.LAYER, PriorityClass.BULK)
# The reserved lane stays active this long past the last latency-class
# event (a TOKEN/SENSOR registration or submission). Recency-gated on
# purpose: a serving engine that merely EXISTS but has been idle must not
# halve LAYER/BULK dispatch concurrency forever — the cost is that the
# first token after a quiet period can wait out one in-service bulk chunk
# before the lane re-engages.
_LATENCY_RECENCY_S = 5.0


def _pct(samples: "collections.deque[float] | list[float]", q: float) -> float:
    if not samples:
        return float("nan")
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class TransferFaultError(RuntimeError):
    """A transfer failed in a way the channel layer may RETRY on a sibling
    ring: injected faults, checksum mismatches and descriptor timeouts all
    derive from this. Structural errors (closed engine, bad payload) stay
    plain RuntimeError/ValueError and are never retried."""


class TransferTimeoutError(TransferFaultError):
    """A descriptor (or a ticket waiting on one) blew its deadline — the
    repro of a dropped DMA completion surfacing as an error instead of a
    hang. Raised by ``Ticket.wait(timeout=)`` and by the runtime's
    :meth:`TransferRuntime.scan_timeouts` cancellation path."""


class TransferChecksumError(TransferFaultError):
    """Per-descriptor crc32 verification failed on RX
    (``TransferPolicy.checksum``): the payload landed, but corrupted."""


@dataclass
class TenantStats:
    """Per-tenant (tier-2 flow) accounting inside one priority class.

    Counts/bytes are exact lifetime totals; the dispatch-latency window is
    deliberately small (``_TENANT_LAT_WINDOW``) so a 1000-tenant serving
    process stays cheap. Fault columns mirror the class-level ledger so a
    misbehaving tenant's retries are attributable (PR 10 satellite)."""

    submitted: int = 0
    dispatched: int = 0
    completed: int = 0
    cancelled: int = 0
    bytes_total: int = 0
    cap_deferrals: int = 0
    deadline_misses: int = 0
    timeouts: int = 0
    faults: int = 0
    retries: int = 0
    quarantines: int = 0
    dispatch_lat_s: "collections.deque[float]" = field(
        default_factory=lambda: collections.deque(
            maxlen=_TENANT_LAT_WINDOW))

    def summary(self) -> dict[str, float]:
        return {
            "submitted": self.submitted,
            "dispatched": self.dispatched,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "bytes_total": self.bytes_total,
            "cap_deferrals": self.cap_deferrals,
            "deadline_misses": self.deadline_misses,
            "timeouts": self.timeouts,
            "faults": self.faults,
            "retries": self.retries,
            "quarantines": self.quarantines,
            "dispatch_p50_ms": _pct(self.dispatch_lat_s, 0.5) * 1e3,
            "dispatch_p99_ms": _pct(self.dispatch_lat_s, 0.99) * 1e3,
        }


@dataclass
class ClassStats:
    """Per-class accounting: counts/bytes exact, latencies windowed."""

    submitted: int = 0
    dispatched: int = 0
    completed: int = 0
    cancelled: int = 0
    bytes_total: int = 0
    deadline_promotions: int = 0
    # preemptive chunked dispatch: how often this class's in-service work
    # parked for a latency arrival, and how long the parked work waited
    # before resuming (windowed).
    preemptions: int = 0
    # scheduler passes where this class had queued work but its token
    # bucket was empty (deferred by its bandwidth cap).
    cap_deferrals: int = 0
    # submissions whose EDF deadline was stretched to the cap bucket's
    # drain horizon (cap-aware deadlines: a throttled class must not sit
    # permanently overdue while stage 0 vetoes it).
    cap_deadline_stretches: int = 0
    # fault-handling ledger (PR 6): descriptors cancelled by the timeout
    # scan / ticket deadline, faults observed (injected or organic, incl.
    # checksum mismatches), stripe retries issued by the channel layer,
    # and channels pulled from rotation. Engines and groups report these
    # via note_fault(); serving surfaces read them off class_summary().
    timeouts: int = 0
    faults: int = 0
    retries: int = 0
    quarantines: int = 0
    # dispatches that happened past the descriptor's EDF deadline (the
    # admission controller's class-pressure signal; windowed rate lives
    # in TransferRuntime.deadline_miss_rate).
    deadline_misses: int = 0
    # tier-2 ledger: per-tenant flow accounting inside this class.
    tenants: dict[str, TenantStats] = field(default_factory=dict)
    # completion coalescing ledger: delivery passes actually taken, how
    # many per-completion wakeups the vector saved, and the windowed
    # batch-size / added-latency distributions. An immediate (uncoalesced)
    # delivery counts as one wakeup with batch size 1 and zero delay.
    completion_wakeups: int = 0
    wakeups_saved: int = 0
    coalesce_batch: "collections.deque[int]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))
    coalesce_delay_s: "collections.deque[float]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))
    dispatch_lat_s: "collections.deque[float]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))
    service_lat_s: "collections.deque[float]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))
    preempt_park_s: "collections.deque[float]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))
    # (monotonic stamp, latency) pairs for TIME-bounded consumers (the
    # adaptive crossover); the bare deques above stay count-bounded for
    # the lifetime percentile summaries.
    dispatch_recent: "collections.deque[tuple[float, float]]" = field(
        default_factory=lambda: collections.deque(maxlen=_LAT_WINDOW))

    def tenant(self, tenant: str) -> TenantStats:
        """Get-or-create the tier-2 ledger row for one flow."""
        ts = self.tenants.get(tenant)
        if ts is None:
            ts = self.tenants[tenant] = TenantStats()
        return ts

    def summary(self) -> dict[str, float]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "bytes_total": self.bytes_total,
            "deadline_promotions": self.deadline_promotions,
            "deadline_misses": self.deadline_misses,
            "preemptions": self.preemptions,
            "cap_deferrals": self.cap_deferrals,
            "cap_deadline_stretches": self.cap_deadline_stretches,
            "timeouts": self.timeouts,
            "faults": self.faults,
            "retries": self.retries,
            "quarantines": self.quarantines,
            "completion_wakeups": self.completion_wakeups,
            "wakeups_saved": self.wakeups_saved,
            "coalesce_batch_p50": _pct(self.coalesce_batch, 0.5),
            "coalesce_batch_p99": _pct(self.coalesce_batch, 0.99),
            "coalesce_delay_p50_ms": _pct(self.coalesce_delay_s, 0.5) * 1e3,
            "coalesce_delay_p99_ms": _pct(self.coalesce_delay_s, 0.99) * 1e3,
            "dispatch_p50_ms": _pct(self.dispatch_lat_s, 0.5) * 1e3,
            "dispatch_p99_ms": _pct(self.dispatch_lat_s, 0.99) * 1e3,
            "service_p50_ms": _pct(self.service_lat_s, 0.5) * 1e3,
            "service_p99_ms": _pct(self.service_lat_s, 0.99) * 1e3,
            "preempt_park_p50_ms": _pct(self.preempt_park_s, 0.5) * 1e3,
            "preempt_park_p99_ms": _pct(self.preempt_park_s, 0.99) * 1e3,
        }


class PreemptibleWork:
    """Resumable descriptor body — the unit of preemptive chunked dispatch.

    ``segments`` is a finite iterable of thunks; the runtime runs them in
    order on ONE worker at a time and may park the descriptor between two
    segments when a latency-class descriptor is waiting (see the module
    docstring's chunked-dispatch contract). ``collect(parts)`` folds the
    per-segment results into the descriptor result (default: the raw
    ``parts`` list). ``finalize(err_or_none)`` runs exactly once, outside
    the runtime lock, after the work completes or errors *in service* —
    engines release ring slots and fire master-ticket protocols there. A
    descriptor cancelled while queued/parked gets the submitter's
    ``on_cancel`` instead of ``finalize`` (never both)."""

    __slots__ = ("_segments", "_next", "parts", "collect", "finalize",
                 "segments_run")

    _DONE = object()  # sentinel: no further segment

    def __init__(self, segments, *,
                 collect: Callable[[list], Any] | None = None,
                 finalize: Callable[[BaseException | None], None] | None = None):
        self._segments = iter(segments)
        # one segment of lookahead, so ``exhausted`` is knowable right
        # after the last real segment ran — finished work must not take a
        # pointless park/requeue round-trip (and inflate the preemption
        # ledger) for a yield point with nothing left to yield.
        self._next = next(self._segments, self._DONE)
        self.parts: list = []
        self.collect = collect
        self.finalize = finalize
        self.segments_run = 0

    @property
    def exhausted(self) -> bool:
        return self._next is self._DONE

    def step(self) -> bool:
        """Run the next segment on the caller; True when none remain."""
        if self._next is self._DONE:
            return True
        seg = self._next
        self.parts.append(seg())
        self.segments_run += 1
        self._next = next(self._segments, self._DONE)
        return False

    def result(self) -> Any:
        return self.collect(self.parts) if self.collect else self.parts


class _TokenBucket:
    """Per-class bandwidth-cap accounting (lazily refilled under the
    runtime lock). A dispatch is allowed while the bucket is non-negative
    and *charges* the full descriptor size — one oversized descriptor may
    overshoot its burst, then the class defers until the deficit refills
    (standard token-bucket semantics; big descriptors are never starved
    by a burst smaller than themselves)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_Bps: float, burst_s: float):
        self.rate = float(rate_Bps)
        self.burst = max(self.rate * burst_s, 1.0)
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def _refill(self, now: float) -> None:
        self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now

    def ready(self, now: float) -> bool:
        self._refill(now)
        return self.tokens > 0.0

    def charge(self, nbytes: int) -> None:
        self.tokens -= nbytes

    def delay_s(self, now: float) -> float:
        """Seconds until the bucket turns non-negative again."""
        self._refill(now)
        if self.tokens > 0.0:
            return 0.0
        return -self.tokens / self.rate


class _TenantFlow:
    """Tier-2 flow: one tenant's FIFO inside one class queue, with its own
    WFQ virtual time, weight and (optional) token bucket — the leaf of the
    cap tree. Guarded by the runtime lock like the queue that owns it."""

    __slots__ = ("q", "vtime", "weight", "bucket", "backlog_bytes", "stats")

    def __init__(self, stats: TenantStats):
        self.q: "collections.deque[_Descriptor]" = collections.deque()
        self.vtime = 0.0
        self.weight = 1.0
        self.bucket: _TokenBucket | None = None
        self.backlog_bytes = 0
        self.stats = stats


class _ClassFlowQueue:
    """The tier-2 arbiter of ONE priority class: per-tenant FIFO flows
    under byte-weighted fair queuing, plus a ``parked`` deque where
    preempted (mid-chunk) descriptors resume with absolute precedence —
    the generalization of the plain per-class deque this replaces.

    Selection inside the class (:meth:`head`): parked resumes first, then
    EDF over the overdue tenant heads, then the minimum-vtime tenant —
    the same three-stage shape the runtime applies ACROSS classes, one
    tier down. A tenant whose token bucket is empty is not eligible (its
    head defers, counted per tenant); tenants without a bucket borrow
    whatever headroom the class bucket leaves — the cap tree's borrowing
    rule falls out of checking both buckets independently.

    ``tenant_fair=False`` routes every descriptor through one shared flow
    (strict class FIFO — the single-tier baseline the tenant-isolation
    benchmark compares against). NOT thread-safe on its own: every method
    runs under ``TransferRuntime._cond`` exactly like the deque it
    replaced."""

    __slots__ = ("stats", "flows", "parked", "tenant_fair", "_len",
                 "queued_bytes")

    def __init__(self, stats: ClassStats, tenant_fair: bool = True):
        self.stats = stats
        self.flows: dict[str, _TenantFlow] = {}
        self.parked: "collections.deque[_Descriptor]" = collections.deque()
        self.tenant_fair = tenant_fair
        self._len = 0
        self.queued_bytes = 0

    def __bool__(self) -> bool:
        return self._len > 0

    def __len__(self) -> int:
        return self._len

    def _key(self, d: "_Descriptor") -> str:
        return d.tenant if self.tenant_fair else DEFAULT_TENANT

    def flow(self, tenant: str) -> _TenantFlow:
        f = self.flows.get(tenant)
        if f is None:
            f = self.flows[tenant] = _TenantFlow(self.stats.tenant(tenant))
        return f

    def append(self, d: "_Descriptor") -> None:
        """Enqueue a new arrival on its tenant's flow. An idle flow
        re-enters at the busy flows' vtime floor (same no-burst rule the
        classes follow one tier up)."""
        f = self.flow(self._key(d))
        if not f.q:
            busy = [ff.vtime for ff in self.flows.values() if ff.q]
            if busy:
                f.vtime = max(f.vtime, min(busy))
        if self.tenant_fair:
            f.weight = max(d.weight, 1e-9)  # last submission wins
        f.q.append(d)
        f.backlog_bytes += d.nbytes
        self._len += 1
        self.queued_bytes += d.nbytes

    def appendleft(self, d: "_Descriptor") -> None:
        """Park a preempted resume at the class front (absolute precedence
        over every flow: it holds a ring slot and mid-chunk state, and its
        bytes were already charged at first dispatch)."""
        self.parked.appendleft(d)
        self._len += 1
        self.queued_bytes += d.nbytes

    def head(self, now: float) -> "tuple[_Descriptor | None, float | None]":
        """The class's next dispatchable descriptor under tenant caps,
        plus the earliest tenant-bucket refill delay when one or more
        flows deferred this pass (None, hint) means every queued flow is
        tenant-capped."""
        if self.parked:
            return self.parked[0], None
        hint: float | None = None
        best_overdue: "_Descriptor | None" = None
        best_d: "_Descriptor | None" = None
        best_vt = float("inf")
        for f in self.flows.values():
            if not f.q:
                continue
            d = f.q[0]
            if (not d.started and f.bucket is not None
                    and not f.bucket.ready(now)):
                # tenant bucket empty: this flow defers (cap tree leaf).
                # Parked resumes never reach here (they bypass via the
                # parked deque) and started heads are charge-once exempt.
                f.stats.cap_deferrals += 1
                wait = f.bucket.delay_s(now)
                if hint is None or wait < hint:
                    hint = wait
                continue
            if d.deadline <= now and (best_overdue is None
                                      or d.deadline < best_overdue.deadline):
                best_overdue = d
            if f.vtime < best_vt:
                best_vt = f.vtime
                best_d = d
        return (best_overdue if best_overdue is not None else best_d), hint

    def oldest(self) -> "_Descriptor | None":
        """Oldest submission across flows (the FIFO-baseline pick; flows
        are FIFO so per-flow heads suffice)."""
        best = self.parked[0] if self.parked else None
        for f in self.flows.values():
            if f.q and (best is None or f.q[0].t_submit < best.t_submit):
                best = f.q[0]
        return best

    def pop(self, d: "_Descriptor") -> None:
        """Remove ``d`` — which must be a current head (parked or flow)."""
        if self.parked and self.parked[0] is d:
            self.parked.popleft()
        else:
            f = self.flows[self._key(d)]
            popped = f.q.popleft()
            if popped is not d:  # pragma: no cover — selection bug guard
                f.q.appendleft(popped)
                raise RuntimeError("flow-queue pop of a non-head descriptor")
            f.backlog_bytes -= d.nbytes
        self._len -= 1
        self.queued_bytes -= d.nbytes

    def charge_dispatch(self, d: "_Descriptor") -> None:
        """First-dispatch accounting at the tenant tier: advance the
        flow's virtual time by nbytes/weight and charge its token bucket
        (the class-level twin runs in ``_pick_locked``)."""
        if not self.tenant_fair:
            return
        f = self.flows.get(self._key(d))
        if f is None:
            return
        f.vtime += max(d.nbytes, 1024) / f.weight
        if f.bucket is not None:
            f.bucket.charge(d.nbytes)

    def drain_if(self, pred: "Callable[[_Descriptor], bool]"
                 ) -> "list[_Descriptor]":
        """Remove and return every queued descriptor matching ``pred``
        (timeout scans, handle cancellation) preserving FIFO order of the
        survivors."""
        out: "list[_Descriptor]" = []
        keep: "collections.deque[_Descriptor]" = collections.deque()
        while self.parked:
            d = self.parked.popleft()
            (out if pred(d) else keep).append(d)
        self.parked.extend(keep)
        for f in self.flows.values():
            if not f.q:
                continue
            kept: "collections.deque[_Descriptor]" = collections.deque()
            while f.q:
                d = f.q.popleft()
                if pred(d):
                    out.append(d)
                    f.backlog_bytes -= d.nbytes
                else:
                    kept.append(d)
            f.q.extend(kept)
        for d in out:
            self._len -= 1
            self.queued_bytes -= d.nbytes
        return out

    def depth(self, tenant: str) -> int:
        """Queued-but-undispatched descriptors of one tenant (parked
        resumes already dispatched once and do not count)."""
        f = self.flows.get(tenant)
        return len(f.q) if f is not None else 0

    def tenant_backlog(self, tenant: str) -> int:
        f = self.flows.get(tenant)
        return f.backlog_bytes if f is not None else 0

    def set_cap(self, tenant: str, bytes_per_s: float | None,
                burst_s: float) -> None:
        f = self.flow(tenant)
        if bytes_per_s is None or bytes_per_s <= 0:
            f.bucket = None
        elif f.bucket is None or f.bucket.rate != float(bytes_per_s):
            # unchanged rate keeps the live bucket: QosSpec-carried caps
            # arrive on EVERY submission and must not refill the burst.
            f.bucket = _TokenBucket(bytes_per_s, burst_s)

    def cap(self, tenant: str) -> float | None:
        f = self.flows.get(tenant)
        return f.bucket.rate if f is not None and f.bucket is not None \
            else None


class _Descriptor:
    """One staged completion: the unit the runtime arbitrates."""

    __slots__ = ("fn", "done", "out", "cls", "nbytes", "handle",
                 "t_submit", "deadline", "on_cancel",
                 "started", "service_acc", "t_parked", "preemptions",
                 "units", "tenant", "weight", "tag")

    def __init__(self, fn: Callable[[], Any], cls: PriorityClass,
                 nbytes: int, handle: "RuntimeHandle", deadline_s: float,
                 on_cancel: Callable[[BaseException], None] | None = None,
                 units: int = 1, tenant: str = DEFAULT_TENANT,
                 weight: float = 1.0):
        self.fn = fn
        self.done = trace.Done()
        self.out: list = []
        self.cls = cls
        self.nbytes = max(int(nbytes), 0)
        # logical descriptors carried by this one submission (a tx_many/
        # rx_many group rides one runtime descriptor): dispatch latency is
        # amortized over units when fed to the adaptive crossover.
        self.units = max(int(units), 1)
        # tier-2 flow tag + WFQ weight (QosSpec-carried; see repro_torch.core.qos)
        self.tenant = tenant
        self.weight = max(float(weight), 1e-9)
        self.handle = handle
        self.t_submit = time.monotonic()
        self.deadline = self.t_submit + deadline_s
        # invoked (outside the runtime lock) iff the descriptor is cancelled
        # while still queued: the submitter's own completion protocol (ring
        # slot release, master-ticket error propagation) must run even when
        # ``fn`` never will — a cancelled chunk must not hang its caller.
        self.on_cancel = on_cancel
        # preemptive-chunking state: first-dispatch stats/cap-charges fire
        # once; service time accumulates across park/resume stints.
        self.started = False
        self.service_acc = 0.0
        self.t_parked: float | None = None
        self.preemptions = 0
        # set while a profiler records: the descriptor's trace marks
        # (xfer.queue / service / deliver) and its done event carry it
        self.tag: trace.Tag | None = None


class RuntimeHandle:
    """Per-engine registration — the compat shim for the old per-engine
    completion-pool ``submit`` contract.

    ``submit(fn)`` returns ``(done_event, out_list)`` exactly like the
    retired ``_CompletionPool.submit``, so :class:`~repro_torch.core.transfer.
    Ticket` wraps it unchanged; descriptors are tagged with the engine's
    priority class (overridable per call). ``close()`` drains this
    engine's outstanding descriptors and deregisters, so a closed engine
    can never receive a late completion."""

    def __init__(self, runtime: "TransferRuntime", owner: Any,
                 cls: PriorityClass):
        self.runtime = runtime
        self.owner_repr = repr(owner)[:80]
        self.cls = cls
        self._outstanding = 0
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def submit(self, fn: Callable[[], Any], nbytes: int = 0,
               priority: "PriorityClass | None" = None,
               on_cancel: Callable[[BaseException], None] | None = None,
               units: int = 1, *,
               qos: Any = None) -> tuple[threading.Event, list]:
        # ``qos`` is duck-typed (any object with the QosSpec fields) so the
        # runtime never imports repro_torch.core.qos — qos.py imports us.
        cls = priority
        if cls is None and qos is not None:
            cls = getattr(qos, "priority", None)
        return self.runtime._submit(self, fn, cls or self.cls, nbytes,
                                    on_cancel, units, qos=qos)

    def close(self, timeout: float = 5.0) -> None:
        self.runtime._close_handle(self, timeout)


class TransferRuntime:
    """The shared interrupt controller: one bounded worker pool dispatching
    every registered engine's completions under deadline-aware weighted-fair
    arbitration.

    ``fair=False`` disables arbitration (global FIFO by submit time) — the
    baseline a naive shared pool would be; kept for the QoS benchmark.
    Workers spawn on demand up to ``workers`` and exit after
    ``idle_timeout_s`` without work (engines registering is free; threads
    only exist while traffic flows). Completion callbacks (the ``fn``
    closures) run ON a worker, so — like a real ISR — they must never
    block on another descriptor of this runtime (self-deadlock) and must
    not issue transfers."""

    def __init__(self, workers: int | None = None, *,
                 qos: dict[PriorityClass, ClassQos] | None = None,
                 fair: bool = True,
                 tenant_fair: bool = True,
                 preempt: bool = True,
                 reserve_latency_workers: int = 1,
                 latency_recency_s: float = _LATENCY_RECENCY_S,
                 idle_timeout_s: float = _IDLE_TIMEOUT_S,
                 background_budget_s: float = 50e-6,
                 cap_burst_s: float = 0.05,
                 coalesce: dict[PriorityClass, CoalescePolicy] | None = None):
        if workers is None:
            workers = max(2, min(_MAX_WORKERS, os.cpu_count() or 2))
        self.workers = max(1, int(workers))  # guarded-by: _cond
        self.reserve_latency_workers = max(0, int(reserve_latency_workers))
        self.latency_recency_s = float(latency_recency_s)
        self.qos = dict(DEFAULT_QOS)
        if qos:
            self.qos.update(qos)
        self.fair = fair
        # tier-2 arbitration: per-tenant WFQ inside each class. Off =>
        # strict FIFO within a class (the single-tier PR-9 baseline, kept
        # for the tenant-isolation benchmark).
        self.tenant_fair = tenant_fair
        # honor PreemptibleWork yield points (park bulk work for latency
        # arrivals). Off => segments still run correctly, just back to back
        # — the PR-4 one-chunk-bound baseline, kept for the QoS benchmark.
        self.preempt = preempt
        self.idle_timeout_s = idle_timeout_s
        self.background_budget_s = background_budget_s
        # per-class bandwidth caps (token buckets), set_class_cap-managed.
        self.cap_burst_s = float(cap_burst_s)
        self._cond = make_condition("TransferRuntime._cond")
        self._caps: dict[PriorityClass, _TokenBucket] = {}  # guarded-by: _cond
        # earliest bucket-refill delay observed by the last _pick_locked
        # pass that found only cap-deferred work (None = no cap deferral):
        # workers size their wait on it so capped work is never stranded.
        self._cap_wait_hint: float | None = None            # guarded-by: _cond
        self.stats: dict[PriorityClass, ClassStats] = {
            cls: ClassStats() for cls in PriorityClass}     # guarded-by: _cond
        # tier-2 flow queues: per-tenant WFQ + token buckets inside each
        # class (the plain per-class deques of PR <= 9, generalized).
        self._queues: dict[PriorityClass, _ClassFlowQueue] \
            = {cls: _ClassFlowQueue(self.stats[cls], tenant_fair)
               for cls in PriorityClass}                    # guarded-by: _cond
        # recent (stamp, missed) dispatch outcomes per class — the
        # admission controller's deadline-miss-rate signal.
        self._miss_window: dict[PriorityClass,
                                "collections.deque[tuple[float, int]]"] = {
            cls: collections.deque(maxlen=_LAT_WINDOW)
            for cls in PriorityClass}                       # guarded-by: _cond
        # completion coalescing: per-class vector of finished-but-not-yet-
        # delivered descriptors [(descriptor, t_done)], the wall deadline
        # of the oldest vector entry, the EWMA inter-completion gap (the
        # adaptive "is coalescing worth it" signal) and the stamp of the
        # last completion per class.
        self.coalesce = dict(DEFAULT_COALESCE)              # guarded-by: _cond
        if coalesce:
            self.coalesce.update(coalesce)
        self._vectors: dict[PriorityClass,
                            list[tuple[_Descriptor, float]]] = {
            cls: [] for cls in PriorityClass}               # guarded-by: _cond
        self._vec_deadline: dict[PriorityClass, float] = {
            cls: float("inf") for cls in PriorityClass}     # guarded-by: _cond
        self._coalesce_gap: dict[PriorityClass, float] = {
            cls: float("inf") for cls in PriorityClass}     # guarded-by: _cond
        self._coalesce_last: dict[PriorityClass, float] = {
            cls: float("-inf") for cls in PriorityClass}    # guarded-by: _cond
        # in-service descriptors per class (the pipeline-empty flush test:
        # a completion with no queued AND no in-service siblings must
        # deliver now, not wait out the coalescing budget).
        self._executing_by: dict[PriorityClass, int] = {
            cls: 0 for cls in PriorityClass}                # guarded-by: _cond
        self._vtime: dict[PriorityClass, float] = {
            cls: 0.0 for cls in PriorityClass}              # guarded-by: _cond
        # descriptors currently in service
        self._executing = 0                                 # guarded-by: _cond
        # Reserved-lane activation is RECENCY-gated: the stamp updates on
        # every TOKEN/SENSOR registration or submission, and the lane is
        # active while it is fresher than ``latency_recency_s``. An idle
        # or closed serving engine therefore releases the lane (LAYER/
        # BULK get every worker back) instead of pinning it for life.
        # ``_latency_handles`` counts live latency registrations for
        # introspection/diagnostics.
        self._latency_handles = 0                           # guarded-by: _cond
        self._latency_last_event = float("-inf")            # guarded-by: _cond
        self._alive = 0                                     # guarded-by: _cond
        self._threads: list[threading.Thread] = []          # guarded-by: _cond
        self._closed = False                                # guarded-by: _cond
        # WEAK registry: an engine dropped without close() (allowed before
        # this runtime existed — per-engine pools just idled out) must not
        # pin its handle in the process-global runtime forever. Queued/
        # in-flight descriptors hold the handle strongly, so it lives
        # exactly as long as work for it can still exist.
        self._handles: "weakref.WeakSet[RuntimeHandle]" = \
            weakref.WeakSet()                               # guarded-by: _cond
        self._background: list[Callable[[], None]] = []     # guarded-by: _cond
        self._bg_cursor = 0                                 # guarded-by: _cond
        # single-flight: background tasks keep the cooperative scheduler's
        # single-threaded contract (a sensor_fn must never race itself
        # across two workers)
        self._bg_running = False                            # guarded-by: _cond
        # thread id of the ONE worker polling the background lane at
        # _BG_IDLE_WAIT_S cadence; the rest wait at idle_timeout_s and may
        # idle-exit (no N-worker busy spin)
        self._bg_spinner: int | None = None                 # guarded-by: _cond
        self.dispatches = 0                                 # guarded-by: _cond
        self.background_slices_run = 0                      # guarded-by: _cond
        self.background_errors = 0                          # guarded-by: _cond

    # -- registration --------------------------------------------------------
    def register(self, owner: Any, priority: PriorityClass,
                 workers_hint: int = 0) -> RuntimeHandle:
        """Register an engine (or any completion consumer) at a priority
        class. ``workers_hint`` may grow the shared worker cap (bounded by
        ``_MAX_WORKERS``) — a hint, not a per-engine allocation."""
        h = RuntimeHandle(self, owner, priority)
        with self._cond:
            if self._closed:
                raise RuntimeError("register() on a closed TransferRuntime")
            self._handles.add(h)
            if priority in _LATENCY_CLASSES:
                self._latency_handles += 1
                self._latency_last_event = time.monotonic()  # lane engages
            if workers_hint > 0:
                self.workers = min(_MAX_WORKERS,
                                   max(self.workers, int(workers_hint)))
        return h

    @property
    def n_registered(self) -> int:
        with self._cond:
            return len(self._handles)

    # -- per-class bandwidth caps ---------------------------------------------
    def set_class_cap(self, cls: PriorityClass,
                      bytes_per_s: float | None) -> None:
        """Enforce a bytes/s ceiling on one priority class (the ZynqNet
        per-layer bandwidth budget, as a hard limit instead of a ledger
        entry). ``None`` or ``<= 0`` clears the cap. A capped class whose
        token bucket is empty defers dispatch — even past its deadline —
        and uncapped classes borrow the freed headroom. Takes effect on
        the next dispatch decision; only enforced under ``fair=True``
        (the FIFO baseline models a runtime with no QoS at all)."""
        with self._cond:
            if bytes_per_s is None or bytes_per_s <= 0:
                self._caps.pop(cls, None)
            else:
                self._caps[cls] = _TokenBucket(bytes_per_s, self.cap_burst_s)
            self._cond.notify_all()

    def class_cap(self, cls: PriorityClass) -> float | None:
        """The enforced bytes/s ceiling for ``cls`` (None = uncapped) —
        consumers (the online transfer controller) plan against this
        effective bandwidth instead of chasing the raw link fit."""
        with self._cond:
            b = self._caps.get(cls)
            return b.rate if b is not None else None

    # -- per-tenant caps + admission signals (the cap tree's leaves) ----------
    def set_tenant_cap(self, cls: PriorityClass, tenant: str,
                       bytes_per_s: float | None, *,
                       burst_s: float | None = None) -> None:
        """Bytes/s ceiling on ONE tenant flow inside ``cls`` — a leaf of
        the cap tree. A dispatch must clear BOTH its tenant bucket and the
        class bucket, so the class cap bounds the sum of its tenants'
        effective rates whatever their leaf caps claim; tenants without a
        leaf cap borrow whatever headroom the class bucket leaves.
        ``None`` / ``<= 0`` clears the leaf. Only enforced under
        ``tenant_fair=True`` (the single-tier baseline has no tier 2)."""
        with self._cond:
            self._queues[cls].set_cap(
                tenant, bytes_per_s,
                self.cap_burst_s if burst_s is None else float(burst_s))
            self._cond.notify_all()

    def tenant_cap(self, cls: PriorityClass, tenant: str) -> float | None:
        """The enforced leaf ceiling for ``tenant`` in ``cls`` (None =
        uncapped: bounded only by the class bucket)."""
        with self._cond:
            return self._queues[cls].cap(tenant)

    def tenant_depth(self, cls: PriorityClass, tenant: str) -> int:
        """Queued-but-undispatched descriptors of one tenant — the
        admission controller's per-tenant pressure signal."""
        with self._cond:
            return self._queues[cls].depth(tenant)

    def tenant_queued_bytes(self, cls: PriorityClass, tenant: str) -> int:
        with self._cond:
            return self._queues[cls].tenant_backlog(tenant)

    def deadline_miss_rate(self, cls: PriorityClass,
                           ttl_s: float = 5.0) -> float:
        """Fraction of the class's recent dispatch outcomes (last
        ``ttl_s`` seconds) that ran past their EDF deadline — timeout
        cancellations count as misses. 0.0 with no recent traffic: an
        idle runtime must admit freely."""
        with self._cond:
            return self._miss_rate_locked(cls, ttl_s)

    def _miss_rate_locked(self, cls: PriorityClass,  # requires-lock: _cond
                          ttl_s: float = 5.0) -> float:
        assert_held(self._cond, "_miss_rate_locked")
        cutoff = time.monotonic() - ttl_s
        recent = [m for t, m in self._miss_window[cls] if t >= cutoff]
        if not recent:
            return 0.0
        return sum(recent) / len(recent)

    # -- completion coalescing -----------------------------------------------
    def set_coalesce(self, cls: PriorityClass,
                     policy: CoalescePolicy | None) -> None:
        """Set (or clear, with ``None`` / ``max_batch <= 1``) the
        completion-vector policy of one class. Takes effect on the next
        completion; anything already coalesced in the class vector is
        delivered immediately so a policy change never strands a ticket."""
        drained: list[tuple[PriorityClass, list]] = []
        with self._cond:
            if policy is None or policy.max_batch <= 1:
                self.coalesce.pop(cls, None)
            else:
                self.coalesce[cls] = policy
            vec = self._vectors[cls]
            if vec:
                self._vectors[cls] = []
                drained.append((cls, vec))
            self._cond.notify_all()
        for batch in drained:
            self._deliver(batch)

    def register_background(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Register a recurring SENSOR-style background task: workers give
        it budgeted slices between completion dispatches (and while idle) —
        the paper's concurrent collection+transfer scenario. Returns an
        unregister callable."""
        with self._cond:
            if self._closed:
                raise RuntimeError(
                    "register_background() on a closed TransferRuntime")
            self._background.append(fn)
            if self._alive == 0:
                # no transfer traffic yet: collection must still run
                t = threading.Thread(target=self._run, daemon=True)
                t.start()
                self._threads.append(t)
                self._alive += 1
            self._cond.notify_all()

        def unregister() -> None:
            with self._cond:
                try:
                    self._background.remove(fn)
                except ValueError:
                    pass
        return unregister

    # -- submission ----------------------------------------------------------
    def _submit(self, handle: RuntimeHandle, fn: Callable[[], Any],
                cls: PriorityClass, nbytes: int,
                on_cancel: Callable[[BaseException], None] | None = None,
                units: int = 1, qos: Any = None) -> tuple[threading.Event, list]:
        spec = self.qos[cls]
        # QosSpec-carried per-submission context (duck-typed; None fields
        # fall back to class defaults — see repro_torch.core.qos).
        tenant = DEFAULT_TENANT
        weight = 1.0
        deadline_s = spec.deadline_s
        t_cap = t_burst = None
        if qos is not None:
            tenant = getattr(qos, "tenant", None) or DEFAULT_TENANT
            weight = getattr(qos, "weight", None) or 1.0
            deadline_s = getattr(qos, "deadline_s", None) or spec.deadline_s
            t_cap = getattr(qos, "cap_bytes_per_s", None)
            t_burst = getattr(qos, "burst_s", None)
        d = _Descriptor(fn, cls, nbytes, handle, deadline_s, on_cancel,
                        units, tenant=tenant, weight=weight)
        if trace.enabled():
            d.tag = d.done.tag = trace.tag(cls=cls.value,
                                           management="interrupt",
                                           bytes=d.nbytes)
        with self._cond:
            if self._closed:
                raise RuntimeError("submit() on a closed TransferRuntime")
            if handle._closed:
                raise RuntimeError(
                    f"submit() on a closed runtime handle ({handle.owner_repr})")
            q = self._queues[cls]
            if t_cap is not None:
                # QosSpec-carried leaf cap: installs (or updates) the
                # tenant's bucket; an unchanged rate keeps the live bucket
                # so per-submission specs never refill the burst.
                q.set_cap(tenant, t_cap,
                          self.cap_burst_s if t_burst is None
                          else float(t_burst))
            if cls in _LATENCY_CLASSES:
                self._latency_last_event = time.monotonic()
            if not q:
                # idle class re-enters at the busy floor: it must compete
                # fairly NOW, not burst on virtual time it never spent.
                busy = [self._vtime[c] for c, qq in self._queues.items() if qq]
                if busy:
                    self._vtime[cls] = max(self._vtime[cls], min(busy))
            if not self.fair:
                d.deadline = float("inf")  # FIFO baseline: no promotion
            else:
                # cap-aware EDF: a throttled class's (or tenant's) dispatch
                # horizon is set by its token-bucket refill rate, not the
                # QoS spec. Stretch the deadline past the time the bucket
                # needs to drain the queued backlog plus this descriptor,
                # so a hard-capped flow does not go permanently overdue —
                # stage 0 (or the tier-2 head check) would veto every EDF
                # pick anyway, and the class_summary() ledger would report
                # promotions that never dispatch. The stretch takes the
                # SLOWER of the class and tenant drain horizons (the cap
                # tree's binding constraint).
                cap_now = time.monotonic()
                drain_s = 0.0
                bucket = self._caps.get(cls)
                if bucket is not None:
                    drain_s = (bucket.delay_s(cap_now)
                               + (q.queued_bytes + d.nbytes) / bucket.rate)
                if self.tenant_fair:
                    fl = q.flows.get(tenant)
                    if fl is not None and fl.bucket is not None:
                        t_drain = (fl.bucket.delay_s(cap_now)
                                   + (fl.backlog_bytes + d.nbytes)
                                   / fl.bucket.rate)
                        drain_s = max(drain_s, t_drain)
                if drain_s > 0.0:
                    capped_deadline = cap_now + drain_s + spec.deadline_s
                    if capped_deadline > d.deadline:
                        d.deadline = capped_deadline
                        self.stats[cls].cap_deadline_stretches += 1
            q.append(d)
            handle._outstanding += 1
            st = self.stats[cls]
            st.submitted += 1
            st.bytes_total += d.nbytes
            ts = st.tenant(tenant)
            ts.submitted += 1
            ts.bytes_total += d.nbytes
            while self._alive < self.workers:
                t = threading.Thread(target=self._run, daemon=True)
                t.start()
                self._threads.append(t)
                self._alive += 1
            self._threads = [t for t in self._threads if t.is_alive()]
            self._cond.notify()
        return d.done, d.out

    # -- arbitration ---------------------------------------------------------
    def _pick_locked(self) -> _Descriptor | None:  # requires-lock: _cond
        """Choose the next descriptor. Caller holds ``_cond``."""
        assert_held(self._cond, "_pick_locked")
        now = time.monotonic()
        self._cap_wait_hint = None
        if not self.fair:
            # FIFO baseline: oldest submit across every class (and across
            # every tenant flow inside each class — oldest() scans flow
            # heads, so the baseline ignores both arbitration tiers).
            d = None
            for q in self._queues.values():
                head = q.oldest()
                if head is not None and (d is None
                                         or head.t_submit < d.t_submit):
                    d = head
            if d is None:
                return None
            self._queues[d.cls].pop(d)
        else:
            # tier 2 first: each class nominates ONE candidate head.
            # Inside head(): parked resumes outrank everything (charge-
            # once, they hold in-service state), then EDF over overdue
            # tenant heads, then the min-vtime tenant flow; a tenant whose
            # token bucket is dry is skipped with its deferral counted and
            # the earliest refill folded into the wait hint.
            heads: dict[PriorityClass, _Descriptor] = {}
            for cls, q in self._queues.items():
                if not q:
                    continue
                cand, hint = q.head(now)
                if hint is not None and (self._cap_wait_hint is None
                                         or hint < self._cap_wait_hint):
                    self._cap_wait_hint = hint
                if cand is not None:
                    heads[cls] = cand
            # 0) bandwidth caps, class tier: a class whose candidate needs
            # a first dispatch but whose token bucket is empty is not
            # eligible at ANY level below (EDF must not override a cap —
            # the ceiling is hard). Record the earliest refill so a worker
            # finding only capped work parks on a timed wait instead of
            # idle-exiting. A PARKED resume is exempt: its bytes were
            # charged at first dispatch (charge-once), it holds a ring
            # slot and mid-chunk iterator state — re-gating it on the
            # deficit it itself created would stall an in-service
            # descriptor for the whole refill.
            for cls in list(heads):
                bucket = self._caps.get(cls)
                if (bucket is not None and not heads[cls].started
                        and not bucket.ready(now)):
                    del heads[cls]
                    self.stats[cls].cap_deferrals += 1
                    wait = bucket.delay_s(now)
                    if (self._cap_wait_hint is None
                            or wait < self._cap_wait_hint):
                        self._cap_wait_hint = wait
            # 1) reserved latency lane: dispatch is non-preemptive, so while
            # a TOKEN/SENSOR source exists, the last worker slot(s) refuse
            # LAYER/BULK — a token must never find every worker mid-bulk-
            # memcpy. An in-service worker always frees eventually, so the
            # deferred bulk head is re-picked on its completion notify
            # (bulk is serialized to workers-reserve while the lane is
            # active, never starved). Recency-gated: the lane releases
            # once latency-class traffic has been quiet for
            # ``latency_recency_s``, even if an idle serving engine is
            # still registered.
            reserve = min(self.reserve_latency_workers, self.workers - 1)
            lane_active = (
                now - self._latency_last_event < self.latency_recency_s)
            latency_only = (lane_active and reserve > 0
                            and self._executing >= self.workers - reserve)
            if latency_only:
                heads = {c: h for c, h in heads.items()
                         if c in _LATENCY_CLASSES}
            # 2) deadline promotion: EDF over overdue candidate heads.
            # Absolute deadlines make this starvation-free (old BULK
            # eventually outranks fresh TOKEN).
            d = None
            for cand in heads.values():
                if cand.deadline <= now and (d is None
                                             or cand.deadline < d.deadline):
                    d = cand
            if d is not None:
                self.stats[d.cls].deadline_promotions += 1
            else:
                # 3) weighted fair: busy class with the smallest vtime.
                if not heads:
                    return None
                d = heads[min(heads, key=lambda c: self._vtime[c])]
            self._queues[d.cls].pop(d)
        st = self.stats[d.cls]
        if not d.started:
            # first dispatch: charge fair-queue virtual time and the cap
            # buckets ONCE for the whole descriptor (a parked resume is
            # not a new arrival) at BOTH tiers — class vtime/bucket here,
            # tenant vtime/bucket via charge_dispatch — and stamp the
            # queue-wait latency into both ledgers.
            d.started = True
            if self.fair:
                self._vtime[d.cls] += (
                    max(d.nbytes, 1024) / self.qos[d.cls].weight)
                bucket = self._caps.get(d.cls)
                if bucket is not None:
                    bucket.charge(d.nbytes)
                self._queues[d.cls].charge_dispatch(d)
            st.dispatched += 1
            st.dispatch_lat_s.append(now - d.t_submit)
            if d.tag is not None:
                d.tag.mark("xfer.queue", trace.mono_ns(d.t_submit),
                           trace.mono_ns(now))
            ts = st.tenant(d.tenant)
            ts.dispatched += 1
            ts.dispatch_lat_s.append(now - d.t_submit)
            missed = int(d.deadline <= now)
            self._miss_window[d.cls].append((now, missed))
            if missed:
                st.deadline_misses += 1
                ts.deadline_misses += 1
            # dispatch_recent feeds the adaptive crossover's effective t0:
            # a batched group (units > 1) pays ONE queue wait for its whole
            # set of logical descriptors, so the per-descriptor price the
            # cost model should see is amortized. dispatch_lat_s above
            # stays raw wall-clock for the p99 summaries.
            st.dispatch_recent.append(
                (now, (now - d.t_submit) / d.units))
            self.dispatches += 1
        elif d.t_parked is not None:
            # resuming preempted work: record how long it sat parked.
            st.preempt_park_s.append(now - d.t_parked)
            d.t_parked = None
        self._executing += 1
        self._executing_by[d.cls] += 1
        return d

    # -- the event loop ------------------------------------------------------
    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException:
            # a KeyboardInterrupt/SystemExit escaping a task must not
            # strand the worker accounting (submit would never respawn)
            with self._cond:
                if self._bg_spinner == threading.get_ident():
                    self._bg_spinner = None
                self._alive -= 1
            raise

    def _run_loop(self) -> None:
        me = threading.get_ident()
        while True:
            bg_fn = None
            stay = False
            with self._cond:
                due = self._drain_due_locked()
                d = self._pick_locked()
                is_spinner = False
                if d is None and not due and not self._closed:
                    # exactly ONE worker polls the background lane at the
                    # fast cadence; the rest wait at idle_timeout_s and
                    # may idle-exit — N workers must not busy-wake every
                    # millisecond for a lane only one of them can claim.
                    is_spinner = bool(self._background) and (
                        self._bg_spinner is None or self._bg_spinner == me)
                    if is_spinner:
                        self._bg_spinner = me
                    timeout = (_BG_IDLE_WAIT_S if is_spinner
                               else self.idle_timeout_s)
                    if self._cap_wait_hint is not None:
                        # only cap-deferred work is queued: park exactly
                        # until the earliest bucket refill, then re-pick.
                        timeout = min(timeout,
                                      max(self._cap_wait_hint, 1e-4))
                    vec_hint = self._vector_wait_hint_locked()
                    if vec_hint is not None:
                        # coalesced completions pending: wake at the
                        # earliest vector budget deadline, never later.
                        timeout = min(timeout, max(vec_hint, 1e-4))
                    self._cond.wait(timeout)
                    due = self._drain_due_locked()
                    d = self._pick_locked()
                if d is None and not due:
                    if not self._closed and (
                            any(self._queues.values())
                            or any(self._vectors.values())):
                        # queued work exists but is deferred (cap bucket
                        # refilling / reserved lane), or a completion
                        # vector is still filling: this worker must NOT
                        # idle-exit — with a cap, no completion notify may
                        # ever come to wake a respawned worker.
                        stay = True
                    elif (self._closed or not self._background
                            or not is_spinner):
                        # provably idle under the lock (submit enqueues
                        # under the same lock): safe to exit.
                        if self._bg_spinner == me:
                            self._bg_spinner = None
                        self._alive -= 1
                        return
                    else:
                        bg_fn = self._next_background_locked()
            for b in due:
                self._deliver(b)
            if d is not None:
                if not self._execute(d):
                    continue  # parked mid-chunk: it resumes via the queue
                self._bg_slice_after_dispatch()
            elif bg_fn is not None:
                self._run_background(bg_fn)
            elif stay:
                continue

    def _park_locked_check(self, d: _Descriptor, t_stint: float) -> bool:
        """Between two segments of a PreemptibleWork: park ``d`` iff a
        latency-class descriptor is waiting and no idle worker can take it.
        Returns True when parked (the caller must NOT complete the
        descriptor — it re-dispatches from the front of its class queue)."""
        if (not self.preempt or not self.fair
                or d.cls in _LATENCY_CLASSES):
            return False
        with self._cond:
            if self._executing < self._alive:
                # an idle worker exists; it will take the latency arrival
                # — parking here would only add a resume round-trip.
                return False
            if not any(self._queues[c] for c in _LATENCY_CLASSES):
                return False
            d.service_acc += time.perf_counter() - t_stint
            d.preemptions += 1
            d.t_parked = time.monotonic()
            # renewed deadline: EDF must see the park as a fresh arrival,
            # or the long-overdue bulk head would immediately outrank the
            # very token it just yielded to. Starvation-free regardless —
            # parked work runs at least one segment between parks.
            d.deadline = d.t_parked + self.qos[d.cls].deadline_s
            self._queues[d.cls].appendleft(d)
            self.stats[d.cls].preemptions += 1
            self._executing -= 1
            self._executing_by[d.cls] -= 1
            self._cond.notify()
            return True

    def _execute(self, d: _Descriptor) -> bool:
        """Run a descriptor body (possibly one stint of a PreemptibleWork).
        Returns False when the work parked mid-chunk (not complete)."""
        work = d.fn if isinstance(d.fn, PreemptibleWork) else None
        result: Any = None
        err: BaseException | None = None
        t0 = time.perf_counter()
        if work is None:
            try:
                result = d.fn()
            except BaseException as e:  # surfaced at Ticket.wait()
                err = e
        else:
            while True:
                try:
                    if work.step():
                        result = work.result()
                        break
                except BaseException as e:  # surfaced at Ticket.wait()
                    err = e
                    break
                if not work.exhausted and self._park_locked_check(d, t0):
                    return False
        t1 = time.perf_counter()
        d.service_acc += t1 - t0
        if d.tag is not None:  # the last stint of a parked descriptor
            d.tag.mark("xfer.service", trace.perf_ns(t0), trace.perf_ns(t1))
        if work is not None and work.finalize is not None:
            try:
                work.finalize(err)
            except BaseException as e:  # noqa: BLE001
                if err is None:
                    err = e
        d.out.append(err if err is not None else result)
        # hand the completion to the per-class vector: it either flushes a
        # batch now (immediate / max_batch / pipeline-empty / error) or
        # parks the descriptor until the budget deadline. _executing drops
        # here regardless — the WORKER is free even when the runtime-level
        # (stats, done-event, outstanding) handoff is deferred. Due
        # vectors of OTHER classes ride the same lock acquisition so a
        # fully-busy pool still bounds their staleness.
        with self._cond:
            self._executing -= 1
            self._executing_by[d.cls] -= 1
            batch = self._vector_add_locked(d, err)
            due = self._drain_due_locked()
            if any(self._queues.values()):
                # a worker slot just freed: a head deferred by the reserved
                # latency lane (or parked waiters) must be re-examined NOW
                self._cond.notify()
        self._deliver(batch)
        for b in due:
            self._deliver(b)
        return True

    # -- completion vectors (MSI-X-style coalescing) --------------------------
    # requires-lock: _cond
    def _vector_add_locked(self, d: _Descriptor,
                           err: BaseException | None
                           ) -> tuple[PriorityClass, list] | None:
        """Fold a finished descriptor into its class completion vector.
        Returns a batch ``(cls, [(descriptor, t_done), ...])`` the CALLER
        must hand to :meth:`_deliver` after releasing the lock, or None
        when the completion coalesced (a later flush delivers it)."""
        assert_held(self._cond, "_vector_add_locked")
        now = time.monotonic()
        # EWMA of the inter-completion gap — the adaptive signal: when
        # completions arrive slower than the coalescing budget, batching
        # can never fill a vector in time and would only add latency.
        gap = now - self._coalesce_last[d.cls]
        self._coalesce_last[d.cls] = now
        prev = self._coalesce_gap[d.cls]
        self._coalesce_gap[d.cls] = (
            gap if prev == float("inf") else 0.75 * prev + 0.25 * gap)
        vec = self._vectors[d.cls]
        entry = (d, now)
        pol = self.coalesce.get(d.cls)
        if (pol is None or pol.max_batch <= 1 or err is not None
                or self._closed or d.handle._closed):
            # immediate delivery — an error (or teardown) also flushes the
            # whole vector so completion order within the class holds.
            if vec:
                self._vectors[d.cls] = []
                return (d.cls, vec + [entry])
            return (d.cls, [entry])
        if not vec and self._coalesce_gap[d.cls] > pol.budget_s:
            return (d.cls, [entry])  # sparse arrivals: don't coalesce
        vec.append(entry)
        if len(vec) == 1:
            self._vec_deadline[d.cls] = now + pol.budget_s
        if (len(vec) >= pol.max_batch
                or (not self._queues[d.cls]
                    and self._executing_by[d.cls] == 0)):
            # full vector — or the class pipeline just drained: the wave
            # is over, a synchronous waiter must not eat the budget timer.
            self._vectors[d.cls] = []
            return (d.cls, vec)
        return None

    def _drain_due_locked(self) -> list[tuple[PriorityClass, list]]:  # requires-lock: _cond
        """Pop every class vector whose budget deadline has passed; the
        caller delivers them outside the lock."""
        assert_held(self._cond, "_drain_due_locked")
        now = time.monotonic()
        batches = []
        for cls, vec in self._vectors.items():
            if vec and now >= self._vec_deadline[cls]:
                self._vectors[cls] = []
                batches.append((cls, vec))
        return batches

    def _drain_all_locked(self) -> list[tuple[PriorityClass, list]]:  # requires-lock: _cond
        """Pop every non-empty class vector regardless of deadline (early
        delivery is always safe); used by teardown and timeout escalation."""
        assert_held(self._cond, "_drain_all_locked")
        batches = []
        for cls, vec in self._vectors.items():
            if vec:
                self._vectors[cls] = []
                batches.append((cls, vec))
        return batches

    def _vector_wait_hint_locked(self) -> float | None:  # requires-lock: _cond
        """Seconds until the earliest pending vector deadline (None when
        every vector is empty) — idle workers clamp their wait on it so a
        coalesced completion is never stranded past its budget."""
        assert_held(self._cond, "_vector_wait_hint_locked")
        now = time.monotonic()
        hint = None
        for cls, vec in self._vectors.items():
            if vec:
                wait = self._vec_deadline[cls] - now
                if hint is None or wait < hint:
                    hint = wait
        return hint

    def _deliver(self, batch: tuple[PriorityClass, list] | None) -> None:
        """Complete one coalesced batch — ONE wakeup's worth of handoffs.
        Preserves :meth:`_execute`'s load-bearing three-step ordering,
        batched:
        1. completion stats BEFORE the done events — a caller unblocked
           by wait() must see its own completion in class_summary();
        2. the done events, in completion order — tickets resolve;
        3. outstanding AFTER done — a close() drain observing
           outstanding == 0 may then rely on every ticket being set."""
        if not batch:
            return
        cls, entries = batch
        t_flush = time.monotonic()
        with self._cond:
            st = self.stats[cls]
            st.completion_wakeups += 1
            st.wakeups_saved += len(entries) - 1
            st.coalesce_batch.append(len(entries))
            for d, t_done in entries:
                st.completed += 1
                st.tenant(d.tenant).completed += 1
                st.service_lat_s.append(d.service_acc)
                st.coalesce_delay_s.append(t_flush - t_done)
        for d, _ in entries:
            d.done.set()
        for d, t_done in entries:
            if d.tag is not None and d.done.t_set_ns:
                d.tag.mark("xfer.deliver", trace.mono_ns(t_done),
                           d.done.t_set_ns)
        with self._cond:
            for d, _ in entries:
                d.handle._outstanding -= 1
            if any(self._queues.values()):
                self._cond.notify()
            for d, _ in entries:
                if d.handle._closed and d.handle._outstanding <= 0:
                    self._cond.notify_all()
                    break
        return

    # -- background (SENSOR ingest) ------------------------------------------
    def _next_background_locked(self) -> Callable[[], None] | None:  # requires-lock: _cond
        """Claim the background lane (single-flight). Caller must run the
        returned fn via :meth:`_run_background`, which releases the lane —
        two workers must never run background tasks concurrently (they
        were written for the cooperative scheduler's single-threaded
        model)."""
        assert_held(self._cond, "_next_background_locked")
        if not self._background or self._bg_running:
            return None
        self._bg_running = True
        fn = self._background[self._bg_cursor % len(self._background)]
        self._bg_cursor += 1
        return fn

    def _run_background(self, fn: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        try:
            while True:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — KeyboardInterrupt and
                    # SystemExit propagate (the worker re-raises after
                    # fixing its accounting); a sensor that raises is
                    # deregistered so it cannot spin the worker with
                    # errors, counted in ``background_errors``.
                    with self._cond:
                        self.background_errors += 1
                        try:
                            self._background.remove(fn)
                        except ValueError:
                            pass
                    return
                with self._cond:
                    self.background_slices_run += 1
                if time.perf_counter() - t0 >= self.background_budget_s:
                    return
        finally:
            with self._cond:
                self._bg_running = False

    def _bg_slice_after_dispatch(self) -> None:
        """Mirror the cooperative scheduler's 'between DMA chunks' slice in
        interrupt mode: collection keeps running under transfer load."""
        with self._cond:
            fn = self._next_background_locked()
        if fn is not None:
            self._run_background(fn)

    # -- fault handling ------------------------------------------------------
    def note_fault(self, cls: PriorityClass, *, tenant: str | None = None,
                   faults: int = 0, retries: int = 0, timeouts: int = 0,
                   quarantines: int = 0) -> None:
        """Fold fault-layer events observed OUTSIDE the runtime (engine
        checksum failures, channel-group stripe retries, quarantines) into
        the per-class ledger — and, when ``tenant`` is given, the
        per-tenant one — so ``class_summary()`` is the one place a serving
        stack reads deadline-miss and retry rates from."""
        with self._cond:
            st = self.stats[cls]
            st.faults += faults
            st.retries += retries
            st.timeouts += timeouts
            st.quarantines += quarantines
            if tenant is not None:
                ts = st.tenant(tenant)
                ts.faults += faults
                ts.retries += retries
                ts.timeouts += timeouts
                ts.quarantines += quarantines

    def scan_timeouts(self, max_age_s: float) -> int:
        """Cancel every still-QUEUED descriptor older than ``max_age_s``,
        completing it with :class:`TransferTimeoutError` — the runtime-level
        escalation behind ``Ticket.wait(timeout=)``: a dropped completion
        becomes an error the caller can retry instead of a hang.

        Only descriptors that never started are cancellable (dispatch is
        non-preemptive, and a parked PreemptibleWork holds mid-chunk
        iterator state plus a ring slot charged at first dispatch — killing
        it here would double-release). An in-service descriptor that never
        returns is the one failure this scan cannot unstick; the injector
        never models it as unbounded for exactly that reason. Returns the
        number of descriptors timed out."""
        timed_out: list[_Descriptor] = []
        now = time.monotonic()
        with self._cond:
            # escalation implies a waiter is already past its patience:
            # flush every completion vector early (always safe) so a
            # coalesced-but-undelivered completion is never mistaken for
            # a dropped one.
            pending = self._drain_all_locked()
            for cls, q in self._queues.items():
                stale = q.drain_if(
                    lambda d: not d.started and now - d.t_submit > max_age_s)
                for d in stale:
                    d.handle._outstanding -= 1
                    st = self.stats[cls]
                    st.cancelled += 1
                    st.timeouts += 1
                    ts = st.tenant(d.tenant)
                    ts.cancelled += 1
                    ts.timeouts += 1
                    # a timed-out descriptor missed its deadline by
                    # definition: feed the admission controller's window.
                    self._miss_window[cls].append((now, 1))
                timed_out.extend(stale)
            if timed_out:
                self._cond.notify_all()
        for b in pending:
            self._deliver(b)
        # outside the lock: done.set + on_cancel run submitter-side protocol
        # (ring slot release, master-ticket errors) that takes engine locks.
        for d in timed_out:
            err = TransferTimeoutError(
                f"descriptor ({d.cls.value}, {d.nbytes} B) queued "
                f"{now - d.t_submit:.3f}s > {max_age_s:.3f}s — completion "
                "presumed dropped")
            d.out.append(err)
            d.done.set()
            if d.on_cancel is not None:
                try:
                    d.on_cancel(err)
                except BaseException:
                    pass  # the error already reached the out list
        return len(timed_out)

    # -- teardown ------------------------------------------------------------
    # requires-lock: _cond
    def _cancel_handle_locked(self, handle: RuntimeHandle
                              ) -> list[_Descriptor]:
        """Pull a handle's still-queued descriptors off the queues, flag
        them failed, and return them; the CALLER must finish them with
        :meth:`_finish_cancelled` after releasing the lock (on_cancel runs
        submitter-side completion protocol — ring slot release, master
        ticket errors — that may take engine locks)."""
        assert_held(self._cond, "_cancel_handle_locked")
        cancelled: list[_Descriptor] = []
        for cls, q in self._queues.items():
            mine = q.drain_if(lambda d: d.handle is handle)
            for d in mine:
                handle._outstanding -= 1
                self.stats[cls].cancelled += 1
                self.stats[cls].tenant(d.tenant).cancelled += 1
            cancelled.extend(mine)
        return cancelled

    @staticmethod
    def _finish_cancelled(cancelled: list[_Descriptor]) -> None:
        """Complete cancelled descriptors caller-side: error the (done,
        out) pair AND run on_cancel so every ticket issued against them
        resolves and no ring slot is orphaned. Lock NOT held."""
        for d in cancelled:
            err = RuntimeError(
                "transfer cancelled: engine closed while descriptor was "
                "queued")
            d.out.append(err)
            d.done.set()
            if d.on_cancel is not None:
                try:
                    d.on_cancel(err)
                except BaseException:
                    pass  # teardown path: the error already reached the out

    def _close_handle(self, handle: RuntimeHandle, timeout: float) -> None:
        """Drain-and-deregister: wait out the engine's queued + in-flight
        descriptors (so every issued ticket completes), cancel stragglers
        past ``timeout``, then forget the handle. Idempotent. Must be
        called from a submitter thread, never from a completion worker."""
        deadline = time.monotonic() + timeout
        cancelled: list[_Descriptor] = []
        with self._cond:
            if handle._closed and handle not in self._handles:
                return
            handle._closed = True
            # flush every coalescing vector before draining: a completion
            # parked in a vector holds _outstanding up, and the drain wait
            # below must converge on real in-flight work only.
            pending = self._drain_all_locked()
        for b in pending:
            self._deliver(b)
        with self._cond:
            while handle._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.1))
            if handle._outstanding > 0:
                cancelled = self._cancel_handle_locked(handle)
            # in-service descriptors (not cancellable) get a short grace
            grace = time.monotonic() + 1.0
            while handle._outstanding > 0 and time.monotonic() < grace:
                self._cond.wait(0.05)
            self._handles.discard(handle)
            if handle.cls in _LATENCY_CLASSES:
                self._latency_handles = max(0, self._latency_handles - 1)
        self._finish_cancelled(cancelled)

    def close(self, timeout: float = 5.0) -> None:
        """Drain everything and join the workers (process-exit hygiene: a
        worker dying mid-CUDA-call during interpreter teardown aborts from
        the C++ side). Idempotent."""
        cancelled: list[_Descriptor] = []
        with self._cond:
            if self._closed:
                return
            self._closed = True
            pending = self._drain_all_locked()
            for h in list(self._handles):
                h._closed = True
                cancelled.extend(self._cancel_handle_locked(h))
            self._handles.clear()
            self._latency_handles = 0
            self._background.clear()
            threads = list(self._threads)
            self._cond.notify_all()
        for b in pending:
            self._deliver(b)
        self._finish_cancelled(cancelled)
        for t in threads:
            t.join(timeout=timeout)

    def __enter__(self) -> "TransferRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting -----------------------------------------------------------
    def class_summary(self) -> dict[str, dict[str, float]]:
        """Per-class bandwidth/latency accounting (the ZynqNet per-class
        traffic ledger, including cap enforcement + preemption columns)."""
        with self._cond:
            out = {}
            for cls, st in self.stats.items():
                if not st.submitted:
                    continue
                row = st.summary()
                bucket = self._caps.get(cls)
                row["cap_bytes_per_s"] = (bucket.rate if bucket is not None
                                          else None)
                pol = self.coalesce.get(cls)
                row["coalesce_max_batch"] = (pol.max_batch
                                             if pol is not None else 1)
                row["deadline_miss_rate"] = self._miss_rate_locked(cls)
                q = self._queues[cls]
                tenants = {}
                for tenant, ts in st.tenants.items():
                    if not (ts.submitted or ts.faults or ts.retries):
                        continue
                    trow = ts.summary()
                    trow["queued"] = q.depth(tenant)
                    trow["cap_bytes_per_s"] = q.cap(tenant)
                    tenants[tenant] = trow
                row["tenants"] = tenants
                out[cls.value] = row
            return out

    def recent_dispatch_latency(self, cls: PriorityClass, q: float = 0.5,
                                ttl_s: float = 10.0) -> float | None:
        """Dispatch-latency percentile over the last ``ttl_s`` seconds for
        one class — the queue wait the online controller folds into the
        interrupt driver's effective t0 when re-deciding the polling
        crossover. Time-bounded on purpose: a burst from minutes ago must
        not keep inflating the crossover after the contention ended
        (``None`` means "no recent traffic" and the consumer decays)."""
        cutoff = time.monotonic() - ttl_s
        with self._cond:
            samples = [lat for t, lat in self.stats[cls].dispatch_recent
                       if t >= cutoff]
        if not samples:
            return None
        return _pct(samples, q)


# ---------------------------------------------------------------------------
# Process-wide default runtime
# ---------------------------------------------------------------------------

_global_lock = make_lock("runtime._global_lock")
_global_runtime: TransferRuntime | None = None


def _shutdown_global() -> None:
    global _global_runtime
    with _global_lock:
        rt, _global_runtime = _global_runtime, None
    if rt is not None:
        rt.close()


def get_runtime() -> TransferRuntime:
    """The process-shared TransferRuntime every kernel-mode engine joins by
    default. Created lazily; joined at interpreter exit."""
    global _global_runtime
    with _global_lock:
        if _global_runtime is None or _global_runtime._closed:
            _global_runtime = TransferRuntime()
            atexit.register(_shutdown_global)
        return _global_runtime


def set_runtime(runtime: TransferRuntime | None) -> TransferRuntime | None:
    """Swap the process-default runtime (tests/benchmarks); returns the
    previous one (NOT closed — caller owns both)."""
    global _global_runtime
    with _global_lock:
        prev, _global_runtime = _global_runtime, runtime
        return prev


# ---------------------------------------------------------------------------
# User-level backends of the same submit contract
# ---------------------------------------------------------------------------

@dataclass
class SchedulerStats:
    transfer_tasks_run: int = 0
    background_slices_run: int = 0
    drain_calls: int = 0
    total_background_s: float = 0.0


class CooperativeScheduler:
    """The paper's 'user-level scheduled' driver (re-homed from
    ``repro_torch.core.scheduler``): a plain round-robin cooperative scheduler.
    ``submit`` enqueues a transfer task, ``register_background`` adds a
    recurring task given a slice between transfer tasks, ``drain`` runs
    until the transfer queue is empty. Single-threaded by design — the
    point of this mode is avoiding threads/interrupts while still not
    monopolising the CPU. It is the user-level twin of
    :class:`TransferRuntime`'s background-task lane."""

    def __init__(self, background_budget_s: float = 50e-6):
        self._transfers: "collections.deque[Callable[[], None]]" = (
            collections.deque())
        self._background: list[Callable[[], None]] = []
        self._bg_cursor = 0
        self.background_budget_s = background_budget_s
        self.stats = SchedulerStats()

    def submit(self, task: Callable[[], None]) -> None:
        self._transfers.append(task)

    def register_background(self, task: Callable[[], None]
                            ) -> Callable[[], None]:
        """Register a recurring background task (e.g. data normalisation).
        Returns an unregister callable (mirrors the runtime's API)."""
        self._background.append(task)

        def unregister() -> None:
            try:
                self._background.remove(task)
            except ValueError:
                pass
        return unregister

    def _run_background_slice(self) -> None:
        if not self._background:
            return
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.background_budget_s:
            task = self._background[self._bg_cursor % len(self._background)]
            self._bg_cursor += 1
            task()
            self.stats.background_slices_run += 1
            if not self._background:
                break
        self.stats.total_background_s += time.perf_counter() - t0

    def drain(self) -> None:
        """Run transfer tasks to completion, interleaving background."""
        self.stats.drain_calls += 1
        while self._transfers:
            task = self._transfers.popleft()
            task()
            self.stats.transfer_tasks_run += 1
            self._run_background_slice()


class PollingBackend:
    """User-level polling as a backend: the submit IS the transfer — runs
    inline on the caller and returns an already-set event. Engines keep an
    equivalent inline fast path and never construct this; it exists so the
    three paper modes share one demonstrable API."""

    def submit(self, fn: Callable[[], Any], nbytes: int = 0,
               priority: PriorityClass | None = None
               ) -> tuple[threading.Event, list]:
        done = threading.Event()
        out: list = []
        try:
            out.append(fn())
        except BaseException as e:
            out.append(e)
        done.set()
        return done, out

    def close(self) -> None:
        pass


class ScheduledBackend:
    """User-level scheduled driver as a backend: descriptors become
    cooperative-scheduler tasks; the caller runs them via ``drain()``
    (single-threaded, background tasks interleaved)."""

    def __init__(self, scheduler: CooperativeScheduler | None = None):
        self.scheduler = scheduler or CooperativeScheduler()

    def submit(self, fn: Callable[[], Any], nbytes: int = 0,
               priority: PriorityClass | None = None
               ) -> tuple[threading.Event, list]:
        done = threading.Event()
        out: list = []

        def task() -> None:
            try:
                out.append(fn())
            except BaseException as e:
                out.append(e)
            done.set()

        self.scheduler.submit(task)
        return done, out

    def drain(self) -> None:
        self.scheduler.drain()

    def close(self) -> None:
        pass


def backend_for(management: Any, *,
                runtime: TransferRuntime | None = None,
                scheduler: CooperativeScheduler | None = None,
                priority: PriorityClass = PriorityClass.LAYER,
                owner: Any = None):
    """One constructor for the three paper modes. ``management`` is a
    :class:`~repro_torch.core.transfer.Management` or its string value (kept
    stringly to avoid an import cycle)."""
    mode = getattr(management, "value", management)
    if mode == "polling":
        return PollingBackend()
    if mode == "scheduled":
        return ScheduledBackend(scheduler)
    if mode == "interrupt":
        return (runtime or get_runtime()).register(owner or "backend_for",
                                                   priority)
    raise ValueError(f"unknown management mode: {management!r}")


# ---------------------------------------------------------------------------
# Dedicated pool for long-occupancy work (checkpoint writes)
# ---------------------------------------------------------------------------

class DedicatedWorkerPool:
    """Private worker pool for tasks that hold a thread for a long time
    (multi-second checkpoint writes). Those must NOT ride the shared
    runtime — a BULK descriptor in service occupies a shared worker for
    its whole duration, which is exactly the head-of-line blocking the
    runtime exists to prevent. Same queue/idle-exit structure the retired
    per-engine ``_CompletionPool`` had; same ``submit`` contract."""

    _SENTINEL = (None, None, None)

    def __init__(self, workers: int = 1, idle_timeout_s: float = 30.0) -> None:
        self.workers = max(1, workers)
        self.idle_timeout_s = idle_timeout_s
        self._q: ("queue.Queue[tuple[Callable[[], Any] | None, "
                  "threading.Event | None, list | None]]") = queue.Queue()
        self._lock = make_lock("DedicatedWorkerPool._lock")
        self._alive = 0                   # guarded-by: _lock
        self._threads: list[threading.Thread] = []  # guarded-by: _lock
        self._closed = False              # guarded-by: _lock

    def _run(self) -> None:
        while True:
            try:
                fn, done, out = self._q.get(timeout=self.idle_timeout_s)
            except queue.Empty:
                # exit only when the queue is provably empty under the lock:
                # submit() enqueues under the same lock, so a descriptor can
                # never be stranded between our timeout and our exit.
                with self._lock:
                    if not self._q.empty():
                        continue
                    self._alive -= 1
                return
            if fn is None:  # sentinel from close()
                with self._lock:
                    self._alive -= 1
                return
            try:
                out.append(fn())
            except BaseException as e:  # surfaced at wait()
                out.append(e)
            done.set()

    def submit(self, fn: Callable[[], Any]) -> tuple[threading.Event, list]:
        done = threading.Event()
        out: list = []
        with self._lock:
            if self._closed:
                raise RuntimeError("submit() on a closed DedicatedWorkerPool")
            self._q.put((fn, done, out))
            while self._alive < self.workers:
                t = threading.Thread(target=self._run, daemon=True)
                t.start()
                self._threads.append(t)
                self._alive += 1
            self._threads = [t for t in self._threads if t.is_alive()]
        return done, out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            n = self._alive
            threads = list(self._threads)
        for _ in range(n):
            self._q.put(self._SENTINEL)
        # join so no worker is still tearing down when the caller (possibly
        # the interpreter at exit) proceeds — a dying worker racing runtime
        # shutdown aborts the process from the C++ side.
        for t in threads:
            t.join(timeout=5.0)


# Back-compat alias for the retired per-engine pool's name.
_CompletionPool = DedicatedWorkerPool
