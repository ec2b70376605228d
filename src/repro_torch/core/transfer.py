"""Host<->device descriptor-ring transfer engine with the paper's policy matrix.

The paper evaluates how the *software policy* controlling DMA between the
processing system (PS) and programmable logic (PL) determines delivered
bandwidth. The three managements map onto CUDA host<->device semantics:

- ``POLLING``   — user-level polling driver: issue the copy and spin on its
  CUDA event (``event.query()``) before touching the data. Lowest per-transfer
  latency; host is blocked for the duration (the paper's warning: for large
  CNNs this blocks the whole system).
- ``SCHEDULED`` — user-level scheduled driver: transfers are enqueued on a
  cooperative scheduler which interleaves them with other registered tasks
  (sensor collection / normalization in the paper; data-prep and metric tasks
  here). Slightly higher latency, no dead-lock waits.
- ``INTERRUPT`` — kernel-level interrupt driver: descriptors are staged
  onto the process-shared :class:`~repro_torch.core.runtime.TransferRuntime`
  (the interrupt controller: one bounded worker pool arbitrating every
  engine's completions by priority class; a worker blocks on the copy's
  CUDA event, ``event.synchronize()``); the caller gets a ticket and
  is *notified* (callback / event) on completion. Highest fixed overhead
  per transfer, best overlap, memory-safety enforced (a staging slot
  cannot be re-staged before completion — the engine raises, mirroring
  the kernel driver's protection role). Each engine registers with a
  :class:`~repro_torch.core.runtime.PriorityClass` (default ``LAYER``); token
  streams register ``TOKEN``, prefetch ``BULK`` — individual calls may
  override via ``priority=``.

Descriptor ring
---------------
Buffering is a *ring* of N staging slots (the scatter-gather descriptor ring
of the Xilinx AXI-DMA driver): chunk k+N can only be staged once chunk k's
descriptor completed. ``Buffering.SINGLE`` and ``Buffering.DOUBLE`` are the
degenerate rings of depth 1 and 2; ``Buffering.RING`` plus
``TransferPolicy.ring_depth`` generalises to any depth, so the in-flight
window (and therefore the achievable TX/compute/RX overlap) is a tunable
policy knob instead of a hard-coded pair of buffers.

Staged layouts
--------------
:class:`StagedLayout` precomputes the pack plan (offset / shape / dtype per
array) for a fixed set of host arrays ONCE and owns a preallocated staging
buffer that is reused for every subsequent frame: per-frame cost is at most
one memcpy into the staging buffer — and zero when the arrays are unchanged
since the last pack (the steady state of inference weight streaming). The
per-engine :class:`LayoutCache` keys layouts by caller-chosen identity
(e.g. layer name), so ``pack``/``unpack`` never re-derive offsets or
re-allocate across frames. This is the ZynqNet lesson: staging *layout* is a
one-time cost, not a per-frame one.

Partitioning: ``UNIQUE`` sends the payload in one transfer; ``BLOCKS`` splits
it into ``block_bytes`` chunks (only BLOCKS lets a depth>=2 ring overlap
within a single logical transfer).

On a CUDA device, TX is ``dst.copy_(src, non_blocking=True)`` on the
engine's dedicated host->device stream and RX the mirror copy on its
device->host stream (the card's two copy engines), out of a pinned staging
buffer. A chunk's ticket completes only after its copy's CUDA event has
completed. On the CPU (``device="cpu"``, the tests) every TX and RX is a
real byte copy, so a transferred result never aliases the staging buffer
it came from.
"""

from __future__ import annotations

import collections
import enum
import math
import threading
import time
import zlib
from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.validated import make_lock
from repro_torch.core.runtime import (
    PREEMPTIBLE_CLASSES,
    CooperativeScheduler,
    PreemptibleWork,
    PriorityClass,
    RuntimeHandle,
    TransferChecksumError,
    TransferFaultError,
    TransferRuntime,
    TransferTimeoutError,
    get_runtime,
)
from repro_torch.core.qos import QosSpec, resolve_submit_qos
from repro_torch.device import default_device

__all__ = [  # re-exports: the fault taxonomy lives in runtime (no cycle)
    "Management", "Buffering", "Partitioning", "TransferPolicy",
    "TransferStats", "TransferEngine", "Ticket", "SGTicket", "StagedLayout",
    "LayoutCache", "BufferInFlightError", "TransferFaultError",
    "TransferTimeoutError", "TransferChecksumError", "reassemble_chunks",
    "carve_flat_out", "choose_sg", "sg_crossover_segments",
    "host_copy_bw_Bps",
]

# Per-engine rolling window of (direction, management, nbytes, seconds)
# chunk samples — the online cost-model refit (repro_torch.core.adaptive) fits
# t(n) = t0 + n/BW from these, so the window must bound memory on its own.
_CHUNK_SAMPLE_WINDOW = 512
# Per-engine/group window of recorded TransferStats (recent history for
# summaries/tests; exact lifetime totals live in the *_total counters).
_STATS_WINDOW = 4096
# Per-engine rolling window of grouped-transaction samples
# (direction, n_segments, total_bytes, wall_s) from _submit_many — the
# pack-vs-SG crossover refits the effective per-segment overhead from these.
_SG_SAMPLE_WINDOW = 64
# pack-vs-SG fallback rule when no cost model is fitted yet: SG only for
# layer sets that are unambiguously "few large arrays" (the shape where
# dodging the staging memcpy cannot lose to per-segment overhead).
_SG_FALLBACK_MAX_SEGMENTS = 16
_SG_FALLBACK_MIN_SEG_BYTES = 1 << 18


class Management(enum.Enum):
    POLLING = "polling"
    SCHEDULED = "scheduled"
    INTERRUPT = "interrupt"


class Buffering(enum.Enum):
    SINGLE = "single"
    DOUBLE = "double"
    RING = "ring"  # generalized descriptor ring; depth from TransferPolicy


class Partitioning(enum.Enum):
    UNIQUE = "unique"
    BLOCKS = "blocks"


_DEFAULT_RING_DEPTH = 4


@dataclass(frozen=True)
class TransferPolicy:
    """The paper's full policy point. Carried in model/run configs.

    ``ring_depth``: number of staging slots in the descriptor ring. 0 means
    "derive from ``buffering``" (SINGLE=1, DOUBLE=2, RING=4); any positive
    value overrides it. ``completion_workers`` is a sizing HINT for the
    shared :class:`~repro_torch.core.runtime.TransferRuntime` worker cap (the
    per-engine pools it used to size are retired — completions dispatch
    on the process-wide runtime).
    """

    management: Management = Management.INTERRUPT
    buffering: Buffering = Buffering.DOUBLE
    partitioning: Partitioning = Partitioning.BLOCKS
    block_bytes: int = 1 << 20  # 1 MiB default chunk (paper crossover region)
    ring_depth: int = 0  # 0 => derived from buffering
    completion_workers: int = 2
    # preemptive chunked dispatch (INTERRUPT only): LAYER/BULK TX chunks
    # bigger than this are submitted as resumable segment iterators
    # (:class:`~repro_torch.core.runtime.PreemptibleWork`) so the shared runtime
    # can yield mid-chunk to TOKEN/SENSOR arrivals. 0 disables it (whole
    # chunks stay the non-preemptive unit — the PR-4 behaviour). Sized by
    # the fitted cost model (:meth:`~repro_torch.core.cost_model.
    # TransferCostModel.preempt_chunk_bytes`) in adaptive plans.
    preempt_chunk_bytes: int = 0
    # opt-in end-to-end integrity: crc32 per descriptor, verified when the
    # RX payload lands on the host. A mismatch raises
    # :class:`~repro_torch.core.runtime.TransferChecksumError` (a retryable
    # TransferFaultError — the channel layer resubmits the stripe on a
    # sibling ring). On real HW the expected crc rides the TX-computed
    # descriptor metadata; on this backend it is computed from the device
    # buffer just before the landing copy.
    checksum: bool = False
    # per-descriptor deadline for the engine's own INTERNAL ticket waits
    # (the ring back-pressure waits inside sync tx/rx): None = unbounded
    # (pre-fault-layer behaviour). Callers of the async API bound their own
    # waits via ``Ticket.wait(timeout=)``.
    descriptor_timeout_s: float | None = None

    def __post_init__(self) -> None:
        if self.ring_depth < 0:
            raise ValueError(f"ring_depth must be >= 0, got {self.ring_depth}")
        if self.completion_workers < 1:
            raise ValueError("completion_workers must be >= 1")
        if self.preempt_chunk_bytes < 0:
            raise ValueError(
                f"preempt_chunk_bytes must be >= 0, got "
                f"{self.preempt_chunk_bytes}")
        if (self.descriptor_timeout_s is not None
                and self.descriptor_timeout_s <= 0):
            raise ValueError(
                f"descriptor_timeout_s must be positive or None, got "
                f"{self.descriptor_timeout_s}")

    @property
    def depth(self) -> int:
        """Effective descriptor-ring depth (in-flight staging slots)."""
        if self.ring_depth > 0:
            return self.ring_depth
        return {Buffering.SINGLE: 1, Buffering.DOUBLE: 2,
                Buffering.RING: _DEFAULT_RING_DEPTH}[self.buffering]

    def with_(self, **kw) -> "TransferPolicy":
        return replace(self, **kw)

    @property
    def tag(self) -> str:
        base = (
            f"{self.management.value}-{self.buffering.value}-"
            f"{self.partitioning.value}"
        )
        if self.ring_depth > 0 or self.buffering is Buffering.RING:
            base += f"-d{self.depth}"
        return base

    @staticmethod
    def user_level_polling() -> "TransferPolicy":
        return TransferPolicy(Management.POLLING, Buffering.SINGLE, Partitioning.UNIQUE)

    @staticmethod
    def user_level_scheduled() -> "TransferPolicy":
        return TransferPolicy(
            Management.SCHEDULED, Buffering.SINGLE, Partitioning.UNIQUE
        )

    @staticmethod
    def kernel_level() -> "TransferPolicy":
        return TransferPolicy(
            Management.INTERRUPT, Buffering.SINGLE, Partitioning.UNIQUE
        )

    @staticmethod
    def kernel_level_ring(depth: int = _DEFAULT_RING_DEPTH,
                          block_bytes: int = 1 << 20) -> "TransferPolicy":
        """The recommended hot-path policy: interrupt-driven depth-N ring."""
        return TransferPolicy(Management.INTERRUPT, Buffering.RING,
                              Partitioning.BLOCKS, block_bytes=block_bytes,
                              ring_depth=depth)


@dataclass
class TransferStats:
    """Measured outcome of one logical transfer (possibly many chunks)."""

    nbytes: int
    wall_s: float
    n_chunks: int
    direction: str  # "tx" (host->device) or "rx" (device->host)
    policy_tag: str
    management: str = ""  # Management mode the transfer ran under

    @property
    def us_per_byte(self) -> float:
        return (self.wall_s * 1e6) / max(self.nbytes, 1)

    @property
    def gbps(self) -> float:
        return self.nbytes / max(self.wall_s, 1e-12) / 1e9

    def row(self) -> str:
        return (
            f"{self.policy_tag},{self.direction},{self.nbytes},"
            f"{self.wall_s * 1e3:.4f},{self.us_per_byte:.6f},{self.n_chunks}"
        )


def _nbytes(a: Any) -> int:
    """Byte size of a device tensor or a host array."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _itemsize(a: Any) -> int:
    if isinstance(a, torch.Tensor):
        return a.element_size()
    return np.asarray(a).dtype.itemsize


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory (no copy). A read-only array (one a
    caller froze) is copied first: torch tensors are always writable."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class Ticket:
    """Handle for an in-flight INTERRUPT-mode transfer.

    ``wait(timeout=)`` bounds the wait: past the deadline it escalates to
    the issuing engine's runtime-level timeout scan (``on_timeout``) —
    still-queued stale descriptors are cancelled with
    :class:`~repro_torch.core.runtime.TransferTimeoutError`, which then surfaces
    here — and raises ``TransferTimeoutError`` itself if the descriptor is
    stuck in service (the one state a scan cannot unstick). A lost
    completion is an error the caller can retry, never a hang."""

    def __init__(self, done: threading.Event, out: list,
                 on_timeout: Callable[[float], None] | None = None):
        self._done = done
        self._out = out
        self._on_timeout = on_timeout

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            if self._on_timeout is not None:
                try:
                    self._on_timeout(timeout)
                except Exception:
                    pass  # escalation is best-effort; we raise below anyway
            # the scan completes cancelled tickets synchronously; a short
            # grace covers a completion racing the deadline.
            if not self._done.wait(0.05):
                raise TransferTimeoutError(
                    f"ticket not complete after {timeout:.3f}s (descriptor "
                    "in service or completion dropped)")
        result = self._out[0]
        if isinstance(result, BaseException):
            raise result
        return result

    @property
    def complete(self) -> bool:
        return self._done.is_set()


class SGTicket:
    """Handle for one logical scatter-gather transfer: K segments riding ONE
    ring slot and ONE runtime descriptor, tracked per segment (the SG
    descriptor chain of SNIPPETS.md Snippet 1 — the ISSUE_RD/WAIT_CPL loop
    walks the segment list, one logical completion at the end).

    ``wait`` reassembles results in segment order and re-raises the first
    segment error; ``wait_each`` keeps faults isolated to their own segment —
    sibling segments still yield their results (the mid-segment fault
    isolation contract)."""

    __slots__ = ("tickets",)

    def __init__(self, tickets: Sequence[Ticket]):
        self.tickets = list(tickets)

    def __len__(self) -> int:
        return len(self.tickets)

    @property
    def complete(self) -> bool:
        return all(t.complete for t in self.tickets)

    def wait(self, timeout: float | None = None) -> list:
        """Ordered per-segment results (``timeout`` bounds each segment
        wait); the first failed segment re-raises here."""
        return [t.wait(timeout) for t in self.tickets]

    def wait_each(self, timeout: float | None = None) -> list:
        """Ordered per-segment results with faults ISOLATED: a failed
        segment contributes its exception object in place, siblings their
        results — nothing raises."""
        out: list = []
        for t in self.tickets:
            try:
                out.append(t.wait(timeout))
            except BaseException as e:  # noqa: BLE001 — isolation contract
                out.append(e)
        return out


class BufferInFlightError(RuntimeError):
    """Raised when a staging buffer is re-used before its transfer completed.

    This is the memory-protection role of the paper's kernel-level driver:
    user-level code could silently corrupt a physical buffer still owned by
    the DMA engine; the kernel driver forbids it. So do we."""


# ---------------------------------------------------------------------------
# Staged layouts: precomputed pack plans + reusable staging buffers
# ---------------------------------------------------------------------------

def reassemble_chunks(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten a tx() chunk list back into one flat device tensor."""
    if len(chunks) == 1:
        return chunks[0].reshape(-1)
    return torch.cat([c.reshape(-1) for c in chunks])


def _bitcast_from_bytes(seg: torch.Tensor, shape: tuple,
                        dtype: np.dtype) -> torch.Tensor:
    """Reinterpret a flat uint8 device segment as ``dtype`` with ``shape``.

    ``tensor.view(dtype)`` needs the segment's byte offset to be a multiple
    of the itemsize; the staged offsets are running sums of array sizes, so
    a mixed-dtype layout can break that — raise rather than misread."""
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        return seg.reshape(shape)
    if dtype == np.bool_:
        # packed bools are 0/1 bytes
        return (seg != 0).reshape(shape)
    if seg.storage_offset() % dtype.itemsize:
        raise ValueError(
            f"segment at byte offset {seg.storage_offset()} is not aligned "
            f"to the {dtype.itemsize}-byte {dtype} itemsize")
    return seg.view(_torch_dtype(dtype)).reshape(shape)


class StagedLayout:
    """Precomputed pack/unpack plan for a fixed list of host arrays.

    Computes (offset, shape, dtype, nbytes) per array once and preallocates a
    single uint8 staging buffer — page-locked (pinned) when ``pin_memory``,
    so a CUDA copy out of it is a true asynchronous DMA. ``pack`` copies each array into
    its slot (skipping the copy entirely when the same array objects were
    packed last time and ``force=False``); ``unpack`` slices/bitcasts device
    chunks back into per-array device views using the cached offsets. Neither
    allocates host memory after construction.
    """

    __slots__ = ("specs", "nbytes", "_staging", "_staging_t", "_payload",
                 "_busy", "_last_arrays", "pack_count", "copy_count", "_pool")

    def __init__(self, arrays: Sequence[np.ndarray], *,
                 pool: "Any | None" = None, pin_memory: bool = False):
        specs = []
        off = 0
        for a in arrays:
            a = np.asarray(a)
            specs.append((off, a.shape, np.dtype(a.dtype), a.nbytes))
            off += a.nbytes
        self.specs: tuple = tuple(specs)
        self.nbytes = off
        # ``pool`` (e.g. repro_torch.core.channels.StagingPool) recycles staging
        # buffers across layouts, so a shape change (layout eviction) does
        # not cost a fresh allocation on the next frame.
        self._pool = pool
        # the pinned tensor owns the page-locked memory; ``pack`` writes
        # through its numpy view
        self._staging_t: torch.Tensor | None = None
        if pool is not None:
            self._staging = pool.acquire(max(off, 1))
        elif pin_memory:
            self._staging_t = torch.empty(max(off, 1), dtype=torch.uint8,
                                          pin_memory=True)
            self._staging = self._staging_t.numpy()
        else:
            self._staging = np.empty(max(off, 1), np.uint8)
        self._payload = self._staging[:off]  # stable view, identity-checkable
        self._busy: threading.Event | None = None  # set by engine on async tx
        # strong refs to the arrays staged last: identity comparison against
        # live objects is sound, whereas remembering bare id()s is not (a
        # freed array's id can be reused by a new allocation)
        self._last_arrays: tuple | None = None
        self.pack_count = 0
        self.copy_count = 0

    @property
    def staging(self) -> np.ndarray:
        return self._payload

    def matches(self, arrays: Sequence[np.ndarray]) -> bool:
        if len(arrays) != len(self.specs):
            return False
        return all(
            np.asarray(a).shape == shape and np.dtype(np.asarray(a).dtype) == dtype
            for a, (_, shape, dtype, _) in zip(arrays, self.specs)
        )

    def _check_not_busy(self, wait: bool) -> None:
        busy = self._busy
        if busy is not None and not busy.is_set():
            if wait:
                busy.wait()
            else:
                raise BufferInFlightError(
                    "StagedLayout staging buffer re-packed while its transfer "
                    "is in flight; wait for the ticket or pass wait=True"
                )

    def pack(self, arrays: Sequence[np.ndarray], *, wait: bool = True,
             force: bool = False) -> np.ndarray:
        """Copy ``arrays`` into the staging buffer; returns the SAME ndarray
        view object every call. When the identical array objects were packed
        last time, the memcpy is skipped (callers mutating arrays in place
        must pass ``force=True``)."""
        if not self.matches(arrays):
            raise ValueError("array shapes/dtypes do not match this layout")
        self._check_not_busy(wait)
        self.pack_count += 1
        unchanged = (
            not force
            and self._last_arrays is not None
            and len(arrays) == len(self._last_arrays)
            and all(a is b for a, b in zip(arrays, self._last_arrays))
        )
        if not unchanged:
            for (off, shape, dtype, nb), a in zip(self.specs, arrays):
                if nb == 0:
                    continue
                dst = self._staging[off:off + nb].view(dtype)
                np.copyto(dst, np.asarray(a).reshape(-1))
            self._last_arrays = tuple(arrays)
            self.copy_count += 1
        return self._payload

    def unpack(self, chunks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Slice device chunk(s) of a packed payload back into per-array
        device views, using the cached offsets (no host round-trip)."""
        flat = reassemble_chunks(chunks)
        return [
            _bitcast_from_bytes(flat[off:off + nb], shape, dtype)
            for off, shape, dtype, nb in self.specs
        ]

    def seg_sizes(self) -> list[int]:
        """Per-array byte sizes — the segment list the pack-vs-SG decision
        prices."""
        return [nb for _off, _shape, _dtype, nb in self.specs]

    def sg_segments(self, arrays: Sequence[np.ndarray]) -> list[tuple]:
        """The whole-array SG segment list for this layer set: the
        zero-copy alternative to :meth:`pack` (no staging buffer touched,
        no busy window — each array IS its own descriptor segment)."""
        if not self.matches(arrays):
            raise ValueError("array shapes/dtypes do not match this layout")
        return [(np.asarray(a), 0, nb)
                for a, (_off, _shape, _dtype, nb) in zip(arrays, self.specs)]

    def prefer_sg(self, model: Any, *, seg_t0_s: float | None = None,
                  copy_bw_Bps: float | None = None) -> bool:
        """Pack-vs-SG decision for this layer set, priced by a fitted
        :class:`~repro_torch.core.cost_model.TransferCostModel` (see
        :func:`choose_sg`)."""
        return choose_sg(self.seg_sizes(), model, seg_t0_s=seg_t0_s,
                         copy_bw_Bps=copy_bw_Bps)

    def release(self) -> None:
        """Return the staging buffer to the pool; the layout is dead after.

        A buffer whose transfer is still in flight is orphaned instead of
        pooled (handing it to a new layout mid-DMA is the corruption the
        kernel driver exists to prevent)."""
        if self._pool is None or self._staging is None:
            return
        busy = self._busy
        if busy is None or busy.is_set():
            self._pool.release(self._staging)
        self._staging = None
        self._payload = None


class LayoutCache:
    """Per-engine cache of :class:`StagedLayout` keyed by caller identity
    (layer name/index). A hit returns the SAME layout object — and therefore
    the same preallocated staging buffer — frame after frame. An optional
    staging ``pool`` is threaded into every layout so evicted layouts recycle
    their buffers instead of leaking the allocation."""

    def __init__(self, pool: Any | None = None, *,
                 pin_memory: bool = False) -> None:
        self._lock = make_lock("LayoutCache._lock")  # serving/pipeline hit one
        self._layouts: dict[Any, StagedLayout] = {}  # guarded-by: _lock
        self._pool = pool
        self._pin_memory = pin_memory
        self.hits = 0                  # guarded-by: _lock
        self.misses = 0                # guarded-by: _lock
        # per-layer-set pack-vs-SG memo: one decision per key per refit
        # generation (invalidate_sg() clears on controller replans), so the
        # hot path never re-prices a layer set it already decided.
        self._sg_choice: dict[Any, bool] = {}  # guarded-by: _lock

    def get(self, key: Any, arrays: Sequence[np.ndarray]) -> StagedLayout:
        with self._lock:
            lay = self._layouts.get(key)
            if lay is not None and lay.matches(arrays):
                self.hits += 1
                return lay
            if lay is not None:
                lay.release()  # stale shapes: recycle the old staging buffer
                self._sg_choice.pop(key, None)  # shapes changed: re-decide
            lay = StagedLayout(arrays, pool=self._pool,
                               pin_memory=self._pin_memory)
            self._layouts[key] = lay
            self.misses += 1
            return lay

    def decide_sg(self, key: Any, layout: StagedLayout,
                  decide: Callable[[list[int]], bool]) -> bool:
        """Per-layer-set pack-vs-SG decision, memoized per key.

        ``layout`` is the key's resolved :class:`StagedLayout` (the caller
        already holds it from :meth:`get` — no second lookup, no hit-count
        skew). ``decide(seg_sizes)`` (typically ``engine.prefer_sg``) runs
        once per key/shape/refit generation; repeat frames hit the memo. A
        shape change on the key or :meth:`invalidate_sg` re-prices."""
        with self._lock:
            hit = self._sg_choice.get(key)
            if hit is not None:
                return hit
        choice = bool(decide(layout.seg_sizes()))
        with self._lock:
            self._sg_choice[key] = choice
        return choice

    def invalidate_sg(self) -> None:
        """Drop every memoized pack-vs-SG decision (the online controller
        calls this after a refit moved the crossover)."""
        with self._lock:
            self._sg_choice.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._layouts)


def _check_out(arrays: Sequence[Any],
               out: Sequence[np.ndarray] | None) -> list:
    """Validate caller-owned RX destination buffers against device arrays.

    Each buffer must be writable, C-contiguous, and byte-size-matched to
    its array; dtype may differ (the copy is a byte-level landing, the
    caller keeps whatever view it allocated). Contiguity is load-bearing:
    ``reshape(-1)`` on a non-contiguous buffer would return a COPY and the
    transfer would silently land in a temporary instead of the caller's
    memory."""
    if out is None:
        return [None] * len(arrays)
    outs = list(out)
    if len(outs) != len(arrays):
        raise ValueError(
            f"out= needs one buffer per device array "
            f"(got {len(outs)} buffers for {len(arrays)} arrays)")
    for i, (a, o) in enumerate(zip(arrays, outs)):
        need = _nbytes(a)
        o = np.asarray(o)
        if not o.flags.writeable:
            raise ValueError(f"out[{i}] is not writable")
        if not o.flags.c_contiguous:
            raise ValueError(
                f"out[{i}] is not C-contiguous; the RX landing would copy "
                f"into a temporary instead of the caller's buffer")
        if o.nbytes != need:
            raise ValueError(
                f"out[{i}] holds {o.nbytes} bytes but the device array "
                f"needs {need}")
        outs[i] = o
    return outs


def carve_flat_out(out: np.ndarray, arrays: Sequence[Any]) -> list[np.ndarray]:
    """Carve ONE caller-owned flat buffer into per-array byte-range views
    (zero-copy), in array order — the striped-RX landing zone."""
    total = sum(_nbytes(a) for a in arrays)
    if not out.flags.writeable:
        raise ValueError("out= flat buffer is not writable")
    if not out.flags.c_contiguous:
        raise ValueError("out= flat buffer must be C-contiguous")
    if out.nbytes != total:
        raise ValueError(
            f"out= holds {out.nbytes} bytes but the payload needs {total}")
    flat = out.reshape(-1).view(np.uint8)
    views, off = [], 0
    for a in arrays:
        nb = _nbytes(a)
        views.append(flat[off:off + nb])
        off += nb
    return views


# ---------------------------------------------------------------------------
# Scatter-gather segments: zero-copy descriptor lists instead of staging packs
# ---------------------------------------------------------------------------

def _sg_segment_views(segments: Sequence[Any],
                      direction: str) -> tuple[list, list[int]]:
    """Normalize SG ``(array, offset, nbytes)`` segments to zero-copy views.

    A bare array is shorthand for a whole-array segment. Whole-array
    segments keep their shape/dtype (TX lands them as shaped device
    arrays — no unpack bitcast needed); partial segments must be
    itemsize-aligned and become flat element-range views. Nothing is
    staged or copied here — eliminating that memcpy is the point of the
    SG form."""
    views: list = []
    sizes: list[int] = []
    for i, seg in enumerate(segments):
        if isinstance(seg, (tuple, list)) and len(seg) == 3:
            a, off, nb = seg
        else:
            a, off, nb = seg, 0, None
        if direction == "tx":
            a = np.asarray(a)
        total = _nbytes(a)
        off = int(off)
        nb = total - off if nb is None else int(nb)
        if off < 0 or nb < 0 or off + nb > total:
            raise ValueError(
                f"SG segment {i}: byte range [{off}, {off + nb}) outside "
                f"the {total}-byte array")
        if off == 0 and nb == total:
            views.append(a)
        else:
            item = _itemsize(a)
            if off % item or nb % item:
                raise ValueError(
                    f"SG segment {i}: partial range ({off}, {nb}) not "
                    f"aligned to the {item}-byte array itemsize")
            if direction == "tx" and not a.flags.c_contiguous:
                raise ValueError(
                    f"SG segment {i}: partial TX range of a non-contiguous "
                    f"array would copy into a temporary — the staging "
                    f"memcpy SG exists to avoid")
            views.append(a.reshape(-1)[off // item:(off + nb) // item])
        sizes.append(nb)
    return views, sizes


_copy_bw_lock = make_lock("transfer._copy_bw_lock")
_copy_bw_Bps: float | None = None  # guarded-by: _copy_bw_lock


def host_copy_bw_Bps() -> float:
    """Measured host staging-memcpy bandwidth (bytes/s), cached per process.

    This is the per-byte price of ``StagedLayout.pack`` that the SG form
    refuses to pay; the pack-vs-SG decision charges the pack side with it.
    Measured once (best of 3 over an 8 MiB copy), not assumed."""
    global _copy_bw_Bps
    with _copy_bw_lock:
        if _copy_bw_Bps is not None:
            return _copy_bw_Bps
        src = np.ones(8 << 20, np.uint8)
        dst = np.empty_like(src)
        np.copyto(dst, src)  # warm: page the buffers in before timing
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            np.copyto(dst, src)
            best = min(best, time.perf_counter() - t0)
        _copy_bw_Bps = src.nbytes / max(best, 1e-9)
        return _copy_bw_Bps


def choose_sg(sizes: Sequence[int], model: Any, *,
              seg_t0_s: float | None = None,
              copy_bw_Bps: float | None = None) -> bool:
    """Pack-vs-SG decision for one segment-size list, priced by a fitted
    ``t(n) = t0 + n/BW`` cost model (duck-typed: anything with ``t0_s`` /
    ``bw_Bps``).

    - pack: one descriptor over the packed total, PLUS the staging memcpy
      — ``t0 + total/BW + total/copy_BW``.
    - SG:   one ring transaction walking K segment descriptors, zero copy
      — ``t0 + K*seg_t0 + total/BW`` (``seg_t0`` is the per-segment walk
      cost; defaults to the full ``t0`` until a live refit shrinks it).

    Link and base management terms cancel, so SG wins exactly when
    ``K * seg_t0 < total / copy_BW``: few large arrays -> SG (the memcpy
    dominates), many small arrays -> pack (the segment walk dominates)."""
    k = len(sizes)
    if k == 0:
        return False
    total = int(sum(sizes))
    seg_t0 = float(model.t0_s) if seg_t0_s is None else float(seg_t0_s)
    copy_bw = host_copy_bw_Bps() if copy_bw_Bps is None else float(copy_bw_Bps)
    return k * max(seg_t0, 1e-9) < total / max(copy_bw, 1.0)


def sg_crossover_segments(total_bytes: int, model: Any, *,
                          seg_t0_s: float | None = None,
                          copy_bw_Bps: float | None = None) -> float:
    """Segment count at which pack starts beating SG for a fixed total
    payload (the recorded crossover point): ``K* = total/(copy_BW*seg_t0)``."""
    seg_t0 = float(model.t0_s) if seg_t0_s is None else float(seg_t0_s)
    copy_bw = host_copy_bw_Bps() if copy_bw_Bps is None else float(copy_bw_Bps)
    return int(total_bytes) / (max(copy_bw, 1.0) * max(seg_t0, 1e-9))


def _split(arr: np.ndarray, policy: TransferPolicy) -> list[np.ndarray]:
    """Partition a flat view of ``arr`` according to the policy."""
    flat = arr.reshape(-1)
    if policy.partitioning is Partitioning.UNIQUE or flat.nbytes <= policy.block_bytes:
        return [flat]
    per_chunk = max(1, policy.block_bytes // max(flat.itemsize, 1))
    n = math.ceil(flat.size / per_chunk)
    return [flat[i * per_chunk : (i + 1) * per_chunk] for i in range(n)]


def _preempt_segments(flat: np.ndarray, seg_bytes: int) -> list[np.ndarray]:
    """Sub-slice one TX chunk into preemption segments (flat views)."""
    per = max(1, seg_bytes // max(flat.itemsize, 1))
    n = math.ceil(flat.size / per)
    return [flat[i * per: (i + 1) * per] for i in range(n)]


def _flatten_chunk_results(results: list) -> list:
    """Splice preemptible groups' per-segment device arrays back into a
    flat chunk list (segments are contiguous sub-slices in order, so the
    flattened list reassembles exactly like the unsplit chunks)."""
    out: list = []
    for r in results:
        if type(r) is list:
            out.extend(r)
        else:
            out.append(r)
    return out


class TransferEngine:
    """Executes host->device (TX) and device->host (RX) transfers under a
    :class:`TransferPolicy`, recording measured :class:`TransferStats`.

    The engine owns the descriptor ring (the paper's staging buffers in the
    *physical* space, generalised to depth N) and a :class:`LayoutCache` of
    reusable staging layouts. Under INTERRUPT management, completion
    dispatch rides the process-shared
    :class:`~repro_torch.core.runtime.TransferRuntime` (pass ``runtime=`` for a
    private one): the engine registers with a ``priority`` class and the
    runtime arbitrates its completions against every other stream's. It
    enforces completion ordering: a ring slot is only re-acquired once its
    descriptor completed."""

    def __init__(self, policy: TransferPolicy,
                 device: "torch.device | str | None" = None,
                 scheduler: "CooperativeScheduler | None" = None,
                 runtime: TransferRuntime | None = None,
                 priority: PriorityClass = PriorityClass.LAYER,
                 qos: QosSpec | None = None):
        self.policy = policy
        self.device = default_device(device)
        # the card's two copy engines: host->device and device->host each
        # get a stream of their own, so TX and RX overlap each other and
        # the caller's compute stream
        self._tx_stream = self._rx_stream = None
        if self.device.type == "cuda":
            self._tx_stream = torch.cuda.Stream(self.device)
            self._rx_stream = torch.cuda.Stream(self.device)
        # the engine's default submit context: every tx/rx inherits it, a
        # per-call qos= overrides only the fields it sets. ``priority``
        # stays as the class shorthand (not deprecated at construction —
        # only per-call priority= kwargs are).
        self.qos = QosSpec(priority=priority).merged(qos)
        self.priority = self.qos.priority
        # bounded: one record per logical transfer (per decoded token on
        # the serving path) — unbounded history would leak in a
        # long-running server; aggregates live in the *_total counters.
        self.stats: "collections.deque[TransferStats]" = collections.deque(
            maxlen=_STATS_WINDOW)        # guarded-by: _stats_lock
        self.layouts = LayoutCache(pin_memory=self.device.type == "cuda")
        # descriptor ring: one completion event per staging slot
        self._ring_lock = make_lock("TransferEngine._ring_lock")
        self._buffers_busy: list[threading.Event | None] = \
            [None] * policy.depth         # guarded-by: _ring_lock
        self._buf_idx = 0                 # guarded-by: _ring_lock
        self._slot_held = [False] * policy.depth  # guarded-by: _ring_lock
        self._inflight = 0                # guarded-by: _ring_lock
        # two concurrent holders of one slot (bug)
        self.slot_collisions = 0          # guarded-by: _ring_lock
        # high-water mark of concurrent descriptors
        self.max_inflight = 0             # guarded-by: _ring_lock
        # high-water mark of concurrently HELD slots
        self.inflight_hwm = 0             # guarded-by: _ring_lock
        self._stats_lock = make_lock("TransferEngine._stats_lock")
        # aggregate byte/transfer counters, mutated ONLY under _stats_lock —
        # the async completion path records from worker threads, so an
        # unlocked read-modify-write here silently drops bytes under load.
        self.tx_bytes_total = 0           # guarded-by: _stats_lock
        self.rx_bytes_total = 0           # guarded-by: _stats_lock
        self.tx_count = 0                 # guarded-by: _stats_lock
        self.rx_count = 0                 # guarded-by: _stats_lock
        self._observers: list[Callable[[TransferStats], None]] = \
            []                            # guarded-by: _stats_lock
        # bounded deque: append/popleft are GIL-atomic, so samplers (workers)
        # and the refit consumer need no extra lock here.
        self.chunk_samples: "collections.deque[tuple[str, str, int, float]]" \
            = collections.deque(maxlen=_CHUNK_SAMPLE_WINDOW)
        # grouped-transaction samples (direction, n_segments, total_bytes,
        # wall_s) from _submit_many — same GIL-atomic deque discipline; the
        # pack-vs-SG crossover refits the per-segment walk cost from these.
        self.sg_samples: "collections.deque[tuple[str, int, int, float]]" \
            = collections.deque(maxlen=_SG_SAMPLE_WINDOW)
        # monotone count of chunk samples ever taken: per-channel health
        # monitors PEEK the newest (chunk_seq - last_seen) entries instead
        # of popping, so they can coexist with the destructive
        # ingest_chunks() refit consumer.
        self.chunk_seq = 0                # guarded-by: _stats_lock
        # fault-layer ledger (exact lifetime totals)
        self.checksum_failures = 0        # guarded-by: _stats_lock
        self.chunks_cancelled = 0         # guarded-by: _stats_lock
        self._runtime = runtime
        # concurrent first-submit must not double-register (leak)
        self._handle_lock = make_lock("TransferEngine._handle_lock")
        self._handle: RuntimeHandle | None = None  # guarded-by: _handle_lock
        self._closed = False              # guarded-by: _handle_lock
        if scheduler is None and policy.management is Management.SCHEDULED:
            scheduler = CooperativeScheduler()
        self._scheduler = scheduler

    def _resolve_qos(self, where: str, qos: QosSpec | None,
                     priority: PriorityClass | None) -> QosSpec:
        """One submit call's effective context: per-call qos > engine
        default. A legacy ``priority=`` kwarg folds in through the
        deprecation shim (:func:`repro_torch.core.qos.resolve_submit_qos`)."""
        spec = resolve_submit_qos(f"{type(self).__name__}.{where}",
                                  qos, priority)
        return self.qos.merged(spec)

    # -- runtime registration (lazy so POLLING engines never touch it) ------
    def _runtime_handle(self) -> RuntimeHandle:
        if self._closed:  # lock-ok: racy fast-fail; re-checked under lock below
            raise RuntimeError("submit on a closed TransferEngine")
        h = self._handle  # lock-ok: double-checked init; re-read under lock
        if h is None:
            with self._handle_lock:
                if self._closed:
                    raise RuntimeError("submit on a closed TransferEngine")
                h = self._handle
                if h is None:
                    if self._runtime is None:
                        self._runtime = get_runtime()
                    h = self._handle = self._runtime.register(
                        self, self.priority,
                        workers_hint=self.policy.completion_workers)
        return h

    @property
    def runtime(self) -> TransferRuntime | None:
        """The runtime this engine's completions dispatch on (resolved for
        INTERRUPT engines; ``None`` for polling/scheduled engines that were
        not handed one explicitly)."""
        if (self._runtime is None
                and not self._closed  # lock-ok: advisory read, benign race
                and self.policy.management is Management.INTERRUPT):
            self._runtime = get_runtime()
        return self._runtime

    def close(self, timeout: float = 5.0) -> None:
        """Drain this engine's in-flight descriptors (bounded by
        ``timeout`` — stragglers are cancelled, never waited on forever)
        and deregister from the shared runtime, so a late completion can
        never fire into a dead engine. Idempotent; the engine rejects
        submissions after."""
        with self._handle_lock:
            if self._closed:
                return
            self._closed = True
            h, self._handle = self._handle, None
        if h is not None:
            h.close(timeout)

    def _escalate_timeout(self, waited_s: float | None) -> None:
        """Ticket.wait(timeout=) deadline blew: run the runtime-level
        timeout scan so a dropped completion resolves every ticket staged
        behind it (TransferTimeoutError, not a hang)."""
        rt = self._runtime
        if rt is not None and waited_s is not None:
            rt.scan_timeouts(max(float(waited_s), 1e-3))

    def maybe_adapt(self, *, force: bool = False) -> bool:
        """Engine-surface hook for safe-point adaptation. A plain engine
        has no online controller — executors call this unconditionally at
        frame/batch/request boundaries; repro_torch.core.adaptive overrides it."""
        return False

    def set_class_cap(self, cls: PriorityClass,
                      bytes_per_s: float | None) -> None:
        """Enforce (or clear, with None) a bytes/s ceiling for ``cls`` on
        the runtime this engine dispatches on — the engine-surface spelling
        of :meth:`~repro_torch.core.runtime.TransferRuntime.set_class_cap`
        (ChannelGroup / AdaptiveChannelGroup duck-type it)."""
        rt = self.runtime
        if rt is None:
            raise RuntimeError(
                "set_class_cap needs an INTERRUPT-managed engine (polling/"
                "scheduled engines have no shared runtime to enforce caps)")
        rt.set_class_cap(cls, bytes_per_s)

    def __enter__(self) -> "TransferEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- staging-ring safety (kernel-driver protection semantics) ----------
    def _acquire_buffer(self) -> tuple[int, threading.Event]:
        """Reserve the next descriptor-ring slot; returns ``(idx, release)``.

        The caller owns the slot until it fires ``release`` (via
        :meth:`_release_buffer`). Reservation installs a fresh completion
        event under the ring lock *before* waiting on the previous holder, so
        concurrent acquirers of the same slot chain FIFO on each other's
        events instead of racing ``_buf_idx`` / colliding on a slot.
        """
        with self._ring_lock:
            idx = self._buf_idx % len(self._buffers_busy)
            prev = self._buffers_busy[idx]
            if (prev is not None and not prev.is_set()
                    and self.policy.management is not Management.INTERRUPT):
                raise BufferInFlightError(
                    f"staging slot {idx} reused before completion "
                    f"(policy={self.policy.tag}); use INTERRUPT management or "
                    f"a deeper ring"
                )
            release = threading.Event()
            self._buffers_busy[idx] = release
            self._buf_idx += 1
        if prev is not None:
            prev.wait()  # kernel driver: safe, waits for completion
        with self._ring_lock:
            if self._slot_held[idx]:
                self.slot_collisions += 1
            self._slot_held[idx] = True
            self._inflight += 1
            self.inflight_hwm = max(self.inflight_hwm, self._inflight)
            self.max_inflight = max(self.max_inflight, self._inflight)
        return idx, release

    def _release_buffer(self, idx: int, release: threading.Event) -> None:
        """Free a ring slot; wakes the next acquirer chained on ``release``."""
        with self._ring_lock:
            self._slot_held[idx] = False
            self._inflight -= 1
        release.set()

    def add_observer(self, fn: Callable[[TransferStats], None]) -> None:
        """Subscribe to every recorded stat (the online-refit feed). The
        observer runs on whichever thread completes the transfer; it must be
        cheap and must not issue transfers on this engine."""
        with self._stats_lock:
            self._observers.append(fn)

    def _record(self, stats: TransferStats) -> None:
        if not stats.management:
            stats.management = self.policy.management.value
        with self._stats_lock:
            self.stats.append(stats)
            if stats.direction == "tx":
                self.tx_bytes_total += stats.nbytes
                self.tx_count += 1
            else:
                self.rx_bytes_total += stats.nbytes
                self.rx_count += 1
            observers = list(self._observers)
        for fn in observers:
            fn(stats)

    # -- TX: host -> device -------------------------------------------------
    def tx(self, host_array: np.ndarray,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None) -> list[torch.Tensor]:
        """Transfer ``host_array`` to the device; returns device chunk list.
        ``qos`` overrides the engine's submit context for this transfer
        (``priority=`` is the deprecated spelling of ``qos.priority``)."""
        spec = self._resolve_qos("tx", qos, priority)
        chunks = _split(np.asarray(host_array), self.policy)
        t0 = time.perf_counter()
        out = self._run_chunks(
            [(c, "tx", None) for c in chunks], spec,
        )
        wall = time.perf_counter() - t0
        self._record(
            TransferStats(host_array.nbytes, wall, len(chunks), "tx", self.policy.tag)
        )
        return out

    # -- RX: device -> host -------------------------------------------------
    def rx(self, device_arrays: Sequence[torch.Tensor],
           out: Sequence[np.ndarray] | None = None,
           priority: PriorityClass | None = None, *,
           qos: QosSpec | None = None) -> list[np.ndarray]:
        """Transfer device arrays back to host memory.

        ``out``: optional caller-owned destination buffers, one per device
        array (matching byte sizes). When given, results are written IN
        PLACE and the returned list contains the caller's own buffer
        objects — the zero-copy detokenize path."""
        spec = self._resolve_qos("rx", qos, priority)
        arrays = list(device_arrays)
        outs = _check_out(arrays, out)
        nbytes = sum(_nbytes(a) for a in arrays)
        self._order_rx_after_caller()
        t0 = time.perf_counter()
        result = self._run_chunks(
            [(a, "rx", o) for a, o in zip(arrays, outs)], spec)
        wall = time.perf_counter() - t0
        self._record(
            TransferStats(nbytes, wall, len(arrays), "rx", self.policy.tag)
        )
        return result

    def _preempt_segments_for(self, payload, direction: str,
                              cls: PriorityClass) -> list[np.ndarray] | None:
        """Sub-slices for preemptive chunked dispatch, or None to submit
        the chunk whole. TX only (an RX payload is one device array — the
        host does not sub-slice the device-side copy), and only for throughput
        classes: a TOKEN/SENSOR descriptor is the traffic preemption
        protects, not the traffic it splits."""
        n = self.policy.preempt_chunk_bytes
        if n <= 0 or direction != "tx" or cls not in PREEMPTIBLE_CLASSES:
            return None
        flat = payload
        if int(flat.nbytes) <= n:
            return None
        return _preempt_segments(flat, n)

    # -- chunk executor under the three managements -------------------------
    def _order_rx_after_caller(self) -> None:
        """Called on the submitting thread: the D2H stream waits for the
        work queued so far on the caller's current stream, so an RX never
        reads a tensor before the kernel that produces it has finished."""
        if self._rx_stream is not None:
            self._rx_stream.wait_stream(torch.cuda.current_stream(self.device))

    def _await(self, ev: "torch.cuda.Event") -> None:
        """Complete one copy: POLLING spins on the event, the other
        managements (runtime worker, cooperative task) block on it."""
        if self.policy.management is Management.POLLING:
            while not ev.query():
                pass
        else:
            ev.synchronize()

    def _copy_rx(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Enqueue one device->host byte copy on the RX stream (no wait).
        ``src`` was made on another stream: record this one on it, so the
        caching allocator cannot hand its memory out mid-copy."""
        src.record_stream(self._rx_stream)
        dst.reshape(-1).view(torch.uint8).copy_(
            src.detach().reshape(-1).view(torch.uint8), non_blocking=True)

    def _host_landing(self, src: torch.Tensor,
                      out: np.ndarray | None) -> tuple[torch.Tensor, Any]:
        """The host tensor an RX lands in and the object the caller gets
        back: the caller's ``out`` buffer, else a fresh (pinned on CUDA)
        array shaped like ``src``."""
        if out is not None:
            return torch.from_numpy(out.reshape(-1).view(np.uint8)), out
        host = torch.empty(src.shape, dtype=src.dtype,
                           pin_memory=self.device.type == "cuda")
        return host, host.numpy()

    def _one(self, payload, direction: str, out: np.ndarray | None = None):
        """Move ONE chunk (subclasses override to inject synthetic timing).

        TX takes a host array and returns a device tensor; RX takes a device
        tensor and returns a host array (``out`` when given). The chunk is
        complete — its CUDA event has fired — when this returns."""
        if self.device.type != "cuda":
            # host "device": a real copy either way, so a TX result never
            # aliases the staging buffer that the next pack overwrites
            if direction == "tx":
                return _host_tensor(payload).clone()
            host = payload.detach().numpy()
            if out is None:
                return host.copy()
            np.copyto(out.reshape(-1).view(np.uint8),
                      host.reshape(-1).view(np.uint8))
            return out
        ev = torch.cuda.Event()
        if direction == "tx":
            src = _host_tensor(payload)
            # the current stream is thread-local: enter the copy stream
            # explicitly (this runs on runtime worker threads)
            with torch.cuda.stream(self._tx_stream):
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
                dst.copy_(src, non_blocking=True)
                ev.record()
            self._await(ev)
            return dst
        with torch.cuda.stream(self._rx_stream):
            host, result = self._host_landing(payload, out)
            self._copy_rx(payload, host)
            ev.record()
        self._await(ev)
        return result

    @staticmethod
    def _crc32(arr: np.ndarray) -> int:
        return zlib.crc32(
            np.ascontiguousarray(arr).reshape(-1).view(np.uint8))

    def _one_timed(self, payload, direction: str,
                   out: np.ndarray | None = None):
        """_one plus a (direction, mode, nbytes, seconds) chunk sample —
        the per-descriptor timings the online refit fits t0/BW from.
        With ``policy.checksum`` the RX landing is crc32-verified against
        the device buffer (outside the timed region: integrity work must
        not pollute the bandwidth fit)."""
        nbytes = _nbytes(payload)
        verify = direction == "rx" and self.policy.checksum
        if verify:
            # on real HW this crc is TX-side descriptor metadata; here the
            # reference is the device buffer just before the landing copy.
            expect = self._crc32(payload.detach().cpu().numpy())
        t0 = time.perf_counter()
        r = self._one(payload, direction, out)
        dt = time.perf_counter() - t0
        self.chunk_samples.append(
            (direction, self.policy.management.value, nbytes, dt))
        with self._stats_lock:
            self.chunk_seq += 1
        if verify and self._crc32(np.asarray(r)) != expect:
            with self._stats_lock:
                self.checksum_failures += 1
            rt = self._runtime
            if rt is not None:
                rt.note_fault(self.priority, faults=1)
            raise TransferChecksumError(
                f"rx descriptor failed crc32 verification ({nbytes} B); "
                "payload corrupted in flight")
        return r

    def _run_chunks(self, items: list[tuple[Any, str, Any]],
                    qos: QosSpec) -> list:
        mgmt = self.policy.management
        if mgmt is Management.POLLING:
            # user-level polling: issue, then spin until ready, per chunk.
            results = []
            for payload, direction, dst in items:
                idx, release = self._acquire_buffer()
                try:
                    r = self._one_timed(payload, direction, dst)
                finally:
                    self._release_buffer(idx, release)
                results.append(r)
            return results

        if mgmt is Management.SCHEDULED:
            # cooperative scheduler: each chunk is a task; the scheduler may
            # interleave other registered work between chunks.
            results: list = [None] * len(items)

            def make_task(i, payload, direction, dst):
                def task():
                    idx, release = self._acquire_buffer()
                    try:
                        results[i] = self._one_timed(payload, direction, dst)
                    finally:
                        self._release_buffer(idx, release)

                return task

            for i, (payload, direction, dst) in enumerate(items):
                self._scheduler.submit(make_task(i, payload, direction, dst))
            self._scheduler.drain()
            return results

        # INTERRUPT: stage chunks onto the descriptor ring. Up to ``depth``
        # descriptors are in flight at once; chunk k+depth can only be staged
        # after chunk k's completion fires (ring reuse rule). Slot release
        # happens on the runtime's completion worker, so acquisition (which
        # may chain on a prior holder) never waits on work that cannot
        # progress. LAYER/BULK TX chunks above ``preempt_chunk_bytes`` go in
        # as resumable segment iterators (one ring slot, many yield points),
        # so the runtime can park them mid-chunk for TOKEN/SENSOR arrivals;
        # their per-segment device arrays are spliced back into the chunk
        # list below (contiguous order — reassembly is unchanged).
        handle = self._runtime_handle()
        depth = self.policy.depth
        cls = qos.priority or self.priority
        wait_s = (qos.timeout_s if qos.timeout_s is not None
                  else self.policy.descriptor_timeout_s)
        tickets: list[Ticket | None] = [None] * len(items)
        results: list = [None] * len(items)
        inflight: list[int] = []
        first_err: BaseException | None = None
        for i, (payload, direction, dst) in enumerate(items):
            while len(inflight) >= depth and first_err is None:
                j = inflight.pop(0)
                try:
                    results[j] = tickets[j].wait(wait_s)
                except BaseException as e:
                    # do NOT leave with own chunks still in service: stop
                    # submitting, drain the rest below, then raise.
                    first_err = e
            if first_err is not None:
                break
            idx, release = self._acquire_buffer()

            segs = self._preempt_segments_for(payload, direction, cls)
            if segs is not None:
                submit_obj: Any = PreemptibleWork(
                    [(lambda s=s: self._one_timed(s, "tx")) for s in segs],
                    collect=list,
                    finalize=lambda err, idx=idx, release=release:
                        self._release_buffer(idx, release))
            else:
                def work(p=payload, d=direction, o=dst, idx=idx,
                         release=release):
                    try:
                        return self._one_timed(p, d, o)
                    finally:
                        self._release_buffer(idx, release)
                submit_obj = work

            # on_cancel: a descriptor cancelled while queued (runtime
            # teardown) never runs ``work`` — its ring slot must still be
            # freed or every later acquirer of that slot deadlocks. A
            # submit() that RAISES (engine/runtime closed concurrently)
            # leaks the same slot; release it before surfacing.
            try:
                done, out = handle.submit(
                    submit_obj, nbytes=_nbytes(payload),
                    qos=qos,
                    on_cancel=lambda err, idx=idx, release=release:
                        self._release_buffer(idx, release))
            except BaseException as e:
                self._release_buffer(idx, release)
                first_err = e  # drain already-submitted chunks, then raise
                break
            tickets[i] = Ticket(done, out, on_timeout=self._escalate_timeout)
            inflight.append(i)
            with self._ring_lock:
                # under the ring lock: racing _acquire_buffer also updates
                # this high-water mark, and lost updates hide depth bugs.
                self.max_inflight = max(self.max_inflight, len(inflight))
        for j in inflight:
            try:
                results[j] = tickets[j].wait(wait_s)
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return _flatten_chunk_results(results)

    # -- async API (INTERRUPT only): returns a ticket, caller is "interrupted"
    def _submit_async(self, payloads: list, direction: str, nbytes: int,
                      callback: Callable[[list], None] | None,
                      layout: StagedLayout | None,
                      outs: Sequence[np.ndarray | None] | None = None,
                      qos: QosSpec | None = None) -> Ticket:
        """Stage ``payloads`` as ring descriptors, one per chunk.

        Ring slots are acquired on the *caller* thread, so a full ring
        back-pressures the submitter (the AXI-DMA enqueue semantics) and the
        in-flight descriptor count stays <= ``policy.depth`` even across
        concurrent async callers — the completion workers themselves never
        wait on a slot, so slot hand-off always makes progress. The ticket's
        master event fires after the LAST chunk completes; any chunk error is
        re-raised from ``Ticket.wait``.

        ``callback`` runs ON a shared runtime worker. Like an IRQ handler,
        it must not issue transfers (acquisition can block the worker on a
        slot only this runtime can release — self-deadlock); hand follow-up
        transfers to another thread via the ticket instead."""
        handle = self._runtime_handle()
        master = threading.Event()
        ticket_out: list = []
        results: list = [None] * len(payloads)
        # t0 is stamped when the FIRST chunk starts executing on a worker,
        # so recorded TransferStats measure the transfer itself — not the
        # caller's ring back-pressure or queue wait (keeps us/byte
        # comparable with the synchronous paths across PRs).
        state = {"remaining": len(payloads), "error": None, "t0": None}
        state_lock = threading.Lock()
        # first chunk error aborts the chain: chunks still queued behind it
        # short-circuit on dispatch (counted in ``chunks_cancelled``)
        # instead of moving bytes for a transfer that already failed.
        aborted = threading.Event()

        # Mark the staging buffer busy BEFORE any descriptor is submitted: a
        # re-pack racing this call could otherwise slip between submit() and
        # the flag assignment and corrupt the in-flight payload.
        if layout is not None:
            layout._busy = master

        if not payloads:
            ticket_out.append(results)
            master.set()
            return Ticket(master, ticket_out)

        def finish_one(err: BaseException | None) -> None:
            if err is not None:
                aborted.set()
            with state_lock:
                if err is not None and state["error"] is None:
                    state["error"] = err
                state["remaining"] -= 1
                last = state["remaining"] == 0
            if not last:
                return
            first_err = state["error"]
            if first_err is not None:
                ticket_out.append(first_err)
            else:
                wall = time.perf_counter() - (state["t0"]
                                              or time.perf_counter())
                self._record(TransferStats(
                    nbytes, wall, len(payloads), direction,
                    self.policy.tag))
                # preemptible chunks landed per-segment lists: splice them
                # back into one flat, ordered chunk list for the caller.
                flat_results = _flatten_chunk_results(results)
                ticket_out.append(flat_results)
                if callback is not None:
                    try:
                        callback(flat_results)
                    except BaseException as e:  # surfaced at wait()
                        ticket_out[0] = e
            master.set()

        qos = qos if qos is not None else self.qos
        cls = qos.priority or self.priority
        for i, payload in enumerate(payloads):
            idx, release = self._acquire_buffer()
            dst = outs[i] if outs is not None else None

            def work(i=i, p=payload, o=dst, idx=idx, release=release):
                err = None
                if aborted.is_set():
                    # a sibling chunk already failed the master ticket:
                    # skip the payload move, release the slot, and step the
                    # completion protocol with a non-primary error (the
                    # sibling's error stays first in ticket_out).
                    with self._stats_lock:
                        self.chunks_cancelled += 1
                    self._release_buffer(idx, release)
                    finish_one(RuntimeError(
                        "chunk cancelled: sibling chunk of this transfer "
                        "failed"))
                    return None
                with state_lock:
                    if state["t0"] is None:
                        state["t0"] = time.perf_counter()
                try:
                    results[i] = self._one_timed(p, direction, o)
                except BaseException as e:
                    err = e
                finally:
                    self._release_buffer(idx, release)
                    finish_one(err)

            def cancelled(err, idx=idx, release=release):
                # queued chunk cancelled at teardown: ``work`` never runs,
                # so the slot release and the master-ticket completion
                # protocol must run here — otherwise Ticket.wait() hangs
                # forever and the layout stays busy.
                self._release_buffer(idx, release)
                finish_one(err)

            segs = self._preempt_segments_for(payload, direction, cls)
            if segs is not None:
                # resumable segment iterator: the runtime may park this
                # chunk mid-flight for a TOKEN/SENSOR arrival. The segment
                # results land in results[i] via collect; finalize mirrors
                # ``work``'s finally (slot release + master-ticket step)
                # and runs exactly once — a queued/parked cancellation
                # takes ``cancelled`` instead.
                def seg_thunk(s):
                    def run():
                        if aborted.is_set():
                            # raising aborts the PreemptibleWork; its
                            # finalize releases the slot + steps the master
                            # ticket (the sibling's error stays first).
                            with self._stats_lock:
                                self.chunks_cancelled += 1
                            raise RuntimeError(
                                "chunk cancelled: sibling chunk of this "
                                "transfer failed")
                        with state_lock:
                            if state["t0"] is None:
                                state["t0"] = time.perf_counter()
                        return self._one_timed(s, direction)
                    return run

                def collect(parts, i=i):
                    results[i] = list(parts)
                    return results[i]

                submit_obj: Any = PreemptibleWork(
                    [seg_thunk(s) for s in segs],
                    collect=collect,
                    finalize=lambda err, idx=idx, release=release: (
                        self._release_buffer(idx, release),
                        finish_one(err)))
            else:
                submit_obj = work

            try:
                handle.submit(submit_obj,
                              nbytes=_nbytes(payload),
                              qos=qos, on_cancel=cancelled)
            except BaseException as e:
                # engine/runtime closed mid-loop: this chunk and every
                # unsubmitted one after it must still be accounted on the
                # master ticket (or wait() hangs and the layout stays
                # busy); its slot must be freed.
                self._release_buffer(idx, release)
                for _ in range(len(payloads) - i):
                    finish_one(e)
                break
        return Ticket(master, ticket_out, on_timeout=self._escalate_timeout)

    def tx_async(self, host_array: np.ndarray,
                 callback: Callable[[list], None] | None = None,
                 layout: StagedLayout | None = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None) -> Ticket:
        """Asynchronous TX. When ``layout`` is given (its staging buffer is
        the payload), the layout is marked busy until completion so an unsafe
        re-pack raises :class:`BufferInFlightError`."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("tx_async requires INTERRUPT management")
        spec = self._resolve_qos("tx_async", qos, priority)
        arr = np.asarray(host_array)
        chunks = _split(arr, self.policy)
        return self._submit_async(chunks, "tx", int(arr.nbytes), callback,
                                  layout, qos=spec)

    def rx_async(self, device_arrays: Sequence[torch.Tensor],
                 callback: Callable[[list], None] | None = None,
                 out: Sequence[np.ndarray] | None = None,
                 priority: PriorityClass | None = None, *,
                 qos: QosSpec | None = None) -> Ticket:
        """Asynchronous RX: device arrays stream back to host on a completion
        worker while the caller keeps computing. ``wait()`` returns the host
        ndarray list.

        ``out``: caller-owned destination buffers (one per array, byte sizes
        matching). The completion worker writes each result IN PLACE and the
        ticket yields the caller's own buffer objects — steady state does
        zero per-call host allocations (the serving detokenize path)."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("rx_async requires INTERRUPT management")
        spec = self._resolve_qos("rx_async", qos, priority)
        arrays = list(device_arrays)
        outs = _check_out(arrays, out)
        nbytes = sum(_nbytes(a) for a in arrays)
        self._order_rx_after_caller()
        return self._submit_async(arrays, "rx", nbytes, callback, None,
                                  outs=outs if out is not None else None,
                                  qos=spec)

    # -- batched descriptor submission (one ring transaction, many tickets) --
    def _submit_many(self, payloads: list, direction: str,
                     sizes: list[int],
                     outs: Sequence[np.ndarray] | None,
                     qos: QosSpec) -> list[Ticket]:
        """Submit a GROUP of small logical descriptors as ONE ring
        transaction: one slot, one runtime descriptor (``units=len``), one
        completion handoff — the paper's management-overhead amortization
        applied at the submission side. Each logical descriptor still gets
        its own :class:`Ticket`; a per-descriptor failure errors only its
        ticket, siblings resolve normally (exactly-once slot release).

        On CUDA the fast path enqueues the whole group's copies on the
        direction's stream behind ONE CUDA event (one completion), charging each
        descriptor a size-proportional share of the fused wall time in
        ``chunk_samples`` — honest amortized per-descriptor costs for the
        online refit. Engines that override ``_one`` (fault injection,
        modelled timing) take the per-payload loop instead, so injection
        seams and synthetic costs stay per-descriptor."""
        handle = self._runtime_handle()
        n = len(payloads)
        events = [threading.Event() for _ in range(n)]
        out_lists: list[list] = [[] for _ in range(n)]
        tickets = [Ticket(events[i], out_lists[i],
                          on_timeout=self._escalate_timeout)
                   for i in range(n)]
        if n == 0:
            return tickets
        total = sum(sizes)
        mode = self.policy.management.value

        def resolve(errs: list, results: list, wall: float) -> None:
            # single completion handoff for the whole group: one recorded
            # TransferStats (successful bytes/descriptors only — exact
            # accounting), then every ticket resolves in submission order.
            ok_bytes = sum(sz for sz, e in zip(sizes, errs) if e is None)
            ok_n = sum(1 for e in errs if e is None)
            if ok_n:
                self._record(TransferStats(ok_bytes, wall, ok_n, direction,
                                           self.policy.tag))
                if ok_n > 1 and wall > 0.0:
                    # grouped-transaction sample: the SG/batched crossover
                    # refits the per-segment walk cost from (k, total, wall)
                    self.sg_samples.append((direction, ok_n, ok_bytes, wall))
            for i in range(n):
                out_lists[i].append(
                    errs[i] if errs[i] is not None else results[i])
                events[i].set()

        # ONE ring slot for the whole transaction, acquired caller-side
        # (back-pressure semantics identical to _submit_async).
        idx, release = self._acquire_buffer()

        def work():
            results: list = [None] * n
            errs: list[BaseException | None] = [None] * n
            t0 = time.perf_counter()
            try:
                fused = (n > 1 and not self.policy.checksum
                         and self.device.type == "cuda"
                         and type(self)._one is TransferEngine._one)
                if fused:
                    try:
                        tf0 = time.perf_counter()
                        results = self._fused(payloads, direction, outs)
                        t_fused = time.perf_counter() - tf0
                        for i, sz in enumerate(sizes):
                            self.chunk_samples.append(
                                (direction, mode, sz,
                                 t_fused * sz / max(total, 1)))
                        with self._stats_lock:
                            self.chunk_seq += n
                    except BaseException:
                        # fused call failed as a whole: re-run per payload
                        # so the failure is attributed per descriptor.
                        fused = False
                        results = [None] * n
                if not fused:
                    for i, p in enumerate(payloads):
                        o = outs[i] if outs is not None else None
                        try:
                            results[i] = self._one_timed(p, direction, o)
                        except BaseException as e:
                            errs[i] = e
            finally:
                self._release_buffer(idx, release)
                resolve(errs, results, time.perf_counter() - t0)

        def cancelled(err: BaseException) -> None:
            # the group descriptor was cancelled while queued: ``work``
            # never runs, so the slot release and every ticket's error
            # handoff happen here (exactly once).
            with self._stats_lock:
                self.chunks_cancelled += n
            self._release_buffer(idx, release)
            resolve([err] * n, [None] * n, 0.0)

        try:
            handle.submit(work, nbytes=total, qos=qos,
                          on_cancel=cancelled, units=n)
        except BaseException as e:
            # engine/runtime closed concurrently: free the slot and error
            # every ticket (uniform with the async API — errors surface at
            # wait(), never from the submit call).
            self._release_buffer(idx, release)
            resolve([e] * n, [None] * n, 0.0)
        return tickets

    def _fused(self, payloads: list, direction: str,
               outs: Sequence[np.ndarray | None] | None) -> list:
        """One group's copies enqueued back to back on the direction's
        stream, completed by one event."""
        ev = torch.cuda.Event()
        results: list = []
        if direction == "tx":
            srcs = [_host_tensor(p) for p in payloads]
            with torch.cuda.stream(self._tx_stream):
                for src in srcs:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      device=self.device)
                    dst.copy_(src, non_blocking=True)
                    results.append(dst)
                ev.record()
        else:
            with torch.cuda.stream(self._rx_stream):
                for i, p in enumerate(payloads):
                    host, result = self._host_landing(
                        p, outs[i] if outs is not None else None)
                    self._copy_rx(p, host)
                    results.append(result)
                ev.record()
        self._await(ev)
        return results

    def tx_many(self, host_arrays: Sequence[np.ndarray],
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched TX: submit K small host arrays as one ring transaction
        with per-array tickets. Each array is one logical descriptor (no
        chunk split — the point is amortizing management overhead over
        SMALL payloads; use :meth:`tx_async` for large ones)."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("tx_many requires INTERRUPT management")
        spec = self._resolve_qos("tx_many", qos, priority)
        arrays = [np.asarray(a) for a in host_arrays]
        sizes = [int(a.nbytes) for a in arrays]
        return self._submit_many(arrays, "tx", sizes, None, spec)

    def rx_many(self, device_arrays: Sequence[torch.Tensor],
                out: Sequence[np.ndarray] | None = None,
                priority: PriorityClass | None = None, *,
                qos: QosSpec | None = None) -> list[Ticket]:
        """Batched RX: K device arrays come back as one ring transaction
        with per-array tickets; ``out`` keeps rx_async's zero-copy landing
        contract per descriptor. ``tickets[i].wait()`` returns the bare
        host array (not a chunk list)."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("rx_many requires INTERRUPT management")
        spec = self._resolve_qos("rx_many", qos, priority)
        arrays = list(device_arrays)
        outs = _check_out(arrays, out)
        sizes = [_nbytes(a) for a in arrays]
        self._order_rx_after_caller()
        return self._submit_many(arrays, "rx", sizes,
                                 outs if out is not None else None, spec)

    # -- scatter-gather descriptors (one slot, K segments, zero staging copy)
    def tx_sg(self, segments: Sequence[Any],
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather TX: a logical transfer submitted as a list of
        ``(array, offset, nbytes)`` segments (bare arrays = whole-array
        segments) that occupies ONE ring slot and ONE runtime descriptor
        (``units=K``), with per-segment completion tracking and ordered
        reassembly — and ZERO staging memcpy: each segment view goes
        straight into the device copy (the SG descriptor chain of the BSA
        DMA engine, SNIPPETS.md Snippet 1). Whole-array segments come back
        as shaped device arrays, so no unpack bitcast is needed either."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("tx_sg requires INTERRUPT management")
        spec = self._resolve_qos("tx_sg", qos, priority)
        views, sizes = _sg_segment_views(segments, "tx")
        return SGTicket(self._submit_many(views, "tx", sizes, None, spec))

    def rx_sg(self, segments: Sequence[Any],
              out: "np.ndarray | Sequence[np.ndarray] | None" = None,
              priority: PriorityClass | None = None, *,
              qos: QosSpec | None = None) -> SGTicket:
        """Scatter-gather RX, mirroring :meth:`tx_sg`. ``out`` keeps the
        zero-copy landing contract per segment: a sequence of per-segment
        buffers, or ONE flat array carved at segment boundaries (the
        striped reassembly landing zone)."""
        if self.policy.management is not Management.INTERRUPT:
            raise ValueError("rx_sg requires INTERRUPT management")
        spec = self._resolve_qos("rx_sg", qos, priority)
        views, sizes = _sg_segment_views(segments, "rx")
        self._order_rx_after_caller()
        outs = None
        if out is not None:
            outs = (carve_flat_out(out, views) if isinstance(out, np.ndarray)
                    else _check_out(views, out))
        return SGTicket(self._submit_many(views, "rx", sizes, outs, spec))

    def _sg_fit(self) -> Any | None:
        """Fit ``t(n) = t0 + n/BW`` from this engine's own recent TX chunk
        samples — the model the standalone pack-vs-SG decision prices with
        when no online controller is attached. None until there are enough
        samples spanning a real size range (a degenerate fit would put the
        crossover anywhere)."""
        samples = [(n, t) for d, _m, n, t in list(self.chunk_samples)
                   if d == "tx" and n > 0 and t > 0]
        if len(samples) < 8:
            return None
        ns = np.array([s[0] for s in samples], float)
        if ns.max() < 4 * max(ns.min(), 1.0):
            return None
        ts = np.array([s[1] for s in samples], float)
        from repro_torch.core.cost_model import TransferCostModel  # no cycle: lazy
        return TransferCostModel.fit(ns, ts)

    def sg_seg_t0_s(self, model: Any | None = None) -> float | None:
        """Effective per-segment walk cost under grouped submission,
        estimated from recent ``_submit_many`` transactions: each sample
        gives ``seg_t0 ~= (wall - t0 - total/BW) / K``. Median over the
        window (robust to one preempted outlier); None without data."""
        m = model if model is not None else self._sg_fit()
        if m is None:
            return None
        est = [max((wall - m.t0_s - total / m.bw_Bps) / k, 1e-7)
               for _d, k, total, wall in list(self.sg_samples) if k > 1]
        if not est:
            return None
        return float(np.median(np.array(est)))

    def prefer_sg(self, sizes: Sequence[int],
                  model: Any | None = None) -> bool:
        """Pack-vs-SG decision for one layer set (see :func:`choose_sg`),
        with the engine's best current knowledge: an explicit fitted
        ``model`` wins; else a fit from the engine's own chunk samples;
        else the structural few-large-arrays fallback.
        AdaptiveChannelGroup overrides this with the controller's live
        refit."""
        sizes = [int(s) for s in sizes]
        m = model if model is not None else self._sg_fit()
        if m is None:
            return (0 < len(sizes) <= _SG_FALLBACK_MAX_SEGMENTS
                    and min(sizes) >= _SG_FALLBACK_MIN_SEG_BYTES)
        return choose_sg(sizes, m, seg_t0_s=self.sg_seg_t0_s(m))

    # -- reporting -----------------------------------------------------------
    def summary(self) -> dict[str, float]:
        # snapshot under the lock: workers append records + bump the fault
        # ledger concurrently, and iterating a deque being appended from
        # another thread can skip/duplicate entries
        with self._stats_lock:
            records = list(self.stats)
            checksum_failures = self.checksum_failures
            chunks_cancelled = self.chunks_cancelled
        tx = [s for s in records if s.direction == "tx"]
        rx = [s for s in records if s.direction == "rx"]
        def agg(ss):
            if not ss:
                return {"us_per_byte": float("nan"), "gbps": float("nan")}
            tot_b = sum(s.nbytes for s in ss)
            tot_t = sum(s.wall_s for s in ss)
            return {"us_per_byte": tot_t * 1e6 / max(tot_b, 1),
                    "gbps": tot_b / max(tot_t, 1e-12) / 1e9}
        return {"tx": agg(tx), "rx": agg(rx),  # type: ignore[return-value]
                "checksum_failures": checksum_failures,
                "chunks_cancelled": chunks_cancelled}
