"""Per-layer streaming executor — the NullHop execution model on a ring.

NullHop processes a multi-layer CNN *one layer at a time*: the host streams
the layer's parameters (TX), then the input feature maps; the MAC array
starts computing as soon as a couple of rows arrive; output feature maps
stream back (RX) and become the next layer's input. Total frame time is the
per-layer sum of (TX + compute + RX), with overlap determined by the
transfer policy.

Under an INTERRUPT policy with ring depth >= 2 the executor runs
**three-way overlap** — the paper's balanced-TX/RX goal:

    TX(layer k+1)  ─┐
    compute(k)      ├─ concurrent (runtime completion workers + main thread)
    RX(layer k-1)  ─┘

On a CUDA device each of the three has a stream of its own: the engine's
host->device and device->host copy streams, and this executor's compute
stream. Layer k+1's parameters are packed into their cached
:class:`StagedLayout` (pinned) staging buffer and stream host->device while
layer k computes; layer k-1's output feature map streams device->host
(``rx_async``) at the same time. Staging layouts are resolved once per layer
identity through the engine's :class:`LayoutCache`, so steady-state frames
do zero pack allocation — and zero pack *copies* when the host params are
unchanged (inference weight streaming), the ZynqNet one-time-layout lesson.

The seed's per-frame pack path (``np.concatenate`` per layer per frame,
depth-2 max) is kept behind ``staged=False`` as the benchmark baseline.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.transfer import (
    Management,
    StagedLayout,
    Ticket,
    TransferEngine,
    _bitcast_from_bytes,
    _nbytes,
    _numpy_dtype,
    reassemble_chunks,
)
from repro_torch.utils import trace
from repro_torch.utils.pytree import tree_leaves, unstack


@dataclass
class LayerTiming:
    name: str
    tx_s: float
    compute_s: float
    rx_s: float
    tx_bytes: int
    rx_bytes: int

    @property
    def total_s(self) -> float:
        return self.tx_s + self.compute_s + self.rx_s


@dataclass
class FrameTiming:
    """Timing of one full multi-layer execution (one 'frame' in the paper).

    ``wall_s`` is the call's wall time, from entry until the result is on
    the host (a frame call's: until its logits are); ``layers_s`` sums
    the layers' TX, compute and RX, which leaves out whatever the call
    does around them."""

    layers: list[LayerTiming] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def frame_s(self) -> float:
        return self.wall_s

    @property
    def layers_s(self) -> float:
        return sum(l.total_s for l in self.layers)

    @property
    def tx_us_per_byte(self) -> float:
        b = sum(l.tx_bytes for l in self.layers)
        t = sum(l.tx_s for l in self.layers)
        return t * 1e6 / max(b, 1)

    @property
    def rx_us_per_byte(self) -> float:
        b = sum(l.rx_bytes for l in self.layers)
        t = sum(l.rx_s for l in self.layers)
        return t * 1e6 / max(b, 1)


class HostStreamingExecutor:
    """Run a sequence of layers, staging each layer's params host->device
    under the engine's policy, with ring-depth-controlled prefetch.

    ``layers`` is a list of (name, param_host_arrays, apply_fn) where
    ``apply_fn(params_device_list, x)`` returns the layer output tensor. With
    an INTERRUPT policy of ring depth >= 2 the executor overlaps layer k+1's
    TX *and* layer k-1's RX with layer k's compute; with POLLING everything
    serialises.

    ``engine`` is a :class:`TransferEngine` or anything that duck-types one
    (:class:`~repro_torch.core.channels.ChannelGroup`,
    :class:`~repro_torch.core.adaptive.AdaptiveChannelGroup`). Besides the
    transfer calls it must carry ``device``: the one device its transfers
    land on, read once here to give the executor its compute stream there.

    ``apply_fn`` runs on the executor's compute stream; the layer's compute
    time ends when an event recorded after it on that stream has completed,
    so ``compute_s`` means "until the layer's output exists".

    ``staged=False`` selects the legacy per-frame pack path (re-concatenates
    params every frame) — kept only as the measured baseline.

    ``sensor_fn``: optional frame-ingest callable, registered as a
    ``SENSOR``-class background task for the duration of each ``run()`` —
    the paper's concurrent collection+transfer scenario. Under INTERRUPT
    management the shared runtime gives it budgeted slices between
    completion dispatches; under SCHEDULED the cooperative scheduler
    interleaves it between DMA chunks; under POLLING it starves (the
    paper's warning: the polling driver blocks the whole system).
    """

    def __init__(self, engine: "TransferEngine | Any", *, staged: bool = True,
                 zero_copy_rx: bool = True,
                 sensor_fn: Callable[[], None] | None = None):
        self.engine = engine
        self.staged = staged
        self.sensor_fn = sensor_fn
        self.sensor_slices = 0  # background slices observed across runs
        # per-layer host output buffers, reused frame after frame: with
        # ``zero_copy_rx`` each INTERIOR layer's fmap RX lands in the SAME
        # executor-owned buffer every frame (``rx_async(..., out=)``), so
        # steady-state frames allocate nothing on the readback side. The
        # FINAL layer's output — the frame result handed to the caller —
        # is always a fresh array, so callers may keep frames without them
        # aliasing each other.
        self.zero_copy_rx = zero_copy_rx
        self._rx_bufs: dict[Any, np.ndarray] = {}
        device = engine.device
        self._cuda = device.type == "cuda"
        self._compute_stream = (torch.cuda.Stream(device) if self._cuda
                                else None)

    # -- the compute stream --------------------------------------------------
    def _on_compute(self):
        if self._compute_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._compute_stream)

    def _adopt(self, tensors: Sequence[torch.Tensor]) -> None:
        """Tensors the copy streams allocated are read on the compute
        stream: record it on them, so the caching allocator does not reuse
        their memory before the compute stream is done with it."""
        if self._compute_stream is not None:
            for t in tensors:
                t.record_stream(self._compute_stream)

    def _compute(self, apply_fn: Callable[..., torch.Tensor], params_dev: list,
                 x_dev: torch.Tensor) -> tuple[torch.Tensor, float]:
        t0 = time.perf_counter()
        with self._on_compute():
            y = apply_fn(params_dev, x_dev)
            if self._compute_stream is not None:
                done = torch.cuda.Event()
                done.record()
                trace.count("wait.compute")
                done.synchronize()
        t1 = time.perf_counter()
        _mark("frame.compute", t0, t1)
        return y, t1 - t0

    def _rx_out(self, key: Any, y: torch.Tensor, *,
                last: bool) -> list[np.ndarray] | None:
        if not self.zero_copy_rx or last:
            return None
        shape, dtype = tuple(y.shape), _numpy_dtype(y.dtype)
        buf = self._rx_bufs.get(key)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            # pinned on CUDA, so the device->host copy is a true DMA
            buf = torch.empty(shape, dtype=y.dtype,
                              pin_memory=self._cuda).numpy()
            self._rx_bufs[key] = buf
        return [buf]

    def _frame_end(self) -> None:
        """End-of-frame safe point: the ring is drained (every ticket
        retired), so an adaptive engine may swap its plan generation now
        (no-op on plain engines)."""
        self.engine.maybe_adapt()

    def _register_sensor(self) -> Callable[[], None]:
        """Register ``sensor_fn`` as a SENSOR-class background task on the
        engine's completion backend; returns the unregister callable.
        Both registrars (runtime, cooperative scheduler) share the
        register -> unregister-callable contract, so one wrapper serves
        both. POLLING has no backend: the host is blocked for the
        duration of every transfer — collection starves, which IS the
        paper's result."""
        if self.sensor_fn is None:
            return lambda: None
        mgmt = self.engine.policy.management
        registrar = None
        if mgmt is Management.INTERRUPT:
            registrar = getattr(self.engine, "runtime", None)
        elif mgmt is Management.SCHEDULED:
            registrar = getattr(self.engine, "_scheduler", None)
        if registrar is None:
            return lambda: None
        count = {"n": 0}

        def counted() -> None:
            count["n"] += 1
            self.sensor_fn()

        inner = registrar.register_background(counted)

        def unregister() -> None:
            inner()
            self.sensor_slices += count["n"]
        return unregister

    def run(
        self,
        layers: Sequence[tuple[str, list[np.ndarray],
                               Callable[..., torch.Tensor]]],
        x: np.ndarray,
    ) -> tuple[np.ndarray, FrameTiming]:
        policy = self.engine.policy
        overlapped = (
            policy.management is Management.INTERRUPT and policy.depth >= 2
        )
        t0 = time.perf_counter()
        unregister_sensor = self._register_sensor()
        try:
            if overlapped and self.staged:
                host_out, timing = self._run_overlapped(layers, x)
            else:
                host_out, timing = self._run_basic(layers, x,
                                                   prefetch=overlapped)
        finally:
            unregister_sensor()
        self._frame_end()
        timing.wall_s = time.perf_counter() - t0
        return host_out, timing

    # -- shared input staging ----------------------------------------------
    def _tx_input(self, x: np.ndarray) -> tuple[torch.Tensor, float, int]:
        t0 = time.perf_counter()
        xa = np.asarray(x)
        dev_chunks = self.engine.tx(xa)
        self._adopt(dev_chunks)
        with self._on_compute():
            x_dev = reassemble_chunks(dev_chunks).reshape(xa.shape)
        t1 = time.perf_counter()
        _mark("frame.tx", t0, t1)
        return x_dev, t1 - t0, xa.nbytes

    def _params_from(self, chunks: list, unpack: Callable[[list], list]) -> list:
        self._adopt(chunks)
        with self._on_compute():
            return unpack(chunks)

    # -- new path: cached layouts + three-way overlap -----------------------
    def _run_overlapped(self, layers, x) -> tuple[np.ndarray, FrameTiming]:
        engine = self.engine
        policy = engine.policy
        timing = FrameTiming()
        x_dev, input_tx_s, input_bytes = self._tx_input(x)
        if not layers:
            # no layers: the frame is the transferred input itself, not None
            host_out = engine.rx([x_dev])[0]
            return host_out, timing

        layouts: list[StagedLayout] = [
            engine.layouts.get((i, name), params)
            for i, (name, params, _) in enumerate(layers)
        ]

        # TX window: keep up to depth-1 layer streams in flight ahead of the
        # layer being computed (the descriptor-ring in-flight rule; slot
        # `depth` is reserved for the concurrent RX stream).
        tx_window = max(1, policy.depth - 1)
        pending_tx: list[tuple[str, Ticket]] = []  # ("pack"|"sg", ticket)
        next_tx = 0
        # per-layer-set pack-vs-SG gate: few large params ride scatter-gather
        # segments (one ring slot, zero staging memcpy); many small params
        # keep the staged pack. Decisions are memoized per layer key in the
        # LayoutCache and re-priced when the online fit moves the crossover.
        sg_capable = (hasattr(engine, "tx_sg")
                      and hasattr(engine, "prefer_sg")
                      and policy.management is Management.INTERRUPT)

        def issue_tx() -> None:
            nonlocal next_tx
            while next_tx < len(layers) and len(pending_tx) < tx_window:
                name, params, _ = layers[next_tx]
                lay = layouts[next_tx]
                if sg_capable and engine.layouts.decide_sg(
                        (next_tx, name), lay, engine.prefer_sg):
                    pending_tx.append(
                        ("sg", engine.tx_sg(lay.sg_segments(params))))
                else:
                    payload = lay.pack(params)
                    pending_tx.append(
                        ("pack", engine.tx_async(payload, layout=lay)))
                next_tx += 1

        issue_tx()

        pending_rx: tuple[int, Ticket] | None = None  # (layer idx, ticket)
        host_out: np.ndarray | None = None

        def drain_rx() -> None:
            nonlocal pending_rx, host_out
            if pending_rx is None:
                return
            j, ticket = pending_rx
            t0 = time.perf_counter()
            host_out = ticket.wait()[0]
            t1 = time.perf_counter()
            _mark("frame.rx", t0, t1)
            timing.layers[j].rx_s += t1 - t0
            pending_rx = None

        for i, (name, params_host, apply_fn) in enumerate(layers):
            with trace.span("frame.layer"):
                # --- TX: wait for this layer's in-flight params, then refill the
                # ring window (layers i+1 .. i+depth-1 stream during compute)
                t0 = time.perf_counter()
                kind, ticket = pending_tx.pop(0)
                if kind == "sg":
                    # SG segments are whole arrays: results arrive shaped, no
                    # staging unpack (and no staging buffer was ever touched).
                    params_dev = self._params_from(ticket.wait(), list)
                else:
                    params_dev = self._params_from(ticket.wait(),
                                                   layouts[i].unpack)
                issue_tx()
                t1 = time.perf_counter()
                _mark("frame.tx", t0, t1)
                tx_s = t1 - t0
                tx_bytes = layouts[i].nbytes
                if i == 0:
                    tx_s += input_tx_s
                    tx_bytes += input_bytes

                # --- compute (layer k-1's RX and layer k+1's TX are in flight)
                y, compute_s = self._compute(apply_fn, params_dev, x_dev)

                rx_bytes = _nbytes(y)
                timing.layers.append(
                    LayerTiming(name, tx_s, compute_s, 0.0, tx_bytes, rx_bytes)
                )
                # --- RX: retire layer k-1's ticket, launch layer k's — an
                # interior fmap streams back into its reused host buffer; the
                # final layer's (the caller's frame result) gets a fresh one.
                # Submitted from the compute stream, which the RX stream waits on.
                drain_rx()
                with self._on_compute():
                    pending_rx = (i, engine.rx_async(
                        [y], out=self._rx_out(i, y, last=i == len(layers) - 1)))
                x_dev = y  # next layer consumes device-resident output
        drain_rx()
        return host_out, timing

    # -- legacy/basic path: per-frame pack, serial (or depth-2 TX prefetch) --
    def _run_basic(self, layers, x, *, prefetch: bool) -> tuple[np.ndarray, FrameTiming]:
        timing = FrameTiming()
        x_dev, input_tx_s, input_bytes = self._tx_input(x)
        if not layers:
            host_out = self.engine.rx([x_dev])[0]
            return host_out, timing

        pending: Ticket | None = None
        if prefetch and layers:
            pending = self.engine.tx_async(_pack(layers[0][1]))

        host_out: np.ndarray | None = None
        for i, (name, params_host, apply_fn) in enumerate(layers):
            with trace.span("frame.layer"):
                # --- TX params for this layer
                t0 = time.perf_counter()
                if prefetch:
                    chunks = pending.wait()
                    params_dev = self._params_from(
                        chunks, lambda c: _unpack(c, params_host))
                    # issue next layer's TX immediately (overlaps compute below)
                    if i + 1 < len(layers):
                        pending = self.engine.tx_async(_pack(layers[i + 1][1]))
                else:
                    chunks = self.engine.tx(_pack(params_host))
                    params_dev = self._params_from(
                        chunks, lambda c: _unpack(c, params_host))
                t1 = time.perf_counter()
                _mark("frame.tx", t0, t1)
                tx_s = t1 - t0
                tx_bytes = sum(np.asarray(p).nbytes for p in params_host)
                if i == 0:
                    tx_s += input_tx_s
                    tx_bytes += input_bytes

                # --- compute
                y, compute_s = self._compute(apply_fn, params_dev, x_dev)

                # --- RX (per the paper, each layer's output returns to the PS)
                t0 = time.perf_counter()
                with self._on_compute():
                    host_out = self.engine.rx(
                        [y], out=self._rx_out(i, y, last=i == len(layers) - 1))[0]
                t1 = time.perf_counter()
                _mark("frame.rx", t0, t1)
                rx_s = t1 - t0

                timing.layers.append(
                    LayerTiming(name, tx_s, compute_s, rx_s, tx_bytes, host_out.nbytes)
                )
                x_dev = y  # next layer consumes device-resident output
        return host_out, timing


def _mark(name: str, t0: float, t1: float) -> None:
    """A layer phase, from the ``perf_counter`` stamps its timing took."""
    if trace.enabled():
        trace.mark(name, trace.perf_ns(t0), trace.perf_ns(t1))


def _pack(arrays: list[np.ndarray]) -> np.ndarray:
    """Seed-path pack: flatten a param list into one freshly-allocated
    contiguous payload, every call. Superseded by
    :meth:`repro_torch.core.transfer.StagedLayout.pack`; kept as the
    measured baseline."""
    if not arrays:
        return np.zeros((0,), np.float32)
    return np.concatenate([np.asarray(a).reshape(-1).view(np.uint8) for a in arrays])


def _unpack(chunks: list[torch.Tensor], ref: list[np.ndarray]) -> list[torch.Tensor]:
    """Seed-path unpack: re-derives offsets from ``ref`` on every call (see
    :meth:`StagedLayout.unpack` for the cached equivalent)."""
    flat = reassemble_chunks(chunks)
    out, off = [], 0
    for a in ref:
        a = np.asarray(a)
        out.append(_bitcast_from_bytes(flat[off : off + a.nbytes], a.shape,
                                       np.dtype(a.dtype)))
        off += a.nbytes
    return out


def device_streamed_scan(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stacked_params: Any,
    x: torch.Tensor,
    *,
    gather_fn: Callable[[Any], Any] | None = None,
    unroll: int = 1,
) -> torch.Tensor:
    """On-device per-layer streaming: scan over stacked layer params.

    Walks the layers of a stacked ``[L, ...]`` param tree (per-layer views,
    :func:`~repro_torch.utils.pytree.unstack`) in order: ``x =
    layer_fn(gather_fn(layer_params), x)``. ``gather_fn`` (if given)
    materialises one layer's params from their sharded / compressed /
    host-resident resting state — the device-side analogue of the
    per-layer TX. It computes exactly what that sequential loop computes.

    On a CUDA ``x`` the gathers form a double buffer (the reference leaves
    this schedule to XLA): layer k+1's gather is issued on a side stream
    before layer k's compute, after layer k-1's compute (whose buffer it
    takes over) on the device; the compute stream waits on the gather's
    event, and each gathered tensor is recorded on the compute stream so
    the caching allocator keeps it until the layer that reads it is done.
    The host stays at most three layers ahead, so at most three layers'
    gathered params are held at once. ``unroll`` is the reference's
    signature: a Python loop has nothing to unroll."""
    layers = unstack(stacked_params)
    if gather_fn is None or x.device.type != "cuda":
        for p in layers:
            x = layer_fn(p if gather_fn is None else gather_fn(p), x)
        return x
    compute = torch.cuda.current_stream(x.device)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(compute)  # whatever produced x and the stack
    done: list[torch.cuda.Event] = []  # after each layer's compute

    def gather(k: int) -> tuple[Any, torch.cuda.Event]:
        if k >= 3:
            done[k - 3].synchronize()  # bounds the gathered layers held
        if k >= 2:
            side.wait_event(done[k - 2])  # its buffer's last reader
        with torch.cuda.stream(side):
            p = gather_fn(layers[k])
            ready = torch.cuda.Event()
            ready.record(side)
        return p, ready

    nxt = gather(0)
    for k in range(len(layers)):
        p, ready = nxt
        if k + 1 < len(layers):
            nxt = gather(k + 1)  # in flight while layer k computes
        compute.wait_event(ready)
        for t in tree_leaves(p):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(compute)
        x = layer_fn(p, x)
        ev = torch.cuda.Event()
        ev.record(compute)
        done.append(ev)
    return x
