"""NullHop-style accelerator executor: per-layer streamed CNN execution.

Reproduces the paper's scenario 2 (Table I): each layer of the CNN is
executed as TX(params + input fmap) -> compute -> RX(output fmap), with the
transfer policy deciding how the TX/RX DMAs are managed. Built on
:class:`repro_torch.core.streaming.HostStreamingExecutor`, so the three
driver modes and the buffering/partitioning knobs all apply. Each layer's
compute is the port's conv2d kernel on the engine's device.

Also models NullHop's sparsity awareness: the accelerator skips zero
activations (sparse feature-map encoding); we report the measured activation
sparsity per layer (ReLU output) alongside timings, since it determines the
effective RX payload on the real device. Each streamed layer's zeros are
counted in the conv kernel's epilogue, as it writes the (pooled) fmap,
into the layer's element of one int32 buffer on the device; the call
zeroes that buffer once and reads it back once.

While a ``torch.profiler`` records, each call is a ``frame`` span (its id
the executor's call number) holding a ``frame.layer`` span a layer (with
the layer's ``frame.tx`` / ``frame.compute`` / ``frame.rx``), then
``frame.sparsity`` (the one read of the layers' zero counts) and
``frame.head`` (the host FC); see :mod:`repro_torch.utils.trace`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.core.streaming import FrameTiming, HostStreamingExecutor
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.utils import trace


@dataclass
class NullHopResult:
    logits: np.ndarray
    timing: FrameTiming
    # per-layer zero fraction of the output fmap, counted on the fmap the
    # streamed layer produced
    sparsity: list[float]
    policy_tag: str


class NullHopExecutor:
    """Executes a RoShamBoCNN per-layer under a transfer policy.

    ``device``: the engine's device (default: the current CUDA card; the
    engine raises when there is none and no device was named). The policy
    picks the streaming path (:class:`HostStreamingExecutor`): an INTERRUPT
    policy with ring depth >= 2 streams through the engine's cached
    :class:`~repro_torch.core.transfer.StagedLayout` ring with three-way
    overlap; every other, ``TransferPolicy.kernel_level()`` (depth 1)
    among them, runs the layers in turn, each layer's params packed into
    one fresh payload a frame."""

    def __init__(self, cnn: RoShamBoCNN, policy: TransferPolicy, *,
                 device: "torch.device | str | None" = None):
        self.cnn = cnn
        self.policy = policy
        self.engine = TransferEngine(policy, device=device)
        # one streaming executor for the engine's life: its compute stream
        # and its interior RX landing buffers are reused frame after frame
        self._streamer = HostStreamingExecutor(self.engine)
        # host-side param arrays, reused while the same tensor is unmodified
        # (tensor._version counts in-place writes): no device->host copy of
        # the params a frame, and the overlapped path's staged layouts see
        # the same array objects frame after frame and skip the pack copy
        self._host: dict[tuple[str, str], tuple[torch.Tensor, int, np.ndarray]] = {}
        self.calls = 0  # run_frame calls so far

    def close(self) -> None:
        self.engine.close()

    def _host_array(self, key: tuple[str, str], t: torch.Tensor) -> np.ndarray:
        hit = self._host.get(key)
        if hit is not None and hit[0] is t and hit[1] == t._version:
            return hit[2]
        arr = t.detach().cpu().numpy()
        self._host[key] = (t, t._version, arr)
        return arr

    def run_frame(self, params: dict, frame: np.ndarray) -> NullHopResult:
        """frame: [B, H, W, C]. Per-layer streamed execution + final FC."""
        self.calls += 1
        return _run_frame(self.cnn, self._streamer, params, frame,
                          self._host_array, self.policy.tag, call=self.calls)


def _run_frame(cnn: RoShamBoCNN, streamer: HostStreamingExecutor,
               params: dict, frame: np.ndarray, host_array,
               policy_tag: str, call: int | None = None) -> NullHopResult:
    """One frame through ``streamer`` (over a single engine or a channel
    group): the layers streamed, each counting its fmap's zeros in the
    conv kernel's epilogue, the classifier head on the host. ``host_array(key,
    tensor)`` gives the host array a layer's param is staged from;
    ``call`` numbers the ``frame`` span. The timing's ``wall_s`` is the whole call's, entry to
    logits."""
    t0 = time.perf_counter()
    with trace.span("frame", id=call):
        res = _frame_body(cnn, streamer, params, frame, host_array,
                          policy_tag)
    res.timing.wall_s = time.perf_counter() - t0
    return res


def _frame_body(cnn, streamer, params, frame, host_array,
                policy_tag) -> NullHopResult:
    n_layers = len(cnn.cfg.layers)
    nnz: list[torch.Tensor] = []  # the call's int32 [layers] buffer
    numel: list[int] = []

    def make_apply(i, spec):
        def apply_fn(dev_params, x):
            w, b = dev_params
            if not nnz:  # zeroed once a call, on the compute stream
                nnz.append(torch.zeros(n_layers, dtype=torch.int32,
                                       device=x.device))
            # the layer's launch adds its fmap's nonzeros to element i; the
            # executor waits for an event recorded after apply_fn, so the
            # count is ready once the layer's compute is
            y = cnn.layer_apply(spec, {"w": w, "b": b}, x,
                                counts=nnz[0][i])
            numel.append(y.numel())
            return y
        return apply_fn

    layers = []
    for i, spec in enumerate(cnn.cfg.layers):
        p = params[spec.name]
        layers.append((spec.name,
                       [host_array((spec.name, "w"), p["w"]),
                        host_array((spec.name, "b"), p["b"])],
                       make_apply(i, spec)))

    out_host, timing = streamer.run(layers, np.asarray(frame))

    with trace.span("frame.sparsity"):
        trace.count("sparsity.fmaps", len(numel))
        trace.count("wait.sparsity")
        counts = nnz[0].tolist() if nnz else []  # the call's one read
        sparsity = [1.0 - c / n for c, n in zip(counts, numel)]

    with trace.span("frame.head"):
        # classifier head runs on the PS in the paper (host-side)
        feats = out_host.reshape(out_host.shape[0], -1)
        logits = (feats @ host_array(("fc", "w"), params["fc"]["w"])
                  + host_array(("fc", "b"), params["fc"]["b"]))
    return NullHopResult(logits, timing, sparsity, policy_tag)
