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
effective RX payload on the real device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.core.streaming import FrameTiming, HostStreamingExecutor
from repro_torch.core.transfer import TransferEngine, TransferPolicy


@dataclass
class NullHopResult:
    logits: np.ndarray
    timing: FrameTiming
    sparsity: list[float]  # per-layer zero fraction of the output fmap
    policy_tag: str


class NullHopExecutor:
    """Executes a RoShamBoCNN per-layer under a transfer policy.

    ``device``: the engine's device (default: the current CUDA card; the
    engine raises when there is none and no device was named).
    ``staged=True`` (default) streams through the engine's cached
    :class:`~repro_torch.core.transfer.StagedLayout` ring path — layer
    weights are laid out once and re-staged copy-free on every subsequent
    frame; ``staged=False`` keeps the seed per-frame pack path for
    comparison."""

    def __init__(self, cnn: RoShamBoCNN, policy: TransferPolicy, *,
                 staged: bool = True,
                 device: "torch.device | str | None" = None):
        self.cnn = cnn
        self.policy = policy
        self.staged = staged
        self.engine = TransferEngine(policy, device=device)
        # one streaming executor for the engine's life: its compute stream
        # and its interior RX landing buffers are reused frame after frame
        self._streamer = HostStreamingExecutor(self.engine, staged=staged)
        # host-side param arrays, reused while the same tensor is unmodified
        # (tensor._version counts in-place writes): the staged layouts see
        # the same array objects frame after frame and skip the pack copy
        self._host: dict[tuple[str, str], tuple[torch.Tensor, int, np.ndarray]] = {}

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
        cnn = self.cnn

        def make_apply(spec):
            def apply_fn(dev_params, x):
                w, b = dev_params
                return cnn.layer_apply(spec, {"w": w, "b": b}, x)
            return apply_fn

        layers = []
        for spec in cnn.cfg.layers:
            p = params[spec.name]
            layers.append((spec.name,
                           [self._host_array((spec.name, "w"), p["w"]),
                            self._host_array((spec.name, "b"), p["b"])],
                           make_apply(spec)))

        out_host, timing = self._streamer.run(layers, np.asarray(frame))

        sparsity = []  # recompute per-layer zero fractions (oracle pass)
        device = self.engine.device
        x = torch.as_tensor(np.asarray(frame)).to(device)
        for spec in cnn.cfg.layers:
            p = {k: v.to(device) for k, v in params[spec.name].items()}
            x = cnn.layer_apply(spec, p, x)
            sparsity.append(float((x == 0).float().mean()))

        # classifier head runs on the PS in the paper (host-side)
        feats = out_host.reshape(out_host.shape[0], -1)
        logits = (feats @ self._host_array(("fc", "w"), params["fc"]["w"])
                  + self._host_array(("fc", "b"), params["fc"]["b"]))
        return NullHopResult(logits, timing, sparsity, self.policy.tag)
