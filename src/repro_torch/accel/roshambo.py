"""RoShamBo CNN — the 5-conv-layer network the paper executes on NullHop.

Per Aimar et al. (NullHop, arXiv:1706.01406): 64x64x1 DVS histogram frames,
five 3x3 conv layers (with max-pool after most), classifying
rock/paper/scissors(/background) — 4 classes. Layer transfer sizes land in
the ~100 KB regime the paper highlights ("transfer lengths are in the order
of 100Kbytes, where kernel-level driver is still not obtaining its best
results").

PyTorch definition in the reference's layouts (NHWC activations, HWIO
weights), executed per-layer by :mod:`repro_torch.accel.nullhop` through the
port's conv2d kernel, or monolithically via :meth:`RoShamBoCNN.apply` with
the plain conv (the oracle).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref


@dataclass(frozen=True)
class ConvSpec:
    name: str
    c_in: int
    c_out: int
    kernel: int = 3
    pool: bool = True  # 2x2 max pool after relu


@dataclass(frozen=True)
class RoShamBoConfig:
    input_hw: int = 64
    n_classes: int = 4
    layers: tuple[ConvSpec, ...] = (
        ConvSpec("conv1", 1, 16),
        ConvSpec("conv2", 16, 32),
        ConvSpec("conv3", 32, 64),
        ConvSpec("conv4", 64, 128),
        ConvSpec("conv5", 128, 128, pool=False),
    )
    dtype: str = "float32"


def roshambo_config() -> RoShamBoConfig:
    return RoShamBoConfig()


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool on NHWC (VALID: an odd last row or column is
    dropped, as ``lax.reduce_window`` does)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def params_from_jax(params_np: dict, device: "torch.device | str") -> dict:
    """The reference's ``RoShamBoCNN.init`` pytree, given as numpy arrays,
    as the port's params dict (same HWIO / NHWC layout, same values)."""
    return {name: {k: torch.from_numpy(np.array(v)).to(device)
                   for k, v in layer.items()}
            for name, layer in params_np.items()}


class RoShamBoCNN:
    def __init__(self, cfg: RoShamBoConfig | None = None):
        self.cfg = cfg or roshambo_config()

    def init(self, generator: torch.Generator,
             device: "torch.device | str" = "cuda") -> dict:
        """He-normal conv weights and zero biases, drawn on the CPU from
        ``generator`` (so the values do not depend on the device), then
        moved to ``device`` (the card unless the caller names another)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        params: dict = {}
        hw = cfg.input_hw
        for spec in cfg.layers:
            fan_in = spec.kernel * spec.kernel * spec.c_in
            w = torch.randn((spec.kernel, spec.kernel, spec.c_in, spec.c_out),
                            generator=generator) * math.sqrt(2.0 / fan_in)
            params[spec.name] = {"w": w.to(dt).to(device),
                                 "b": torch.zeros(spec.c_out, dtype=dt,
                                                  device=device)}
            if spec.pool:
                hw //= 2
        feat = hw * hw * cfg.layers[-1].c_out
        w = torch.randn((feat, cfg.n_classes), generator=generator) \
            * math.sqrt(1.0 / feat)
        params["fc"] = {"w": w.to(dt).to(device),
                        "b": torch.zeros(cfg.n_classes, dtype=dt,
                                         device=device)}
        return params

    def layer_apply(self, spec: ConvSpec, p: dict, x: torch.Tensor, *,
                    conv: Callable[..., torch.Tensor] = conv2d_relu
                    ) -> torch.Tensor:
        """One layer: conv + bias + ReLU (the port's kernel on a CUDA
        tensor), then the 2x2 max pool where the spec has one."""
        y = conv(x, p["w"], p["b"], relu=True)
        return maxpool2(y) if spec.pool else y

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Monolithic forward with the plain conv (oracle for the streamed
        executor)."""
        for spec in self.cfg.layers:
            x = self.layer_apply(spec, params[spec.name], x,
                                 conv=conv2d_relu_ref)
        b = x.shape[0]
        return x.reshape(b, -1) @ params["fc"]["w"] + params["fc"]["b"]

    def layer_transfer_bytes(self, params: dict, batch: int = 1) -> list[dict]:
        """Per-layer TX (params + input fmap) / RX (output fmap) byte counts —
        the quantities Table I normalises by."""
        cfg = self.cfg
        out = []
        hw = cfg.input_hw
        itemsize = torch.empty(0, dtype=getattr(torch, cfg.dtype)).element_size()
        for spec in cfg.layers:
            tx = (int(np.prod(params[spec.name]["w"].shape)) +
                  params[spec.name]["b"].shape[0]) * itemsize
            tx += batch * hw * hw * spec.c_in * itemsize
            hw_out = hw // 2 if spec.pool else hw
            rx = batch * hw_out * hw_out * spec.c_out * itemsize
            out.append({"name": spec.name, "tx_bytes": tx, "rx_bytes": rx})
            hw = hw_out
        return out
