"""Plain PyTorch version of the conv2d kernel: SAME conv2d + bias + ReLU.

The same arithmetic as the kernel — K*K shifted dots into an f32
accumulator, bias and ReLU after — in NHWC / HWIO, written with tensor ops
only. The CPU path of ``conv2d_relu`` runs it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card (with TF32 off: a float32 matmul on
the card must not round its inputs to TF32 for the comparison to hold)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_relu_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    relu: bool = True) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout]; b: [Cout] (SAME, stride 1)."""
    _, h, wd, _ = x.shape
    kh, kw, _, _ = w.shape
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    wf = w.float()
    acc = b.float().expand(*x.shape[:3], w.shape[3]).clone()
    for dy in range(kh):
        for dx in range(kw):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(x.dtype)
