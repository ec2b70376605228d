"""Plain PyTorch versions of the conv2d kernel: SAME conv2d + bias + ReLU.

``conv2d_relu_ref`` is the function — K*K shifted dots into an f32
accumulator, bias and ReLU after — in NHWC / HWIO, written with tensor ops
only; the CPU path of ``conv2d_relu`` runs it. ``conv2d_split_ref`` is the
same function in the kernel's order (an implicit GEMM summed over the
plan's K ranges). ``chip_smoke.py`` holds the CUDA kernel against both on
the card (with TF32 off: a float32 matmul on the card must not round its
inputs to TF32 for the comparison to hold)."""

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
    # the dots first, from zero, and the bias after them, as the reference
    # kernel sums (a bias added first can swallow small dots)
    acc = torch.zeros((*x.shape[:3], w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
    acc = acc + b.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(x.dtype)


def conv2d_split_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     ranges: list[tuple[int, int]], *,
                     relu: bool = True) -> torch.Tensor:
    """The conv as the kernel sums it: an implicit GEMM over K = KH*KW*Cin
    (k = (dy*KW + dx)*Cin + ci), one f32 partial over each [k0, k1) of
    ``ranges`` (``kernel.conv_ranges`` of the plan), summed in slice order,
    then the bias and the ReLU. x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout]."""
    _, h, wd, _ = x.shape
    kh, kw, cin, cout = w.shape
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + wd, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    wm = w.float().reshape(kh * kw * cin, cout)
    acc = None
    for k0, k1 in ranges:
        part = cols[..., k0:k1] @ wm[k0:k1]
        acc = part if acc is None else acc + part
    acc = acc + b.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(x.dtype)
