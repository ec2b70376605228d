"""Plain PyTorch versions of the conv2d kernel: SAME conv2d + bias + ReLU,
then the 2x2 max pool and the count of nonzeros its epilogue can take.

``conv2d_relu_ref`` is the function — K*K shifted dots into an f32
accumulator, bias and ReLU after, then ``maxpool2`` and the count where
asked — in NHWC / HWIO, written with tensor ops only; the CPU path of
``conv2d_relu`` runs it. ``conv2d_split_ref`` is the same conv in the
kernel's order (an implicit GEMM summed over the plan's K ranges).
``chip_smoke.py`` holds the CUDA kernel against both on the card (with TF32 off: a float32 matmul on the card must not round its
inputs to TF32 for the comparison to hold)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_relu_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    relu: bool = True, pool: bool = False,
                    counts: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout]; b: [Cout] (SAME, stride 1).
    ``pool``: then ``maxpool2``. ``counts``: a one-element int32 tensor, to
    which the output's nonzero values are added."""
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
    y = acc.to(x.dtype)
    if pool:
        y = maxpool2(y)
    if counts is not None:
        counts += torch.count_nonzero(y).to(counts.dtype)
    return y


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


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 max pool on NHWC (VALID: an odd last row or column is
    dropped, as ``lax.reduce_window`` does)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2, :]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))

