"""Binding of the hand-written CUDA conv2d kernel (``csrc/conv2d.cu``).

Replaces ``src/repro/kernels/conv2d/kernel.py`` (``_conv_kernel`` /
``conv2d_slabs``): the source's header says what bounds the kernel on an
H100 and how its design answers that."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import I, P, CudaLibrary

CONV2D = CudaLibrary(
    "conv2d", Path(__file__).with_name("csrc") / "conv2d.cu",
    {"conv2d_bias_act": [P, P, P, P, I, I, I, I, I, I, I, I, I, P]})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024  # the kernel's staged input window, as in the source


def conv2d_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does
    not take. x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout]; b: [Cout]."""
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_rows needs CUDA tensors, got {x.device}")
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    bsz, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin or b.shape[0] != cout:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME padding needs odd kernel sizes, got {kh}x{kw}")
    if kh * kw * cin * 4 > _SMEM_LIMIT:
        raise ValueError(f"input window {kh}x{kw}x{cin} exceeds the kernel's "
                         f"{_SMEM_LIMIT}-byte shared-memory stage")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    CONV2D.launch("conv2d_bias_act", x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout, kh,
                  kw, int(relu), _DTYPE_CODE[x.dtype], device=x.device)
    return y
