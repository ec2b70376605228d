"""Binding of the hand-written CUDA conv2d kernel (``csrc/conv2d.cu``).

Replaces ``src/repro/kernels/conv2d/kernel.py`` (``_conv_kernel`` /
``conv2d_slabs``): the source's header says what bounds the kernel on an
H100 and how its design answers that.

The kernel is an implicit GEMM (M = B*H*W output pixels, N = Cout, K =
KH*KW*Cin) over ``CONV_TILE`` output tiles. ``conv_plan`` splits K over
the SMs when the tiles do not fill the card (the split-K scheme of
``repro_torch.kernels._split``, shared with the BLOCKS matmul);
``ref.conv2d_split_ref`` is the plain version in the plan's K ranges.
The epilogue can take the 2x2 max pool and add the count of the nonzero
values it wrote to an int32 counter (``ref.conv2d_relu_ref`` with ``pool``
and ``counts`` is the plain version); the plan is the unpooled launch's
either way."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, P, CudaLibrary, refuse_dtensor, refuse_grad)
from repro_torch.kernels._split import (
    SPLIT_WORKSPACE,
    cdiv,
    sm_count,
    split_plan,
    split_ranges,
)
from repro_torch.utils import trace

CONV2D = CudaLibrary(
    "conv2d", Path(__file__).with_name("csrc") / "conv2d.cu",
    {"conv2d_bias_act": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                         I, I, I, I, I, P]})

# (output pixels, output channels, K chunk) of a block: the tile the
# kernel is compiled for (csrc/conv2d.cu BM, BN, BK)
CONV_TILE = (64, 32, 32)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, kh: int, kw: int,
              sms: int) -> tuple[tuple[int, int, int], int, int]:
    """(tile, splits, K chunks a split) for a SAME stride-1 conv of
    [b, h, w, cin] by [kh, kw, cin, cout] on a card of ``sms`` SMs: K is
    cut into contiguous ranges of whole chunks, one block each, where the
    output tiles are fewer than the SMs (``_split.split_plan``)."""
    bm, bn, bk = CONV_TILE
    tiles = cdiv(b * h * w, bm) * cdiv(cout, bn)
    splits, per = split_plan(tiles, cdiv(kh * kw * cin, bk), sms)
    return CONV_TILE, splits, per


def conv_ranges(kh: int, kw: int, cin: int, splits: int,
                per: int) -> list[tuple[int, int]]:
    """The [k0, k1) range of K = kh*kw*cin that each split sums, in slice
    order (k = (dy*kw + dx)*cin + ci)."""
    return split_ranges(kh * kw * cin, CONV_TILE[2], splits, per)


def conv2d_igemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 relu: bool = True, pool: bool = False,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raise on anything it does
    not take (``NotImplementedError`` where autograd would need its
    gradient). x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout]; b: [Cout].
    ``pool``: the epilogue takes the 2x2 / stride-2 VALID max pool and
    writes [B, H // 2, W // 2, Cout]. ``counts``: a one-element int32
    tensor on x's device (a view into a larger buffer will do); the launch
    adds the number of nonzero values it wrote to it."""
    refuse_dtensor("the conv2d kernel", x, w, b)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv2d_igemm needs CUDA tensors, got {dev}")
    refuse_grad("the conv2d kernel", x, w, b)
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
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    count_ptr = None
    if counts is not None:
        if (counts.device != dev or counts.dtype != torch.int32
                or counts.numel() != 1):
            raise ValueError(
                f"counts must be one int32 element on {dev}, got "
                f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")
        count_ptr = counts.data_ptr()
    out_hw = (h // 2, wd // 2) if pool else (h, wd)
    y = torch.empty((bsz, *out_hw, cout), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    idx = dev.index  # a tensor's device always has its index
    (bm, bn, bk), splits, per = conv_plan(bsz, h, wd, cin, cout, kh, kw,
                                          sm_count(idx))
    part_ptr = cnt_ptr = None
    if splits > 1:
        # held until the launch is enqueued (SplitWorkspace)
        m = bsz * h * wd
        part, cnt = SPLIT_WORKSPACE.scratch(
            dev, torch._C._cuda_getCurrentRawStream(idx), splits * m * cout,
            cdiv(m, bm) * cdiv(cout, bn))
        part_ptr, cnt_ptr = part.data_ptr(), cnt.data_ptr()
    CONV2D.launch("conv2d_bias_act", x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), y.data_ptr(), part_ptr, cnt_ptr, count_ptr,
                  bsz, h, wd, cin, cout, kh, kw, bm, bn, bk, splits, per,
                  int(relu), int(pool), _DTYPE_CODE[x.dtype], device=dev)
    if pool:
        trace.count("conv.pool_fused")
    return y
