"""Binding of the hand-written CUDA SSD intra-chunk kernel
(``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/kernel.py`` (``_ssd_chunk_kernel`` /
``ssd_intra_chunk_call``): one entry, ``ssd_intra_chunk``, one launch a
call, with the heads and 64-row q tiles on the grid. The source's header
says what bounds it on an H100 and how the design answers that. x, B and C
are read by stride (the model passes views of its projection, no copies);
the outputs are allocated here, f32 and contiguous. A CPU tensor takes the
plain version (``ops.py``); a CUDA tensor launches the kernel or raises."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import I, L, P, CudaLibrary

SSD = CudaLibrary(
    "ssd_scan", Path(__file__).with_name("csrc") / "ssd_scan.cu",
    {"ssd_intra_chunk": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                         L, L, L, L, L, L, L, L, I, P]})

# what the kernel is compiled for: the chunk lengths, head dims and state
# sizes of mamba2-780m / zamba2-1.2b (Q 256, P 64, N 128 / 64), their smoke
# configs (Q 16, P 16, N 16) and the reference's test sweep (Q 8/16/32, N 8)
CHUNKS = (8, 16, 32, 256)
HEAD_DIMS = (16, 64)
STATE_DIMS = (8, 16, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, a, b, c, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, dt {tuple(dt.shape)}"
                         f", a {tuple(a.shape)}, b {tuple(b.shape)}")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(dt.shape) != (bs, s, h) or tuple(a.shape) != (h,)
            or tuple(b.shape[:2]) != (bs, s) or c.shape != b.shape
            or h % g):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"needs CUDA tensors on one device, {name} is "
                             f"on {t.device}")
    if x.dtype not in _DTYPE_CODE or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"unsupported dtypes x {x.dtype}, b {b.dtype}, "
                         f"c {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be float32, got {dt.dtype}, "
                         f"{a.dtype}")
    if chunk not in CHUNKS or p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"chunk {chunk}, head dim {p}, state {n}: the kernel "
                         f"is built for chunks {CHUNKS}, head dims "
                         f"{HEAD_DIMS}, states {STATE_DIMS}")
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if x.stride(3) != 1 or b.stride(3) != 1 or dt.stride(2) != 1 \
            or b.stride() != c.stride() or not a.is_contiguous():
        raise ValueError("x, b, c and dt need a contiguous last axis, and "
                         "b and c one layout")


def ssd_intra_chunk_call(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """x: [B,S,H,P]; dt: [B,S,H] f32; a: [H] f32; b, c: [B,S,G,N] in x's
    type. Returns (y_diag [B,S,H,P], states [B,nc,H,P,N], chunk_decay
    [B,nc,H]), f32. CUDA tensors only (``ops.ssd_intra_chunk`` takes the
    plain version for CPU tensors)."""
    _check(x, dt, a, b, c, chunk)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bs, s, h, p), **f32)
    st = torch.empty((bs, nc, h, p, n), **f32)
    dec = torch.empty((bs, nc, h), **f32)
    if y.numel():
        SSD.launch("ssd_intra_chunk", x.data_ptr(), dt.data_ptr(),
                   a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   st.data_ptr(), dec.data_ptr(), bs, s, h, p, g, n,
                   chunk, x.stride(0), x.stride(1), x.stride(2),
                   dt.stride(0), dt.stride(1), b.stride(0), b.stride(1),
                   b.stride(2), _DTYPE_CODE[x.dtype], device=x.device)
    return y, st, dec
