"""Binding of the hand-written CUDA SSD kernels (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/kernel.py`` (``_ssd_chunk_kernel`` /
``ssd_intra_chunk_call``): one entry, ``ssd_intra_chunk``, one launch a
call. bf16 runs on the tensor cores, a block a 64-row q tile (or the
states) of one (batch, chunk) and a slice of one group's heads, with C.B
formed once a block (``ssd_slice`` picks the slice); f32 runs on the CUDA
cores, a block a head. ``ssd_state_pass`` is the inter-chunk recurrence of
the reference's ``ssd_full`` in one launch. The source's header says what
bounds them on an H100 and how the design answers that. x, B and C are
read by stride (the model passes views of its projection, no copies); the
outputs are allocated here, f32 and contiguous. A CPU tensor takes the
plain version (``ops.py``); a CUDA tensor launches the kernel or raises."""

from __future__ import annotations

import math
from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, L, P, CudaLibrary, refuse_dtensor, refuse_grad)
from repro_torch.kernels._split import sm_count

SSD = CudaLibrary(
    "ssd_scan", Path(__file__).with_name("csrc") / "ssd_scan.cu",
    {"ssd_intra_chunk": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                         L, L, L, L, L, L, L, L, I, I, P],
     "ssd_state_pass": [P, P, P, P, P, I, I, I, I, P]})

# what the kernel is compiled for: the chunk lengths, head dims and state
# sizes of mamba2-780m / zamba2-1.2b (Q 256, P 64, N 128 / 64), their smoke
# configs (Q 16, P 16, N 16) and the reference's test sweep (Q 8/16/32, N 8)
CHUNKS = (8, 16, 32, 256)
HEAD_DIMS = (16, 64)
STATE_DIMS = (8, 16, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 kernel: q rows a tile, heads a block at most, blocks an SM wanted
Q_TILE = 64
MAX_SLICE = 8
BLOCKS_PER_SM = 4


def ssd_slice(b: int, nc: int, h: int, g: int, chunk: int, sms: int) -> int:
    """Heads a block of the bf16 kernel: the largest divisor of a group's
    H / G heads, at most ``MAX_SLICE``, whose slices give the grid (each
    slice's state block and q tiles, for every (batch, chunk)) at least
    ``BLOCKS_PER_SM`` blocks an SM, or 1 where none does. A block forms
    C.B once for its slice, so larger slices form it fewer times; smaller
    ones fill the card."""
    rep = h // g
    cells = b * nc * (1 + math.ceil(chunk / Q_TILE))
    fits = [d for d in range(min(rep, MAX_SLICE), 0, -1)
            if rep % d == 0 and cells * g * (rep // d) >= BLOCKS_PER_SM * sms]
    return fits[0] if fits else 1


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
    # the bf16 kernel copies x, b and c in 16-byte pieces
    if x.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])
            for t in (x, b, c)):
        raise ValueError("bf16 x, b and c must be 16-byte aligned, with "
                         "every stride but the last a multiple of 8")


def ssd_intra_chunk_call(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """x: [B,S,H,P]; dt: [B,S,H] f32; a: [H] f32; b, c: [B,S,G,N] in x's
    type. Returns (y_diag [B,S,H,P], states [B,nc,H,P,N], chunk_decay
    [B,nc,H]), f32. CUDA tensors only (``ops.ssd_intra_chunk`` takes the
    plain version for CPU tensors; ``ops.ssd_full`` differentiates it)."""
    refuse_dtensor("the SSD intra-chunk kernel", x, dt, a, b, c)
    refuse_grad("the SSD intra-chunk kernel", x, dt, a, b, c)
    _check(x, dt, a, b, c, chunk)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bs, s, h, p), **f32)
    st = torch.empty((bs, nc, h, p, n), **f32)
    dec = torch.empty((bs, nc, h), **f32)
    if y.numel():
        hs = (ssd_slice(bs, nc, h, g, chunk, sm_count(x.device.index))
              if x.dtype == torch.bfloat16 else 1)
        SSD.launch("ssd_intra_chunk", x.data_ptr(), dt.data_ptr(),
                   a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
                   st.data_ptr(), dec.data_ptr(), bs, s, h, p, g, n,
                   chunk, x.stride(0), x.stride(1), x.stride(2),
                   dt.stride(0), dt.stride(1), b.stride(0), b.stride(1),
                   b.stride(2), hs, _DTYPE_CODE[x.dtype], device=x.device)
    return y, st, dec


def ssd_state_pass_call(states: torch.Tensor, chunk_decay: torch.Tensor,
                        initial_state: torch.Tensor | None = None):
    """The recurrence across chunks in one launch: states [B,nc,H,P,N] and
    chunk_decay [B,nc,H], f32; initial_state [B,H,P,N] or None (zeros).
    Returns (prev [B,nc,H,P,N], the state entering each chunk; final
    [B,H,P,N]), f32, bitwise ``ref.ssd_state_pass_ref``. CUDA tensors
    only."""
    refuse_dtensor("the SSD state-pass kernel", states, chunk_decay,
                   initial_state)
    refuse_grad("the SSD state-pass kernel", states, chunk_decay,
                initial_state)
    if states.dim() != 5 or tuple(chunk_decay.shape) != tuple(states.shape[:3]):
        raise ValueError(f"bad shapes: states {tuple(states.shape)}, "
                         f"chunk_decay {tuple(chunk_decay.shape)}")
    bs, nc, h, p, n = states.shape
    init = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (bs, h, p, n):
            raise ValueError(f"initial_state {tuple(initial_state.shape)}, "
                             f"want {(bs, h, p, n)}")
        init = initial_state.float().contiguous()
    for name, t in (("states", states), ("chunk_decay", chunk_decay),
                    ("initial_state", init)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != states.device:
            raise ValueError(f"needs CUDA tensors on one device, {name} is "
                             f"on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    prev = torch.empty_like(states)
    final = torch.empty((bs, h, p, n), dtype=torch.float32,
                        device=states.device)
    if final.numel():
        SSD.launch("ssd_state_pass", states.data_ptr(),
                   chunk_decay.data_ptr(),
                   None if init is None else init.data_ptr(),
                   prev.data_ptr(), final.data_ptr(), bs, nc, h, p * n,
                   device=states.device)
    return prev, final
