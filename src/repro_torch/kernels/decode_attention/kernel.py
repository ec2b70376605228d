"""Bindings of the hand-written CUDA decode-attention kernels: the GQA
kernel (``csrc/decode_attention.cu``) and the latent one
(``csrc/mla_decode.cu``).

Neither replaces a TPU kernel: the reference's decode attention is XLA's,
and the reference has no latent attention. The C entry
``decode_attention`` launches the kernel that splits each slot's live
cache rows into chunks of :data:`CHUNK` and the one that merges them;
``DECODE.launches`` counts the entry's calls, and while a profiler records
each call also ticks the tracer's ``attn.decode`` counter. The C entry
``mla_decode`` does the same for multi-head latent attention's absorbed
decode (16 or 32 heads against 576-wide latent rows whose first 512
columns are the value, both products on the tensor cores); ``MLA.launches`` counts
it, and each call ticks ``attn.decode_latent``. The sources' headers say
what bounds each on an H100 and how the design answers that. A CPU tensor
takes the plain versions (``ref.py``); a CUDA tensor launches a kernel or
raises ``ValueError``."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, L, P, CudaLibrary, refuse_dtensor, refuse_grad)
from repro_torch.utils import trace

DECODE = CudaLibrary(
    "decode_attention",
    Path(__file__).with_name("csrc") / "decode_attention.cu",
    {"decode_attention": [P, P, P, P, L, L, P, P, P, L, L, L, L, L, I, I, I,
                          I, I, ctypes.c_float, P]})

MLA = CudaLibrary(
    "mla_decode",
    Path(__file__).with_name("csrc") / "mla_decode.cu",
    {"mla_decode": [P, P, P, L, L, P, P, P, L, L, L, I, I, I,
                    ctypes.c_float, P]})

HEAD_DIMS = (64, 128)  # the head dims it is compiled for
GROUPS = (1, 2, 4, 8)  # query heads a KV head, H / Hkv
CHUNK = 256  # cache rows a block of the split kernel (kChunk)
MLA_HEADS = (16, 32)  # query heads of the latent kernel (kHeads)
MLA_ROW = 576  # a latent row: c, then the roped key (kRow)
MLA_VALUE = 512  # the value: a row's first columns (kValue)


def fits(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the kernel is built for these dtypes and widths: bf16 q and
    cache, a head dim of :data:`HEAD_DIMS`, a group of :data:`GROUPS`."""
    return (q.dtype == k.dtype == torch.bfloat16
            and q.shape[-1] == k.shape[-1] and q.shape[-1] in HEAD_DIMS
            and q.shape[2] % k.shape[2] == 0
            and q.shape[2] // k.shape[2] in GROUPS)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want q [B, "
                         f"1, H, Dh] and k, v [B, S_max, Hkv, Dh]")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"needs CUDA tensors on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not fits(q, k) or v.dtype != k.dtype:
        raise ValueError(
            f"the kernel is built for bf16, head dims {HEAD_DIMS} and "
            f"groups {GROUPS}: got {q.dtype} / {k.dtype} / {v.dtype}, head "
            f"dim {q.shape[-1]}, {q.shape[2]} / {k.shape[2]} heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # heads and dims contiguous; 16-byte loads need every row start on
        # 16 bytes
        if (t.stride(3) != 1 or t.stride(2) != t.shape[3]
                or t.data_ptr() % 16 or t.stride(0) % 8
                or (t is not q and t.stride(1) % 8)):
            raise ValueError(f"{name} {tuple(t.shape)} strides "
                             f"{t.stride()}: rows of contiguous heads, "
                             f"starting on 16 bytes")


def decode_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length, *, scale: float | None = None
                          ) -> torch.Tensor:
    """q: [B, 1, H, Dh]; k, v: [B, S_max, Hkv, Dh], the cache read where it
    lies (after this step's row was written); ``length`` the cached tokens
    before this step, an int (passed to the kernel as an argument, no
    host-to-device copy), a 0-d tensor or [B] per-slot lengths, at least
    0: slot b attends its rows j < min(length_b + 1, S_max). Returns [B, 1,
    H, Dh] in bf16. CUDA tensors only (``ops.decode_attention`` takes the
    plain version for CPU tensors); no backward."""
    refuse_dtensor("the decode attention kernel", q, k, v)
    refuse_grad("the decode attention kernel", q, k, v)
    _check(q, k, v)
    b, _, h, dh = q.shape
    s_max = k.shape[1]
    len_ptr, len_int, len_stride = None, 0, 0
    if isinstance(length, torch.Tensor):
        if length.dim() > 1 or (length.dim() == 1
                                and length.shape[0] != b):
            raise ValueError(f"length {tuple(length.shape)}: want an int, "
                             f"a 0-d or a [{b}] tensor")
        length = length.to(q.device, torch.int64)  # held through the launch
        len_ptr = length.data_ptr()
        len_stride = length.stride(0) if length.dim() else 0
    else:
        len_int = int(length)
    n_chunks = -(-s_max // CHUNK)
    part_acc = torch.empty((b, n_chunks, h, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, n_chunks, h, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    DECODE.launch("decode_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), len_ptr, len_int, len_stride,
                  part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                  q.stride(0), k.stride(0), k.stride(1), v.stride(0),
                  v.stride(1), b, h, k.shape[2], s_max, dh, scale,
                  device=q.device)
    trace.count("attn.decode")
    return out


def _lengths(length, b: int, device) -> tuple:
    """(pointer or None, int, stride, tensor or None) of an int, 0-d or
    [B] ``length``: the kernel's three length arguments, and the int64
    tensor the pointer reads, to be held through the launch."""
    if isinstance(length, torch.Tensor):
        if length.dim() > 1 or (length.dim() == 1
                                and length.shape[0] != b):
            raise ValueError(f"length {tuple(length.shape)}: want an int, "
                             f"a 0-d or a [{b}] tensor")
        length = length.to(device, torch.int64)
        return (length.data_ptr(), 0,
                length.stride(0) if length.dim() else 0, length)
    return None, int(length), 0, None


def mla_decode_bsd(q: torch.Tensor, rows: torch.Tensor, length, *,
                   scale: float, value_dim: int = MLA_VALUE
                   ) -> torch.Tensor:
    """q: [B, H, 576], H 16 or 32 (the absorbed no-rope query, then the
    roped one);
    rows: [B, S_max, 576], the latent cache read where it lies (after this
    step's row was written); ``length`` the cached tokens before this
    step, an int, a 0-d tensor or [B] per-slot lengths, at least 0: slot b
    attends its rows j < min(length_b + 1, S_max), the scores ``scale``
    times q . row, the values each row's first ``value_dim`` columns.
    Returns [B, H, value_dim] in bf16. CUDA tensors only (the plain
    version, ``ref.mla_decode_ref``, takes any); no backward."""
    refuse_dtensor("the latent decode kernel", q, rows)
    refuse_grad("the latent decode kernel", q, rows)
    if (q.dim() != 3 or rows.dim() != 3 or rows.shape[0] != q.shape[0]
            or not q.dtype == rows.dtype == torch.bfloat16
            or q.shape[1] not in MLA_HEADS or q.shape[2] != MLA_ROW
            or rows.shape[2] != MLA_ROW or value_dim != MLA_VALUE):
        raise ValueError(
            f"the latent kernel is built for bf16 q [B, H, {MLA_ROW}], H "
            f"in {MLA_HEADS}, rows [B, S_max, {MLA_ROW}] and values of "
            f"{MLA_VALUE}: got {q.dtype} {tuple(q.shape)}, {rows.dtype} "
            f"{tuple(rows.shape)}, values of {value_dim}")
    if q.device.type != "cuda" or rows.device != q.device:
        raise ValueError(f"needs CUDA tensors on one device, got {q.device}, "
                         f"{rows.device}")
    for name, t in (("q", q), ("rows", rows)):
        if (t.stride(2) != 1 or t.data_ptr() % 16 or t.stride(0) % 8
                or t.stride(1) % 8 or (t is q and t.stride(1) != MLA_ROW)):
            raise ValueError(f"{name} {tuple(t.shape)} strides "
                             f"{t.stride()}: contiguous rows starting on "
                             f"16 bytes")
    b, h, s_max = q.shape[0], q.shape[1], rows.shape[1]
    len_ptr, len_int, len_stride, _held = _lengths(length, b, q.device)
    n_chunks = -(-s_max // CHUNK)
    part_acc = torch.empty((b, n_chunks, h, MLA_VALUE),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, n_chunks, h, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((b, h, MLA_VALUE), dtype=q.dtype, device=q.device)
    MLA.launch("mla_decode", q.data_ptr(), rows.data_ptr(), len_ptr,
               len_int, len_stride, part_acc.data_ptr(), part_ml.data_ptr(),
               out.data_ptr(), q.stride(0), rows.stride(0), rows.stride(1),
               b, s_max, h, float(scale), device=q.device)
    trace.count("attn.decode_latent")
    return out
