"""Binding of the hand-written CUDA KDA kernels (``csrc/kda.cu``).

Neither replaces a TPU kernel: the reference package has no linear
attention. The C entry ``kda_chunk`` is the chunked prefill, two launches
a call whatever the length (``kda_intra_kernel`` over every chunk at once,
then ``kda_state_kernel`` walking the chunks in order); ``kda_step`` is the
decode step, one launch a call for every slot and head, its state read
once and written once in place. ``KDA.launches`` counts the entries'
calls (``ops.py`` ticks the tracer's counters). The source's header says
what bounds each on an H100 and how the design answers that. A CPU tensor
takes the plain versions (``ref.py``, through ``ops.py``); a CUDA tensor
launches a kernel or raises ``ValueError``. The entries ``kda_prep``
(the three short convs, SiLU, the L2 norms, the decay and beta) and
``kda_out`` (the gated output norm) are the layer's work around the delta
rule, one launch each where the plain version takes some twenty passes
over the activations."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, L, P, CudaLibrary, refuse_dtensor, refuse_grad)

KDA = CudaLibrary(
    "kda", Path(__file__).with_name("csrc") / "kda.cu",
    {"kda_chunk": [P, P, P, P, P, P, P, P, P, P, P, P, P, L, L, L, L, L, L,
                   L, L, L, I, I, I, P],
     "kda_step": [P, P, P, P, P, P, P, L, L, L, L, L, L, I, I, P],
     "kda_prep": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, P],
     "kda_out": [P, P, P, P, P, I, I, ctypes.c_float, P]})

HEAD_DIM = 128  # the key and value width of a head (kD)
CHUNK = 64  # tokens a chunk of the prefill (kC)


def _check(q, k, v, g, beta, state, lead: int) -> None:
    """q, k, v: [*lead, H, 128] bf16 with the last dim contiguous; g: the
    same shape, f32, contiguous; beta: [*lead, H] f32 contiguous; state
    [B, H, 128, 128] f32 contiguous; all on one CUDA device."""
    shape = tuple(q.shape)
    if (q.dim() != lead + 2 or tuple(k.shape) != shape
            or tuple(v.shape) != shape or tuple(g.shape) != shape
            or tuple(beta.shape) != shape[:-1] or shape[-1] != HEAD_DIM
            or tuple(state.shape) != (shape[0], shape[-2], HEAD_DIM,
                                      HEAD_DIM)):
        raise ValueError(
            f"the KDA kernels are built for heads of {HEAD_DIM}: got q "
            f"{shape}, k {tuple(k.shape)}, v {tuple(v.shape)}, g "
            f"{tuple(g.shape)}, beta {tuple(beta.shape)}, state "
            f"{tuple(state.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g), ("beta", beta),
                    ("state", state)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"needs CUDA tensors on one device, {name} is "
                             f"on {t.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and g.dtype == beta.dtype == state.dtype == torch.float32):
        raise ValueError(f"the KDA kernels take bf16 q, k, v and f32 g, "
                         f"beta and state: got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {g.dtype}, {beta.dtype}, "
                         f"{state.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or not all(
            t.is_contiguous() for t in (g, beta, state)):
        raise ValueError("q, k and v need a contiguous last dim; g, beta "
                         "and state must be contiguous")


def kda_chunk_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor,
                   state: torch.Tensor) -> torch.Tensor:
    """The chunked prefill: q, k, v [B, S, H, 128] bf16 (q normalised and
    scaled, k normalised); g [B, S, H, 128] f32 (the log decay, at most 0);
    beta [B, S, H] f32; state [B, H, 128, 128] f32, the state entering
    the sequence, overwritten in place with the one leaving it. Returns o
    [B, S, H, 128] bf16. CUDA tensors only; no backward."""
    refuse_dtensor("the KDA prefill kernel", q, k, v, g, beta, state)
    refuse_grad("the KDA prefill kernel", q, k, v, g, beta)
    _check(q, k, v, g, beta, state, 2)
    b, s, h, d = q.shape
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    w, u0, qg, kend = (torch.empty((b, nc, h, CHUNK, d), **f32)
                       for _ in range(4))
    m = torch.empty((b, nc, h, CHUNK, CHUNK), **f32)
    gamma = torch.empty((b, nc, h, d), **f32)
    o = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    if o.numel():
        KDA.launch("kda_chunk", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   g.data_ptr(), beta.data_ptr(), w.data_ptr(),
                   u0.data_ptr(), qg.data_ptr(), kend.data_ptr(),
                   m.data_ptr(), gamma.data_ptr(), state.data_ptr(),
                   o.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                   *v.stride()[:3], b, s, h, device=q.device)
    return o


def kda_step_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, beta: torch.Tensor,
                  state: torch.Tensor) -> torch.Tensor:
    """One decode token for every slot: q, k, v [B, H, 128] bf16; g [B, H,
    128] f32; beta [B, H] f32; state [B, H, 128, 128] f32, stepped in
    place. Returns o [B, H, 128] bf16. CUDA tensors only; no backward."""
    refuse_dtensor("the KDA decode kernel", q, k, v, g, beta, state)
    refuse_grad("the KDA decode kernel", q, k, v, g, beta)
    _check(q, k, v, g, beta, state, 1)
    b, h, _ = q.shape
    o = torch.empty((b, h, HEAD_DIM), dtype=v.dtype, device=q.device)
    KDA.launch("kda_step", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               g.data_ptr(), beta.data_ptr(), state.data_ptr(), o.data_ptr(),
               *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], b, h,
               device=q.device)
    return o


CONV_WIDTH = 4  # the short convs' taps (kW)


def _cuda_bf16(what: str, device, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous bf16 CUDA tensors on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _cuda_f32(what: str, device, *tensors) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous f32 CUDA tensors on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def kda_prep_call(qkv: torch.Tensor, conv_w: torch.Tensor,
                  tail: torch.Tensor | None, f: torch.Tensor,
                  dt_bias: torch.Tensor, a_log: torch.Tensor,
                  b_raw: torch.Tensor, head_dim: int):
    """``ref.kda_prep_ref`` in one launch: qkv [B, S, 3 H 128], conv_w [4,
    3 H 128], tail [B, 3, 3 H 128] or None, f [B, S, H 128], b_raw [B, S,
    H], bf16; dt_bias [H 128], a_log [H], f32. Returns (q, k, v [B, S, H,
    128] bf16, g [B, S, H, 128] f32, beta [B, S, H] f32). CUDA tensors only;
    no backward."""
    refuse_dtensor("the KDA prologue kernel", qkv, conv_w, tail, f, b_raw)
    refuse_grad("the KDA prologue kernel", qkv, conv_w, f, b_raw)
    b, s, width = qkv.shape
    h = a_log.shape[0]
    if (qkv.device.type != "cuda" or head_dim != HEAD_DIM
            or width != 3 * h * HEAD_DIM
            or tuple(conv_w.shape) != (CONV_WIDTH, width)
            or (tail is not None
                and tuple(tail.shape) != (b, CONV_WIDTH - 1, width))
            or tuple(f.shape) != (b, s, h * HEAD_DIM)
            or tuple(b_raw.shape) != (b, s, h)
            or tuple(dt_bias.shape) != (h * HEAD_DIM,)):
        raise ValueError(
            f"the KDA kernels are built for heads of {HEAD_DIM} and convs of "
            f"{CONV_WIDTH}: got qkv {tuple(qkv.shape)} on {qkv.device}, "
            f"conv_w {tuple(conv_w.shape)}, f {tuple(f.shape)}, b_raw "
            f"{tuple(b_raw.shape)}, {h} heads of {head_dim}")
    _cuda_bf16("the KDA prologue kernel", qkv.device, qkv, conv_w, tail, f,
               b_raw)
    _cuda_f32("the KDA prologue kernel", qkv.device, dt_bias, a_log)
    shape = (b, s, h, HEAD_DIM)
    q, k, v = (torch.empty(shape, dtype=qkv.dtype, device=qkv.device)
               for _ in range(3))
    g = torch.empty(shape, dtype=torch.float32, device=qkv.device)
    beta = torch.empty((b, s, h), dtype=torch.float32, device=qkv.device)
    if q.numel():
        KDA.launch("kda_prep", qkv.data_ptr(), conv_w.data_ptr(),
                   None if tail is None else tail.data_ptr(), f.data_ptr(),
                   b_raw.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(),
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                   beta.data_ptr(), b, s, h, device=qkv.device)
    return q, k, v, g, beta


def kda_out_call(o: torch.Tensor, g_raw: torch.Tensor, g_bias: torch.Tensor,
                 o_norm: torch.Tensor, eps: float) -> torch.Tensor:
    """``ref.kda_out_ref`` in one launch: o [B, S, H, 128] bf16, g_raw [B,
    S, H 128] bf16, g_bias [H 128] and o_norm [128] f32. Returns [B, S, H
    128] bf16. CUDA tensors only; no backward."""
    refuse_dtensor("the KDA output kernel", o, g_raw)
    refuse_grad("the KDA output kernel", o, g_raw)
    b, s, h, d = o.shape
    if (o.device.type != "cuda" or d != HEAD_DIM
            or tuple(g_raw.shape) != (b, s, h * d)
            or tuple(g_bias.shape) != (h * d,)
            or tuple(o_norm.shape) != (d,)):
        raise ValueError(
            f"the KDA kernels are built for heads of {HEAD_DIM}: got o "
            f"{tuple(o.shape)} on {o.device}, g_raw {tuple(g_raw.shape)}")
    _cuda_bf16("the KDA output kernel", o.device, o, g_raw)
    _cuda_f32("the KDA output kernel", o.device, g_bias, o_norm)
    out = torch.empty((b, s, h * d), dtype=o.dtype, device=o.device)
    if out.numel():
        KDA.launch("kda_out", o.data_ptr(), g_raw.data_ptr(),
                   g_bias.data_ptr(), o_norm.data_ptr(), out.data_ptr(),
                   b * s, h, float(eps), device=o.device)
    return out
