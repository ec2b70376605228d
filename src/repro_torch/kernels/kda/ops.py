"""Public wrappers: KDA's chunked prefill and its decode step over a
per-head f32 state, updated in place, and the layer's work around them
(``kda_prep``: the short convs, the norms and the gates; ``kda_out``: the
gated output norm).

Device rule: a CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel (``kernel.py``) or raises. While a profiler
records, a prefill adds the tokens it took to the tracer's
``kda.scan_tokens`` counter and a decode step ticks ``kda.step`` (inside a
decode graph's capture the tally keeps it, and each replay adds it
again)."""

from __future__ import annotations

import torch

from repro_torch.kernels.kda.kernel import (
    kda_chunk_call, kda_out_call, kda_prep_call, kda_step_call)
from repro_torch.kernels.kda.ref import (
    kda_chunk_ref, kda_out_ref, kda_prep_ref, kda_step_ref)
from repro_torch.utils import trace


def kda_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, beta: torch.Tensor,
              state: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, S, H, D]; g [B, S, H, D] f32; beta [B, S, H] f32; state
    [B, H, D, D] f32, entering the sequence, overwritten with the state
    leaving it. Returns o [B, S, H, D] in v's type."""
    trace.count("kda.scan_tokens", q.shape[0] * q.shape[1])
    if q.device.type == "cpu":
        return kda_chunk_ref(q, k, v, g, beta, state)
    return kda_chunk_call(q, k, v, g, beta, state)


def kda_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor, beta: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """One token a slot: q, k, v [B, H, D]; g [B, H, D] f32; beta [B, H]
    f32; state [B, H, D, D] f32, stepped in place. Returns o [B, H, D] in
    v's type."""
    trace.count("kda.step")
    if q.device.type == "cpu":
        return kda_step_ref(q, k, v, g, beta, state)
    return kda_step_call(q, k, v, g, beta, state)


def kda_prep(qkv: torch.Tensor, conv_w: torch.Tensor,
             tail: torch.Tensor | None, f: torch.Tensor,
             dt_bias: torch.Tensor, a_log: torch.Tensor, b_raw: torch.Tensor,
             head_dim: int):
    """(q, k, v, g, beta) from the projections (``ref.kda_prep_ref``)."""
    if qkv.device.type == "cpu":
        return kda_prep_ref(qkv, conv_w, tail, f, dt_bias, a_log, b_raw,
                            head_dim)
    return kda_prep_call(qkv, conv_w, tail, f, dt_bias, a_log, b_raw,
                         head_dim)


def kda_out(o: torch.Tensor, g_raw: torch.Tensor, g_bias: torch.Tensor,
            o_norm: torch.Tensor, eps: float) -> torch.Tensor:
    """The gated output norm [B, S, H d] (``ref.kda_out_ref``)."""
    if o.device.type == "cpu":
        return kda_out_ref(o, g_raw, g_bias, o_norm, eps)
    return kda_out_call(o, g_raw, g_bias, o_norm, eps)
