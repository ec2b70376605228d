"""Kimi Delta Attention (KDA; Kimi Linear, arXiv:2510.26692 §3) over a
per-head matrix state.

For token t and hidden state x, with H heads of width d (keys and values
alike, ``cfg.kda_head_dim``):

- q, k, v = x W_q, x W_k, x W_v (H d wide each; one product, ``wqkv``),
  each through its own causal depthwise conv of width
  ``cfg.kda_conv_width`` (no bias), then SiLU;
- q and k L2-normalised per head (eps 1e-6), q times d^-1/2;
- beta_t = sigmoid(x W_beta), one a head;
- g_t = -exp(A_log) softplus(x W_f_down W_f_up + dt_bias), the log decay
  per key channel (A_log one a head, dt_bias one a channel);
- S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T,
  o_t = S_t^T q_t (``kernels/kda``);
- out = W_o (RMSNorm(o_t) per head, times ``o_norm``, times
  sigmoid(x W_g_down W_g_up + g_bias)).

The low-rank gates (``kda_gate_rank`` wide) follow the ``fla`` package's
``KimiDeltaAttention``. The products run in the model's type; the gates,
the norms and the state in float32; q, k and v reach the delta rule in the
model's type. Between the projections the layer is four calls of
``kernels/kda`` (one launch each on the card, the chunked prefill two):
``kda_prep`` (the convs, SiLU, the norms, the decay and beta), the delta
rule (``kda_chunk`` or ``kda_step``) and ``kda_out`` (the gated norm).

The decode state of a layer is a :class:`KDAState`: the f32 state [B, H,
d, d] (keys by values), which the kernels update in place, and the conv
tail [B, W-1, 3 H d] of the three convs' inputs, which this module
returns new. A sequence (prefill, or a forward with no state) runs the
chunked prefill from the state given (zeros without one); a one-token step
with a state runs the decode step. While a profiler records, a prefill's
mixer between its input and output projections (the convs, the gates, the
chunked scan and the gated norm) is a span named ``kda.prefill``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.kda.ops import kda_chunk, kda_out, kda_prep, kda_step
from repro_torch.utils import trace


class KDAState(NamedTuple):
    """KDA's decode state for one layer (or, stacked, for all)."""

    kda: torch.Tensor  # [(L,) B, H, d, d] f32, keys by values
    conv: torch.Tensor  # [(L,) B, W-1, 3 H d] the convs' input tail


def kda_params(generator: torch.Generator, cfg, dtype: torch.dtype,
               device=None) -> dict:
    """``wqkv`` [D, 3 H d] (q's columns, then k's, then v's), ``conv_w``
    [W, 3 H d], ``w_beta`` [D, H], ``f_down`` [D, r], ``f_up`` [r, H d],
    ``dt_bias`` [H d] f32, ``a_log`` [H] f32, ``g_down`` [D, r], ``g_up``
    [r, H d], ``g_bias`` [H d] f32, ``o_norm`` [d] f32, ``wo`` [H d, D];
    the products' weights normal with sd 1/sqrt(fan-in), A_log and dt_bias
    as the fla package initialises them, drawn on the generator's
    device."""
    d, h, hd = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim
    r, w = cfg.kda_gate_rank, cfg.kda_conv_width
    g_dev = generator.device
    f32 = dict(dtype=torch.float32, device=device)

    def draw(shape, dt=dtype):
        t = torch.randn(shape, generator=generator, device=g_dev)
        return (t / math.sqrt(shape[0])).to(device, dt)

    return {"wqkv": draw((d, 3 * h * hd)), "conv_w": draw((w, 3 * h * hd)),
            "w_beta": draw((d, h)), "f_down": draw((d, r)),
            "f_up": draw((r, h * hd)), "dt_bias": _dt_bias(generator, h * hd,
                                                          device),
            "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "g_down": draw((d, r)), "g_up": draw((r, h * hd)),
            "g_bias": torch.zeros(h * hd, **f32),
            "o_norm": torch.ones(hd, **f32), "wo": draw((h * hd, d))}


def _dt_bias(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """softplus^-1 of dt, dt log-uniform over [0.001, 0.1] (the fla
    package's initialisation), f32."""
    u = torch.rand(n, generator=generator, device=generator.device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return (dt + torch.log(-torch.expm1(-dt))).to(device, torch.float32)


def kda_state_zeros(cfg, batch: int, dtype: torch.dtype,
                    device=None) -> KDAState:
    h, hd = cfg.kda_heads, cfg.kda_head_dim
    return KDAState(
        torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.kda_conv_width - 1, 3 * h * hd),
                    dtype=dtype, device=device))


def kda_apply(p: dict, x: torch.Tensor, cfg, *,
              state: KDAState | None = None
              ) -> tuple[torch.Tensor, KDAState | None]:
    """x [B, S, D] -> (out [B, S, D], the new state or None). With a
    state its ``kda`` tensor is updated in place (and returned in the new
    state beside the new conv tail); without one a sequence starts from
    zeros."""
    b, s, _ = x.shape
    h, hd = cfg.kda_heads, cfg.kda_head_dim
    step = state is not None and s == 1
    qkv = x @ p["wqkv"]
    with trace.span("kda.step" if step else "kda.prefill"):
        tail = state.conv if state is not None else None
        q, k, v, g, beta = kda_prep(qkv, p["conv_w"], tail,
                                    x @ p["f_down"] @ p["f_up"],
                                    p["dt_bias"], p["a_log"],
                                    x @ p["w_beta"], hd)
        st = state.kda if state is not None else torch.zeros(
            (b, h, hd, hd), dtype=torch.float32, device=x.device)
        if step:
            o = kda_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0],
                         st)[:, None]
        else:
            o = kda_chunk(q, k, v, g, beta, st)
        out = kda_out(o, x @ p["g_down"] @ p["g_up"], p["g_bias"],
                      p["o_norm"], cfg.norm_eps)
    new = None
    if state is not None:  # the convs' last W - 1 inputs
        keep = cfg.kda_conv_width - 1
        new = KDAState(st, (qkv if s >= keep else torch.cat(
            [tail.to(qkv.dtype), qkv], dim=1))[:, -keep:])
    return out @ p["wo"], new
