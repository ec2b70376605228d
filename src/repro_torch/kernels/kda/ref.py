"""Plain PyTorch versions of the KDA kernels (``csrc/kda.cu``): the path
for CPU tensors, and what the kernels are held against on the card.

Kimi Delta Attention (arXiv:2510.26692), per head, with a state S of
[d_k, d_v], a decay a_t = exp(g_t) per key channel (g_t <= 0) and a
scalar beta_t:

    S_t = (I - beta_t k_t k_t^T) Diag(a_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

:func:`kda_recurrent_ref` runs that token by token (the oracle of the
tests). :func:`kda_chunk_ref` is the chunkwise form the prefill kernel
computes, in chunks of C tokens with G_t the decay's cumulative sum from
the chunk's start (Gamma_t = exp(G_t)):

- A[t, s] = beta_t sum_i k_t,i k_s,i exp(G_t,i - G_s,i) for s < t, and
  M[t, s] = sum_i q_t,i k_s,i exp(G_t,i - G_s,i) for s <= t: every
  exponent is at most 0;
- T = (I + A)^-1 (unit lower triangular, by forward substitution):
  W = T diag(beta) (Gamma * K), U0 = T diag(beta) V;
- from the state S entering the chunk: U = U0 - W S, O = (Gamma * Q) S +
  M U, and the state leaving it Diag(Gamma_C) S + (K exp(G_C - G))^T U.

:func:`kda_step_ref` is one token for every slot, the decode kernel's
work. Every version computes in float32, updates ``state`` (float32) in
place and returns o in v's type. :func:`kda_prep_ref` (the short convs,
SiLU, the L2 norms and the gates) and :func:`kda_out_ref` (the gated
output norm) are the work around them, which the card does in one launch
each."""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 64  # tokens a chunk of the chunkwise form (the kernel's kC)
L2_EPS = 1e-6  # q's and k's L2 norms' eps


def kda_recurrent_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor, beta: torch.Tensor,
                      state: torch.Tensor) -> torch.Tensor:
    """q, k: [B, S, H, Dk]; v: [B, S, H, Dv]; g: [B, S, H, Dk] (the log
    decay, at most 0); beta: [B, S, H]; state: [B, H, Dk, Dv] float32,
    updated in place. Returns o [B, S, H, Dv] in v's type."""
    st = state.float()
    outs = []
    for t in range(q.shape[1]):
        o_t, st = _step(q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t], st)
        outs.append(o_t)
    state.copy_(st)
    return torch.stack(outs, 1).to(v.dtype)


def _step(q, k, v, g, beta, st):
    """One token: q, k [B, H, Dk], v [B, H, Dv], g [B, H, Dk], beta [B,
    H], st [B, H, Dk, Dv] f32 -> (o [B, H, Dv] f32, the new state)."""
    k = k.float()
    st = st * g.float().exp()[..., None]
    u = torch.einsum("bhk,bhkv->bhv", k, st)
    d = beta.float()[..., None] * (v.float() - u)
    st = st + k[..., None] * d[..., None, :]
    return torch.einsum("bhk,bhkv->bhv", q.float(), st), st


def kda_step_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, beta: torch.Tensor,
                 state: torch.Tensor) -> torch.Tensor:
    """One decode token a slot: q, k [B, H, Dk], v [B, H, Dv], g [B, H,
    Dk], beta [B, H]; state [B, H, Dk, Dv] float32, updated in place.
    Returns o [B, H, Dv] in v's type."""
    o, st = _step(q, k, v, g, beta, state.float())
    state.copy_(st)
    return o.to(v.dtype)


def kda_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor,
                  *, chunk: int = CHUNK) -> torch.Tensor:
    """:func:`kda_recurrent_ref` in the chunkwise form (the module's
    docstring): the same arguments, ``state`` the state entering the
    sequence, updated in place to the one leaving it. A sequence that
    ``chunk`` does not divide is padded with tokens whose k, q, v, beta
    and g are 0 (no decay, no write)."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    pad = (-s) % chunk
    n = (s + pad) // chunk

    def blocks(t: torch.Tensor) -> torch.Tensor:  # [B, H, N, C, ...]
        t = t.float()
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, n, chunk, h, *t.shape[3:])
        return t.movedim(3, 1)

    qc, kc, vc, gc = blocks(q), blocks(k), blocks(v), blocks(g)
    bc = blocks(beta)  # [B, H, N, C]
    cum = gc.cumsum(3)  # G: [B, H, N, C, Dk]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=q.device).tril()
    # exp(G_t - G_s) k_s over the causal pairs (zero above the diagonal)
    diff = cum[..., :, None, :] - cum[..., None, :, :]  # [.., t, s, Dk]
    ek = torch.where(causal[..., None], diff, -torch.inf).exp() \
        * kc[..., None, :, :]
    a = torch.einsum("...tsd,...td->...ts", ek, kc) * bc[..., None]
    a = a * (~torch.eye(chunk, dtype=torch.bool, device=q.device))
    m = torch.einsum("...tsd,...td->...ts", ek, qc)
    eye = torch.eye(chunk, device=q.device)
    gam = cum.exp()
    rhs = torch.cat([bc[..., None] * gam * kc, bc[..., None] * vc], -1)
    x = torch.linalg.solve_triangular(eye + a, rhs, upper=False,
                                      unitriangular=True)
    w, u0 = x.split([dk, dv], -1)
    qg = qc * gam
    kend = kc * (cum[..., -1:, :] - cum).exp()
    last = gam[..., -1, :]  # [B, H, N, Dk]
    st = state.float()
    outs = []
    for z in range(n):
        u = u0[:, :, z] - w[:, :, z] @ st
        outs.append(qg[:, :, z] @ st + m[:, :, z] @ u)
        st = last[:, :, z, :, None] * st + kend[:, :, z].transpose(-1, -2) @ u
    state.copy_(st)
    o = torch.stack(outs, 2).reshape(b, h, n * chunk, dv)[:, :, :s]
    return o.transpose(1, 2).to(v.dtype)


def kda_prep_ref(qkv: torch.Tensor, conv_w: torch.Tensor,
                 tail: torch.Tensor | None, f: torch.Tensor,
                 dt_bias: torch.Tensor, a_log: torch.Tensor,
                 b_raw: torch.Tensor, head_dim: int):
    """KDA's inputs to the delta rule from its projections. qkv [B, S, 3 H
    d] (q's columns, then k's, then v's), each column through its causal
    depthwise conv ``conv_w`` [W, 3 H d] (no bias; ``tail`` [B, W-1, 3 H
    d] the inputs before, zeros where None), summed tap by tap in f32,
    then SiLU; q and k L2-normalised per head (eps ``L2_EPS``), q times
    d^-1/2; q, k and v rounded to qkv's type once. f [B, S, H d] the decay
    gate's projection: g = -exp(a_log) softplus(f + dt_bias), f32; b_raw
    [B, S, H]: beta = sigmoid(b_raw), f32. Returns (q, k, v [B, S, H, d]
    in qkv's type, g [B, S, H, d], beta [B, S, H])."""
    b, s, _ = qkv.shape
    width = conv_w.shape[0]
    zp = (F.pad(qkv, (0, 0, width - 1, 0)) if tail is None
          else torch.cat([tail.to(qkv.dtype), qkv], dim=1))
    w = conv_w.float()
    y = zp[:, 0:s].float() * w[0]
    for i in range(1, width):
        y = y + zp[:, i:i + s].float() * w[i]
    q, k, v = F.silu(y).view(b, s, 3, -1, head_dim).unbind(2)
    h = q.shape[2]
    g = F.softplus(f.float() + dt_bias).view(b, s, h, head_dim) \
        * -torch.exp(a_log)[:, None]
    return (_l2(q, head_dim ** -0.5).to(qkv.dtype), _l2(k).to(qkv.dtype),
            v.to(qkv.dtype), g, torch.sigmoid(b_raw.float()))


def _l2(t: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """t [..., d] f32 over its last dim: t / sqrt(sum t^2 + eps), times
    ``scale``."""
    out = t * torch.rsqrt(t.square().sum(-1, keepdim=True) + L2_EPS)
    return out * scale if scale != 1.0 else out


def kda_out_ref(o: torch.Tensor, g_raw: torch.Tensor, g_bias: torch.Tensor,
                o_norm: torch.Tensor, eps: float) -> torch.Tensor:
    """KDA's gated output norm: o [B, S, H, d] RMS-normalised over each
    head's values (eps ``eps``), times ``o_norm`` [d], times sigmoid(g_raw
    + g_bias) (g_raw [B, S, H d], the output gate's projection), in f32.
    Returns [B, S, H d] in o's type."""
    b, s, h, d = o.shape
    gate = torch.sigmoid(g_raw.float() + g_bias).view(b, s, h, d)
    of = o.float()
    of = of * torch.rsqrt(of.square().mean(-1, keepdim=True) + eps)
    return (of * o_norm * gate).to(o.dtype).reshape(b, s, h * d)
