"""Mamba2 / SSD (state-space duality) block — chunked scan formulation.

Implements the SSD algorithm of Dao & Gu (arXiv:2405.21060): the sequence is
split into chunks of length Q; within a chunk the output is computed with a
quadratic (attention-like) masked matmul, and chunk-boundary states are
carried by a linear recurrence across chunks.

Layout convention (following the Mamba2 reference):
  x  : [B, S, H, P]   (H = d_inner/P heads)
  dt : [B, S, H]      (softplus-ed, positive)
  A  : [H]            (negative; dA = dt * A)
  B_, C: [B, S, G, N] (G groups broadcast over heads)

``mamba2_apply`` runs the SSD through ``kernels.ssd_scan.ops.ssd_full``:
the hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors. The reference model runs its jnp ``ssd_chunked`` and never
reaches its Pallas kernel; in f32 the two agree to rounding, in bf16 they
round at different points (ssd_full rounds ``x * dt`` and ``C.B * L`` to
x's type, ssd_chunked keeps ``x * dt`` in f32). The port's ``ssd_chunked``
stays as the plain full-SSD oracle of the tests and ``chip_smoke.py``.

The decode state is carried as tensors that the caller updates in place
(``models/lm.py``, ``models/hybrid.py``); this module returns new state
tensors and never writes into the ones it was given.

While a ``torch.profiler`` records, a layer's mixer between its
projections is a span (:mod:`repro_torch.utils.trace`): ``ssm.scan`` over
a sequence (the conv, the SSD and the gated norm), ``ssm.step`` for a
decode's one-token update; the counter ``ssm.scan_tokens`` adds the
padded tokens each scan sends through the SSD (batch x padded length).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels.ssd_scan.ops import ssd_full
from repro_torch.utils import trace


class SSMState(NamedTuple):
    """Decode-time recurrent state for one layer (or, stacked, for all)."""

    ssm: torch.Tensor  # [(L,) B, H, P, N] running state, f32
    conv: torch.Tensor  # [(L,) B, W-1, conv_dim] causal-conv tail


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k], -inf j>i.

    Produces the log of the lower-triangular decay matrix L."""
    q = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def _repeat_groups(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return t.repeat_interleave(rep, dim=dim) if rep > 1 else t


def _einsum_as(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` over mixed dtypes: the operands promoted to their
    common type first (torch's einsum wants one type)."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                initial_state: torch.Tensor | None = None,
                return_final_state: bool = False):
    """Chunked SSD scan, all in torch ops (the reference's model path).

    x: [B, S, H, P]; dt: [B, S, H]; a: [H] (negative); b, c: [B, S, G, N].
    Returns y: [B, S, H, P] (and final state [B, H, P, N] if requested)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h)
    bch = _repeat_groups(b.reshape(bs, nc, chunk, g, n), rep, 3)
    cch = _repeat_groups(c.reshape(bs, nc, chunk, g, n), rep, 3)

    da = dtc * a[None, None, None, :]  # [B, nc, Q, H] (negative)
    da_hbnq = da.permute(0, 3, 1, 2)  # [B, H, nc, Q]
    da_cs = torch.cumsum(da_hbnq, dim=-1)

    # 1) intra-chunk (diagonal block) output
    l_log = segsum(da_hbnq)  # [B, H, nc, Q, Q]
    cb = torch.einsum("bzqhn,bzkhn->bhzqk", cch, bch)
    att = cb * torch.exp(l_log)
    xdt = xc * dtc[..., None]  # [B, nc, Q, H, P] (f32: dt is f32)
    y_diag = _einsum_as("bhzqk,bzkhp->bzqhp", att.to(x.dtype), xdt)

    # 2) chunk-boundary states
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)  # [B, H, nc, Q]
    states = _einsum_as("bzkhn,bhzk,bzkhp->bzhpn", bch, decay_states, xdt)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(da_cs[..., -1])  # [B, H, nc]
    state = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for z in range(nc):
        prev.append(state)  # the state entering chunk z
        state = (state * chunk_decay[:, :, z, None, None]
                 + states[:, z].float())
    prev_states = torch.stack(prev, 0)  # [nc, B, H, P, N]

    # 4) off-diagonal contribution
    state_decay_out = torch.exp(da_cs)  # [B, H, nc, Q]
    y_off = _einsum_as("bzqhn,zbhpn,bhzq->bzqhp", cch, prev_states,
                       state_decay_out).to(x.dtype)

    y = (y_diag + y_off).reshape(bs, s, h, p)
    if return_final_state:
        return y, state
    return y


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Single-token recurrent update. state: [B,H,P,N]; x: [B,H,P];
    dt: [B,H]; b,c: [B,G,N]. Returns (y [B,H,P], new_state)."""
    h = x.shape[1]
    g = b.shape[1]
    rep = h // g
    bh = _repeat_groups(b, rep, 1)  # [B,H,N]
    ch = _repeat_groups(c, rep, 1)
    da = torch.exp(dt * a[None, :])  # [B,H]
    upd = _einsum_as("bhn,bhp->bhpn", bh, x * dt[..., None])
    new = state * da[..., None, None] + upd.float()
    y = torch.einsum("bhpn,bhn->bhp", new.to(x.dtype), ch.to(x.dtype))
    return y, new


# ---------------------------------------------------------------------------
# Full Mamba2 block: in_proj -> causal conv -> SSD -> gated norm -> out_proj
# ---------------------------------------------------------------------------

def mamba2_params(generator: torch.Generator, cfg, dtype: torch.dtype,
                  device=None) -> dict:
    """The reference's shapes and scales, drawn on the generator's device.
    ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_scale`` are f32 in every
    dtype, as in the reference."""
    d, din, n, g, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_groups, cfg.n_ssm_heads, cfg.ssm_conv_width)
    conv_dim = cfg.conv_dim
    g_dev = generator.device
    d_in_proj = 2 * din + 2 * g * n + h

    def draw(shape, scale):
        t = torch.randn(shape, generator=generator, device=g_dev) * scale
        return t.to(device, dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": draw((d, d_in_proj), 1.0 / math.sqrt(d)),
        "conv_w": draw((w, conv_dim), 1.0 / math.sqrt(w)),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.full((h,), math.log(math.e - 1), **f32),
        "norm_scale": torch.ones((din,), **f32),
        "out_proj": draw((din, d), 1.0 / math.sqrt(din)),
    }


def _causal_conv(z: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv1d. z: [B, S, C]; w: [W, C]. Returns (y,
    new_tail), summed tap by tap in z's type as the reference sums."""
    width = w.shape[0]
    if tail is None:
        zp = F.pad(z, (0, 0, width - 1, 0))
    else:
        zp = torch.cat([tail.to(z.dtype), z], dim=1)
    s = z.shape[1]
    y = zp[:, 0:s] * w[0][None, None]
    for i in range(1, width):
        y = y + zp[:, i:i + s] * w[i][None, None]
    new_tail = zp[:, zp.shape[1] - (width - 1):]
    return F.silu(y + bias[None, None]), new_tail


def mamba2_apply(p: dict, x: torch.Tensor, cfg, *,
                 state: SSMState | None = None):
    """x: [B, S, D] -> ([B, S, D], new_state or None).

    With ``state`` and S == 1 the recurrent decode path runs; with ``state``
    and S > 1 (prefill) the SSD starts from it. A ragged S is padded to a
    multiple of the chunk (the padded steps have dt = 0: no decay, no
    input). A ``DTensor`` input or projection takes
    :func:`_sharded_mamba2`."""
    if is_dtensor(x) or is_dtensor(p["in_proj"]):
        return _sharded_mamba2(p, x, cfg, state)
    din, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    z, xbc, dt = torch.split(x @ p["in_proj"], [din, din + 2 * gn,
                                                cfg.n_ssm_heads], dim=-1)
    step = state is not None and x.shape[1] == 1
    with trace.span("ssm.step" if step else "ssm.scan"):
        y, new_state = _mamba2_core(p, z, xbc, dt, cfg, state)
    return y.to(x.dtype) @ p["out_proj"], new_state


def _sharded_mamba2(p: dict, x, cfg, state: SSMState | None):
    """:func:`mamba2_apply` over ``DTensor``s, with the heads on "model"
    where their count divides it (else every "model" rank takes them all)
    and the rows where the batch rule puts them.

    z, x and dt are split by heads; B and C (groups x state) are whole on
    every rank. ``in_proj``'s columns are the segments [z | x | B | C |
    dt], which the rule splits evenly rather than on their boundaries: a
    device holding at least ``d_model`` tokens takes the weight's segments
    (``column_segments``: the weight's bytes move), else (``few_rows``) it
    gathers its rows of the projection (the activations' bytes move). The
    depthwise conv takes each rank's own channels, the scan and the state
    its heads, and the gated RMSNorm over all of ``d_inner`` sums its
    squares over "model" ([B, S, 1]). ``out_proj`` takes ``y`` sharded on
    its input dim (its weight resharded to rows, the products summed over
    "model"), or gathered where the rows are few. Rows replicated on the
    data axes (B = 1) split both projections' contractions over them
    (``contract_on_data``). The running state is read from, and its new
    heads are left in, the placement ``decode_cache_sharding`` gives it
    (slots on the data axes, heads on "model"): under that placement the
    state moves no bytes. A state on another placement (the reference's
    rule, whole over "model") is sliced to the heads and its new heads
    gathered back into it. The conv tail keeps the rule's placement (slots
    on the data axes): its new x channels are gathered over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.sharding import (
        column_segments, contract_on_data, few_rows, model_split,
        shard_placements)

    mesh = (x if is_dtensor(x) else p["in_proj"]).device_mesh
    nd = mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * nd)
    bsz = x.shape[0]
    din, gn, h, pp = (cfg.d_inner, cfg.ssm_groups * cfg.ssm_state,
                      cfg.n_ssm_heads, cfg.ssm_head_dim)
    rows = list(shard_placements(mesh, bsz))
    data = [i for i, q in enumerate(rows) if q.is_shard()]
    m, split, h0, h_l = model_split(mesh, h)
    c0, c1 = h0 * pp, (h0 + h_l) * pp  # this rank's channels of x and z

    def pl(on_data, on_model) -> list:
        return [on_data if i in data else on_model if i == m and split
                else Replicate() for i in range(nd)]

    heads = pl(Shard(0), Shard(2))
    # the gradient of what every "model" rank reads: its own heads' share
    shared = pl(Shard(0), Partial())
    x = x.redistribute(mesh, rows)
    small = not split or few_rows(x)
    if small:
        full = contract_on_data(x, p["in_proj"]).redistribute(
            mesh, rows).to_local(grad_placements=shared)
        z = full[..., c0:c1]
        xs = full[..., din + c0:din + c1]
        bc = full[..., 2 * din:2 * din + 2 * gn]
        dt = full[..., 2 * din + 2 * gn + h0:2 * din + 2 * gn + h0 + h_l]
    else:
        seg = column_segments(p["in_proj"], {"z": din, "x": din,
                                             "bc": 2 * gn, "dt": h})
        z, xs, dt = ((x @ seg[k]).redistribute(mesh, heads).to_local()
                     for k in ("z", "x", "dt"))
        bc = (x @ seg["bc"]).redistribute(mesh, rows).to_local(
            grad_placements=shared)

    def own(v, *spans):  # a small param's (or state's) local channels
        if is_dtensor(v):
            v = v.full_tensor(grad_placements=pl(Partial(), Partial()))
        return torch.cat([v[..., a:b] for a, b in spans], dim=-1)

    conv = ((c0, c1), (din, din + 2 * gn))  # x's channels, then B and C
    lp = {"conv_w": own(p["conv_w"], *conv), "conv_b": own(p["conv_b"], *conv),
          "norm_scale": own(p["norm_scale"], (c0, c1))}
    for k in ("a_log", "d_skip", "dt_bias"):
        lp[k] = own(p[k], (h0, h0 + h_l))
    state_pl = pl(Shard(0), Shard(1))  # the state's slots and heads
    lstate = None
    if state is not None:
        ssm_t, conv_t = (t if is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * nd) for t in state)
        lstate = SSMState(ssm_t.redistribute(mesh, state_pl).to_local(),
                          own(conv_t.redistribute(mesh, rows).to_local(),
                              *conv))

    def sum_sq(v):  # [B, S, 1] summed over the "model" ranks' channels
        return DTensor.from_local(v, mesh, shared).redistribute(
            mesh, rows).to_local(grad_placements=shared)

    y, new = _mamba2_core(lp, z, torch.cat([xs, bc], dim=-1), dt, cfg,
                          lstate, sum_sq if split else None)
    y = DTensor.from_local(y.to(x.dtype), mesh, heads)
    w = p["out_proj"]
    if small:
        out = contract_on_data(y.redistribute(mesh, rows), w)
    else:
        if is_dtensor(w):
            w = w.redistribute(mesh, pl(Replicate(), Shard(0)))
        out = y @ w  # a partial sum over "model"
    if new is not None:
        tail = new.conv
        xt = DTensor.from_local(tail[..., :c1 - c0], mesh, heads
                                ).redistribute(mesh, rows).to_local()
        new = SSMState(
            DTensor.from_local(new.ssm, mesh, state_pl),
            DTensor.from_local(torch.cat([xt, tail[..., c1 - c0:]], -1),
                               mesh, rows))
        new = SSMState(*(t.redistribute(mesh, old.placements
                                        if is_dtensor(old) else rows)
                         for t, old in zip(new, state)))
    return out.redistribute(mesh, rows), new


def _mamba2_core(p: dict, z: torch.Tensor, xbc: torch.Tensor,
                 dt: torch.Tensor, cfg, state: SSMState | None,
                 sum_sq=None):
    """``mamba2_apply`` between the projections, over the heads that ``z``
    [B, S, heads x P], ``xbc`` [B, S, heads x P + 2 G N] and ``dt`` [B, S,
    heads] hold (``p``'s per-head params and channels are theirs): the
    gated-norm output (f32, [B, S, heads x P]) and the new state. The
    norm's mean square is over ``d_inner``: ``sum_sq`` sums the squares
    over the channels other ranks hold, where given."""
    bsz, s, din = z.shape
    n, g, pp = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    h = din // pp
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,S,H]
    a = -torch.exp(p["a_log"])  # [H], negative

    if state is None or s > 1:
        tail = state.conv if state is not None else None
        xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], tail)
        xs, b, c = torch.split(xbc, [din, g * n, g * n], dim=-1)
        xh = xs.reshape(bsz, s, h, pp)
        bb = b.reshape(bsz, s, g, n)
        cc = c.reshape(bsz, s, g, n)
        pad = (-s) % cfg.ssm_chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            bb = F.pad(bb, (0, 0, 0, 0, 0, pad))
            cc = F.pad(cc, (0, 0, 0, 0, 0, pad))
        init = state.ssm if state is not None else None
        trace.count("ssm.scan_tokens", bsz * (s + pad))
        y, final = ssd_full(xh, dt, a, bb, cc, chunk=cfg.ssm_chunk,
                            initial_state=init)
        y = y[:, :s] + xh[:, :s] * p["d_skip"][None, None, :, None]
        new_state = SSMState(final, new_tail) if state is not None else None
    else:
        xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], state.conv)
        xs, b, c = torch.split(xbc, [din, g * n, g * n], dim=-1)
        xh = xs.reshape(bsz, h, pp)  # S == 1
        yh, new_ssm = ssd_decode_step(state.ssm, xh, dt[:, 0], a,
                                      b.reshape(bsz, g, n),
                                      c.reshape(bsz, g, n))
        y = (yh + xh * p["d_skip"][None, :, None])[:, None]
        new_state = SSMState(new_ssm, new_tail)

    y = y.reshape(bsz, s, din)
    # gated RMSNorm (mamba2's norm-before-out-proj)
    yf = y.float() * F.silu(z.float())
    if sum_sq is None:
        var = yf.square().mean(-1, keepdim=True)
    else:
        var = sum_sq(yf.square().sum(-1, keepdim=True)) / cfg.d_inner
    return yf * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"], new_state


def ssm_state_zeros(cfg, batch: int, dtype: torch.dtype,
                    device=None) -> SSMState:
    return SSMState(
        torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.conv_dim),
                    dtype=dtype, device=device),
    )
