"""Plain reference of a hybrid Mamba2 / attention decoder LM whose every
layer ends in a routed mixture of experts beside a shared expert
(granite-4.0-h's shape, ``model_type`` granitemoehybrid), in float32 with
TF32 off for matmul and cuDNN, on one sequence at a time, with no cache and
no batching.

Written from the published equations. A layer is

    x = x + r * mixer(rms(x)),   x = x + r * (moe(rms(x)) + shared(rms(x)))

with RMS norms of eps ``rms_norm_eps``, the residual multiplier r, the
embeddings times ``embedding_multiplier``, a final RMS norm and a head tied
to the embedding whose logits are divided by ``logits_scaling``. The mixer
is the layer's entry of ``layer_types``:

- Mamba2: in_proj to [z, xBC, dt]; a causal depthwise conv over xBC with
  its bias, then SiLU; x, B, C split from it; dt = softplus(dt + dt_bias);
  the selective-state recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
  y_t = C_t h_t + D x_t, with A = -exp(A_log) a head and one group's B and C
  shared by its heads; the gated RMS norm rms(y * SiLU(z)) over the inner
  width; out_proj. The recurrence is computed in blocks of ``BLOCK`` steps:
  within a block the decays exp(sum dt A) between every pair of steps
  form a lower-triangular matrix, and the state entering the block is
  carried across; this is the recurrence rewritten exactly (in real
  arithmetic), so that a request of thousands of tokens takes a few dozen
  products a layer;
- attention: grouped-query causal attention over the whole sequence, no
  position embedding (NoPE), the scores times ``attention_multiplier``.

The MoE: softmax over the experts' router logits in float32, top-k, the
k weights renormalised (equal to the published top-k of the logits then a
softmax over the k), each chosen expert a gated SiLU MLP; every token
reaches its k experts (no capacity). The shared expert is one gated SiLU
MLP of width ``shared_intermediate_size``.

Departures, also in the configuration's ``departures``: the weights are
the harness's, random from the seed; no capacity, where the program's
capacity factor (experts / top-k) drops no seat either; the recurrence in
blocks as above. It reads the harness's weights and computes everything
else itself; it imports nothing of the program.

``fp8=True`` is the control: every product's operands rounded to float8
(e4m3, a scale per row of the left operand and per column of the right),
and the scan's x, B and C rounded so before the recurrence, the step below
the configuration's bfloat16; the router stays in float32, as the
configuration states it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
BLOCK = 128  # steps of the recurrence a block


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _fp8(a, -1), _fp8(b, -2)
    return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The selective-state recurrence from a zero state: x [S, H, P], dt
    [S, H] (after the softplus), a [H] (negative), b, c [S, G, N] ->
    y [S, H, P] (without the D skip), in blocks of ``BLOCK`` steps."""
    s, h, p = x.shape
    g, n = b.shape[1], b.shape[2]
    bh = b.repeat_interleave(h // g, dim=1)  # [S, H, N]
    ch = c.repeat_interleave(h // g, dim=1)
    state = x.new_zeros((h, p, n))
    out = []
    for t0 in range(0, s, BLOCK):
        xb, dtb = x[t0:t0 + BLOCK], dt[t0:t0 + BLOCK]
        bb, cb = bh[t0:t0 + BLOCK], ch[t0:t0 + BLOCK]
        q = xb.shape[0]
        la = torch.cumsum(dtb * a, dim=0)  # [q, H]: log decay since t0 - 1
        seg = la.T[:, :, None] - la.T[:, None, :]  # [H, t, u]
        lower = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~lower, float("-inf")))
        xdt = xb * dtb[..., None]  # [q, H, P]
        w = torch.einsum("thn,uhn->htu", cb, bb) * decay
        y = torch.einsum("htu,uhp->thp", w, xdt)
        y = y + torch.einsum("thn,hpn->thp", cb, state) \
            * torch.exp(la)[..., None]
        tail = torch.exp(la[-1][None] - la)  # [q, H]: decay to the block's end
        state = (state * torch.exp(la[-1])[:, None, None]
                 + torch.einsum("uhn,uh,uhp->hpn", bb, tail, xdt))
        out.append(y)
    return torch.cat(out)


def _mamba(cfg: dict, p: dict, y: torch.Tensor, fp8: bool) -> torch.Tensor:
    s = y.shape[0]
    din = cfg["mamba_expand"] * cfg["hidden_size"]
    h, hp = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n, w = cfg["mamba_n_groups"], cfg["mamba_d_state"], cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(_mm(y, p["in_proj"].float(), fp8),
                             [din, din + 2 * g * n, h], dim=-1)
    xp = F.pad(xbc, (0, 0, w - 1, 0))
    cw = p["conv_w"].float()
    conv = sum(xp[k:k + s] * cw[k] for k in range(w)) + p["conv_b"].float()
    xs, b, c = torch.split(F.silu(conv), [din, g * n, g * n], dim=-1)
    if fp8:
        xs, b, c = _fp8(xs, -1), _fp8(b, -1), _fp8(c, -1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    x = xs.reshape(s, h, hp)
    ys = scan(x, dt, a, b.reshape(s, g, n), c.reshape(s, g, n))
    ys = (ys + x * p["d_skip"].float()[:, None]).reshape(s, din)
    ys = _rms(ys * F.silu(z), p["norm_scale"], cfg["rms_norm_eps"])
    return _mm(ys, p["out_proj"].float(), fp8)


def _attention(cfg: dict, p: dict, y: torch.Tensor,
               fp8: bool) -> torch.Tensor:
    """Causal GQA with no position embedding, one KV head's group of query
    heads at a time (the scores of a group: [H / Hkv, S, S])."""
    s, d = y.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, rep = d // h, h // hkv
    q = _mm(y, p["wq"].float(), fp8).view(s, hkv, rep, dh)
    k = _mm(y, p["wk"].float(), fp8).view(s, hkv, dh)
    v = _mm(y, p["wv"].float(), fp8).view(s, hkv, dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=y.device).tril()
    o = torch.empty(s, hkv, rep, dh, device=y.device)
    for j in range(hkv):
        qj = q[:, j].transpose(0, 1)  # [rep, S, Dh]
        sc = _mm(qj, k[:, j].T, fp8) * cfg["attention_multiplier"]
        pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o[:, j] = _mm(pr, v[:, j], fp8).transpose(0, 1)
    return _mm(o.reshape(s, h * dh), p["wo"].float(), fp8)


def _moe(cfg: dict, m: dict, y: torch.Tensor, fp8: bool) -> torch.Tensor:
    """The routed experts plus the shared one."""
    f, k_top = cfg["intermediate_size"], cfg["num_experts_per_tok"]
    probs = torch.softmax(y @ m["router"].float(), -1)
    wt, e_idx = torch.topk(probs, k_top, -1)
    wt = wt / wt.sum(-1, keepdim=True)
    out = torch.zeros_like(y)
    for e in range(m["we_up"].shape[0]):
        rows, slot = (e_idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        up = _mm(y[rows], m["we_up"][e].float(), fp8)
        act = F.silu(up[:, :f]) * up[:, f:]
        out.index_add_(0, rows, _mm(act, m["we_down"][e].float(), fp8)
                       * wt[rows, slot][:, None])
    gate, up = _mm(y, m["ws_up"].float(), fp8).chunk(2, dim=-1)
    return out + _mm(F.silu(gate) * up, m["ws_down"].float(), fp8)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(cfg: dict, params: dict, tokens: torch.Tensor, *,
           fp8: bool = False) -> torch.Tensor:
    """tokens [S] -> the final norm's output [S, D], float32."""
    with _no_tf32():
        return _hidden(cfg, params, tokens, fp8)


def _hidden(cfg, params, tokens, fp8):
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    blk = params["blocks"]
    x = params["embed"][tokens].float() * cfg["embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"][:cfg["num_hidden_layers"]]):
        j = seen[kind]
        seen[kind] += 1
        y = _rms(x, blk["ln1"]["scale"][i], eps)
        if kind == "mamba":
            h = _mamba(cfg, _layer(params["mamba"], j), y, fp8)
        else:
            h = _attention(cfg, _layer(params["attn"], j), y, fp8)
        x = x + h * r
        y = _rms(x, blk["ln2"]["scale"][i], eps)
        x = x + _moe(cfg, _layer(blk["moe"], i), y, fp8) * r
    return _rms(x, params["final_norm"]["scale"], eps)


def logits(cfg: dict, params: dict, tokens: torch.Tensor, rows: torch.Tensor,
           *, fp8: bool = False) -> torch.Tensor:
    """The logits over the published vocabulary at positions ``rows`` of
    the sequence ``tokens``: [len(rows), vocab], float32."""
    x = hidden(cfg, params, tokens, fp8=fp8)[rows]
    head = params["embed"][: cfg["vocab_size"]].float().T
    with _no_tf32():
        return _mm(x, head, fp8) / cfg["logits_scaling"]
