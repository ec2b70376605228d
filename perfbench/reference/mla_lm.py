"""Plain reference of a DeepSeek-V2 decoder LM (``model_type`` deepseek_v2:
multi-head latent attention, a dense MLP in the leading layers, a routed
MoE beside shared experts in the rest), in float32 with TF32 off for
matmul and cuDNN, on one sequence at a time, with no cache and no
batching.

Written from the published equations (DeepSeek-V2, arXiv:2405.04434 §2.1,
and its config.json). A layer is

    x = x + mla(rms(x)),   x = x + ffn(rms(x))

with RMS norms of eps ``rms_norm_eps``, a final RMS norm and an untied
head. The attention, decompressed, for head i:

- q_i = (y W_Q)_i: q_i^C its first ``qk_nope_head_dim`` columns, q_i^R =
  RoPE(the last ``qk_rope_head_dim``);
- [c; k^R_raw] = y W_DKV, c <- RMSNorm(c) (``kv_a_layernorm``), k^R =
  RoPE(k^R_raw), one key shared by every head;
- [k_i^C; v_i] = (c W_UKV)_i;
- softmax over the causal keys of (q_i^C . k_i^C + q_i^R . k^R) sigma,
  sigma = mscale(factor, mscale_all_dim)^2 / sqrt(dn + dr), and o = W_O
  concat_i sum p v_i.

RoPE rotates the rope columns' first half against their second, at YaRN's
frequencies: DeepSeek-V2's ``yarn_find_correction_range`` gives (low,
high) from beta_fast and beta_slow over the original positions; frequency
j keeps theta^(-2j/dr) below low, is divided by ``factor`` above high, and
a linear ramp joins the two; cos and sin are scaled by mscale(factor,
mscale) / mscale(factor, mscale_all_dim), with mscale(s, m) = 0.1 m ln s + 1.

The FFN of the first ``first_k_dense_replace`` layers is a gated SiLU MLP
of ``intermediate_size``; the rest's a MoE: softmax over the routed
experts' router logits in float32, the top-k weights as they are
(``norm_topk_prob`` false, ``routed_scaling_factor`` 1), each chosen
expert a gated SiLU MLP of ``moe_intermediate_size``, every token reaching
its k experts (no capacity), plus the shared experts as one gated SiLU MLP
of ``n_shared_experts`` x ``moe_intermediate_size``.

Departures, also in the configuration's ``departures``: the weights are
the harness's, random from the seed; no capacity, where the program's
capacity factor (experts / top-k) drops no seat either; attention in
blocks of ``QUERY_BLOCK`` query rows and the MoE one expert at a time,
exact in real arithmetic. It reads the harness's weights and computes
everything else itself; it imports nothing of the program.

``fp8=True`` is the control: every product's operands rounded to float8
(e4m3, a scale per row of the left operand and per column of the right),
the step below the configuration's bfloat16; the router stays in float32,
as the configuration states it.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
QUERY_BLOCK = 1024  # query rows a block of the attention


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


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def correction_range(cfg: dict) -> tuple[int, int]:
    """DeepSeek-V2's ``yarn_find_correction_range`` over the rope columns."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    n = rs["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (dim * math.log(n / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    return (max(math.floor(correction_dim(rs["beta_fast"])), 0),
            min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1))


def inv_freq(cfg: dict, device) -> torch.Tensor:
    """[dr / 2] YaRN's inverse frequencies, float32."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)
    low, high = correction_range(cfg)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / ((high - low) or 0.001)).clamp(0, 1)
    keep = 1.0 - ramp  # DeepSeek-V2's inv_freq_mask
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg: dict) -> float:
    """sigma: 1 / sqrt(dn + dr) times mscale(factor, mscale_all_dim)^2."""
    rs = cfg["rope_scaling"]
    m = mscale(rs["factor"], rs["mscale_all_dim"])
    return m * m / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])


def rope(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """x [S, ..., dr] rotated at positions 0 .. S - 1 (half-split)."""
    rs = cfg["rope_scaling"]
    s = x.shape[0]
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq(cfg, x.device)
    m = mscale(rs["factor"], rs["mscale"]) / mscale(rs["factor"],
                                                    rs["mscale_all_dim"])
    cos, sin = torch.cos(ang) * m, torch.sin(ang) * m
    shape = (s,) + (1,) * (x.dim() - 2) + (x.shape[-1] // 2,)
    cos, sin = cos.view(shape), sin.view(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(cfg: dict, p: dict, y: torch.Tensor,
               fp8: bool) -> torch.Tensor:
    """Causal multi-head latent attention, decompressed, in blocks of
    ``QUERY_BLOCK`` query rows (the scores of a block: [H, rows, keys up
    to the block's end])."""
    s = y.shape[0]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = _mm(y, p["wq"].float(), fp8).view(s, h, dn + dr)
    q = torch.cat([q[..., :dn], rope(cfg, q[..., dn:])], dim=-1)
    kv_a = _mm(y, p["wkv_a"].float(), fp8)
    c = _rms(kv_a[:, :r], p["kv_norm"]["scale"], cfg["rms_norm_eps"])
    k_pe = rope(cfg, kv_a[:, r:])
    kv = _mm(c, p["wkv_b"].float(), fp8).view(s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe[:, None].expand(s, h, dr)], dim=-1)
    v = kv[..., dn:]
    qh, kh, vh = (t.transpose(0, 1) for t in (q, k, v))  # [H, S, .]
    sigma = softmax_scale(cfg)
    o = torch.empty(h, s, dv, device=y.device)
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)
        sc = _mm(qh[:, q0:q1], kh[:, :q1].transpose(1, 2), fp8) * sigma
        causal = (torch.arange(q1, device=y.device)[None]
                  <= torch.arange(q0, q1, device=y.device)[:, None])
        pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o[:, q0:q1] = _mm(pr, vh[:, :q1], fp8)
    return _mm(o.transpose(0, 1).reshape(s, h * dv), p["wo"].float(), fp8)


def _gated(y: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           fp8: bool) -> torch.Tensor:
    gate, u = _mm(y, up.float(), fp8).chunk(2, dim=-1)
    return _mm(F.silu(gate) * u, down.float(), fp8)


def _moe(cfg: dict, m: dict, y: torch.Tensor, fp8: bool) -> torch.Tensor:
    """The routed experts plus the shared ones."""
    probs = torch.softmax(y @ m["router"].float(), -1)
    wt, e_idx = torch.topk(probs, cfg["num_experts_per_tok"], -1)
    if cfg["norm_topk_prob"]:
        wt = wt / wt.sum(-1, keepdim=True)
    wt = wt * cfg["routed_scaling_factor"]
    out = torch.zeros_like(y)
    for e in range(m["we_up"].shape[0]):
        rows, slot = (e_idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out.index_add_(0, rows, _gated(y[rows], m["we_up"][e],
                                       m["we_down"][e], fp8)
                       * wt[rows, slot][:, None])
    return out + _gated(y, m["ws_up"], m["ws_down"], fp8)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(cfg: dict, params: dict, tokens: torch.Tensor, *,
           fp8: bool = False) -> torch.Tensor:
    """tokens [S] -> the final norm's output [S, D], float32."""
    with _no_tf32():
        return _hidden(cfg, params, tokens, fp8)


def _hidden(cfg, params, tokens, fp8):
    eps = cfg["rms_norm_eps"]
    n_dense = cfg["first_k_dense_replace"]
    blk = params["blocks"]
    x = params["embed"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        y = _rms(x, blk["ln1"]["scale"][i], eps)
        x = x + _attention(cfg, _layer(blk["mla"], i), y, fp8)
        y = _rms(x, blk["ln2"]["scale"][i], eps)
        if i < n_dense:
            mlp = _layer(params["dense"]["mlp"], i)
            x = x + _gated(y, mlp["wi"], mlp["wo"], fp8)
        else:
            x = x + _moe(cfg, _layer(params["moe"], i - n_dense), y, fp8)
    return _rms(x, params["final_norm"]["scale"], eps)


def logits(cfg: dict, params: dict, tokens: torch.Tensor, rows: torch.Tensor,
           *, fp8: bool = False) -> torch.Tensor:
    """The logits over the published vocabulary at positions ``rows`` of
    the sequence ``tokens``: [len(rows), vocab], float32."""
    x = hidden(cfg, params, tokens, fp8=fp8)[rows]
    head = params["lm_head"][:, : cfg["vocab_size"]].float()
    with _no_tf32():
        return _mm(x, head, fp8)
