"""Plain reference of a Kimi-Linear decoder LM (``model_type``
kimi_linear: Kimi Delta Attention and latent attention without RoPE in a
3 : 1 pattern, a dense MLP in the leading layers, a sigmoid-routed MoE
beside a shared expert in the rest), in float32 with TF32 off for matmul
and cuDNN, on one sequence at a time, with no cache and no batching.

Written from the published equations (Kimi Linear, arXiv:2510.26692 §3,
and its config.json). A layer is

    x = x + mixer(rms(x)),   x = x + ffn(rms(x))

with RMS norms of eps ``rms_norm_eps``, a final RMS norm and an untied
head. The mixer of the layers in ``linear_attn_config``'s
``full_attn_layers`` (1-based) is latent attention, of the rest KDA.

KDA, for H heads of width d (keys and values alike):

- q, k, v = y W_q, y W_k, y W_v, each through its own causal depthwise
  conv of width ``short_conv_kernel_size`` and SiLU; q and k L2-normalised
  per head (eps 1e-6), q times d^-1/2;
- beta_t = sigmoid(y W_beta), one a head; g_t = -exp(A_log) softplus(y
  W_f_down W_f_up + dt_bias), the log decay per key channel;
- S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
  and o_t = S_t^T q_t, computed token by token from S_0 = 0, vectorised
  over the heads only;
- out = W_o (RMSNorm(o_t) per head times the norm's weight, times
  sigmoid(y W_g_down W_g_up + g_bias)).

Latent attention, decompressed, for head i, with no rotation
(``mla_use_nope``): q_i = (y W_Q)_i; [c; k^R] = y W_DKV, c <- RMSNorm(c);
[k_i^C; v_i] = (c W_UKV)_i; softmax over the causal keys of (q_i . [k_i^C;
k^R]) / sqrt(qk_nope + qk_rope); o = W_O concat_i sum p v_i.

The FFN of the first ``first_k_dense_replace`` layers is a gated SiLU MLP
of ``intermediate_size``; the rest's a MoE: sigmoid scores of the router's
``num_experts_published`` outputs in float32, the top
``num_experts_per_token`` chosen on score + the router's correction bias,
weighted by their scores renormalised over the k and times
``routed_scaling_factor``; of them only the ``num_experts`` experts held
here (from ``expert_offset``), each a gated SiLU MLP of
``moe_intermediate_size``, add their part; plus the shared expert, a gated
SiLU MLP of ``num_shared_experts`` x ``moe_intermediate_size``.

Departures, also in the configuration's ``departures``: the weights are
the harness's, random from the seed, with the sizes the config does not
give under its ``assumed``; the card's share of the experts, as the
program holds it (the absent experts' part left out); latent attention in
blocks of ``QUERY_BLOCK`` query rows and the MoE one held expert at a
time, exact in real arithmetic. It reads the harness's weights and
computes everything else itself; it imports nothing of the program.

``fp8=True`` is the control: every product with a weight, and latent
attention's two, take operands rounded to float8 (e4m3, a scale per row
of the left operand and per column of the right), the step below the
configuration's bfloat16; the router, the gates' nonlinearities, the norms
and KDA's recurrence stay in float32, as the configuration states them.

A second control, for the record only: with ``CONTROL`` set to
"bf16_state" before a control run, ``fp8=True`` computes every product in
float32 and rounds KDA's state to bfloat16 after every token, its decay
and beta to bfloat16 before it: the precision the configuration keeps in
float32, one step down. It is read through the harness as

    python3 -c "import sys; sys.path.insert(0, 'src'); \
    from perfbench.lib import spec; \
    spec.load_module('reference', 'kda_lm').CONTROL = 'bf16_state'; \
    from perfbench import control; \
    control.main(['--workload', 'kimilinear.agent', '--seeds', '5'])"

(its readings print under the fp8 control's names).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
CONTROL = "fp8"  # what fp8=True computes: "fp8" or "bf16_state"
QUERY_BLOCK = 512  # query rows a block of latent attention
L2_EPS = 1e-6


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


def layer_kinds(cfg: dict) -> list[str]:
    full = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in full else "kda"
            for i in range(cfg["num_hidden_layers"])]


def _conv(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv of z [S, C] by w [W, C], then SiLU."""
    width = w.shape[0]
    zp = F.pad(z, (0, 0, width - 1, 0))
    s = z.shape[0]
    y = sum(zp[i:i + s] * w[i].float() for i in range(width))
    return F.silu(y)


def _l2(t: torch.Tensor) -> torch.Tensor:
    return t * torch.rsqrt(t.square().sum(-1, keepdim=True) + L2_EPS)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor,
               bf16_state: bool = False) -> torch.Tensor:
    """KDA's delta rule token by token from a zero state: q, k, v, g [S,
    H, d], beta [S, H] -> o [S, H, d], float32 (``bf16_state``: the state
    rounded to bfloat16 after every token, the decay and beta before)."""
    s, h, d = q.shape
    alpha = g.exp()[..., None]  # [S, H, d, 1]
    if bf16_state:
        alpha, beta = _bf16(alpha), _bf16(beta)
    qr, kr, kc = q[:, :, None], k[:, :, None], k[..., None]
    vr, br = v[:, :, None], beta[:, :, None, None]
    st = torch.zeros((h, d, d), device=q.device)
    u = torch.empty((h, 1, d), device=q.device)
    o = torch.empty((s, h, 1, d), device=q.device)
    for t in range(s):
        st.mul_(alpha[t])  # Diag(a_t) S
        torch.bmm(kr[t], st, out=u)  # k^T Diag(a_t) S
        torch.sub(vr[t], u, out=u).mul_(br[t])  # beta (v - ...)
        st.baddbmm_(kc[t], u)
        if bf16_state:
            st.copy_(_bf16(st))
        torch.bmm(qr[t], st, out=o[t])
    return o[:, :, 0]


def _kda(cfg: dict, p: dict, y: torch.Tensor, fp8: bool,
         bf16_state: bool = False) -> torch.Tensor:
    lac = cfg["linear_attn_config"]
    h, d = lac["num_heads"], lac["head_dim"]
    s = y.shape[0]
    qkv = _conv(_mm(y, p["wqkv"].float(), fp8), p["conv_w"])
    q, k, v = qkv.view(s, 3, h, d).unbind(1)
    q, k = _l2(q) * d ** -0.5, _l2(k)
    beta = torch.sigmoid(_mm(y, p["w_beta"].float(), fp8))
    f = _mm(_mm(y, p["f_down"].float(), fp8), p["f_up"].float(), fp8)
    g = -torch.exp(p["a_log"].float())[:, None] * F.softplus(
        f + p["dt_bias"].float()).view(s, h, d)
    o = recurrence(q, k, v, g, beta, bf16_state)
    gate = torch.sigmoid(_mm(_mm(y, p["g_down"].float(), fp8),
                             p["g_up"].float(), fp8) + p["g_bias"].float())
    o = _rms(o, p["o_norm"], cfg["rms_norm_eps"]) * gate.view(s, h, d)
    return _mm(o.reshape(s, h * d), p["wo"].float(), fp8)


def _attention(cfg: dict, p: dict, y: torch.Tensor,
               fp8: bool) -> torch.Tensor:
    """Causal multi-head latent attention without RoPE, decompressed, in
    blocks of ``QUERY_BLOCK`` query rows."""
    s = y.shape[0]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    q = _mm(y, p["wq"].float(), fp8).view(s, h, dn + dr)
    kv_a = _mm(y, p["wkv_a"].float(), fp8)
    c = _rms(kv_a[:, :r], p["kv_norm"]["scale"], cfg["rms_norm_eps"])
    kv = _mm(c, p["wkv_b"].float(), fp8).view(s, h, dn + dv)
    k = torch.cat([kv[..., :dn], kv_a[:, None, r:].expand(s, h, dr)], -1)
    v = kv[..., dn:]
    qh, kh, vh = (t.transpose(0, 1) for t in (q, k, v))  # [H, S, .]
    sigma = 1.0 / math.sqrt(dn + dr)
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
    """The held experts' part of the routed experts, plus the shared
    one."""
    scores = torch.sigmoid(y @ m["router"].float())
    e_idx = torch.topk(scores + m["router_bias"].float(),
                       cfg["num_experts_per_token"], -1).indices
    wt = scores.gather(-1, e_idx)
    wt = wt / wt.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]
    out = torch.zeros_like(y)
    first = cfg["expert_offset"]
    for e in range(m["we_up"].shape[0]):
        rows, slot = (e_idx == first + e).nonzero(as_tuple=True)
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
    state = fp8 and CONTROL == "bf16_state"
    fp8 = fp8 and CONTROL == "fp8"
    eps = cfg["rms_norm_eps"]
    n_dense = cfg["first_k_dense_replace"]
    blk = params["blocks"]
    x = params["embed"][tokens].float()
    seen = {"kda": 0, "mla": 0}
    for i, kind in enumerate(layer_kinds(cfg)):
        y = _rms(x, blk["ln1"]["scale"][i], eps)
        p = _layer(params[kind], seen[kind])
        seen[kind] += 1
        if kind == "kda":
            x = x + _kda(cfg, p, y, fp8, state)
        else:
            x = x + _attention(cfg, p, y, fp8)
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
        return _mm(x, head, fp8 and CONTROL == "fp8")
