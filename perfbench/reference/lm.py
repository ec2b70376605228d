"""Plain reference of a mixture-of-experts decoder LM (granite-moe's
shape), in float32 with TF32 off, on one sequence at a time.

Written from the published description, with the departures its
configuration file lists and the program shares: pre-norm RMS (eps 1e-6)
blocks, rotary embeddings (first / second half split), grouped-query
causal attention scaled by 1/sqrt(head dim), a top-k router (softmax over
the experts, the k weights renormalised) over gated-SiLU experts with no
capacity (every token reaches its k experts), and a logits head tied to
the embedding. It reads the harness's weights and computes everything
else itself; it imports nothing of the program.

``precision="fp8"`` is the control: every product's operands rounded to
float8 (e4m3, a scale per row of the left operand and per column of the
right), the step below the configuration's bfloat16; the router stays in
float32, as the configuration states it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _fp8(a, -1), _fp8(b, -2)
    return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, Dh], positions 0..S-1."""
    s, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def hidden(cfg: dict, params: dict, tokens: torch.Tensor, *,
           fp8: bool = False) -> torch.Tensor:
    """tokens [S] -> the final norm's output [S, D], float32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _hidden(cfg, params, tokens, fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _hidden(cfg, params, tokens, fp8):
    d = cfg["hidden_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, k_top = d // h, cfg["num_experts_per_tok"]
    f = cfg["intermediate_size"]
    blk = params["blocks"]
    s = tokens.shape[0]
    x = params["embed"][tokens].float()
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        a = blk["attn"]
        y = _rms(x, blk["ln1"]["scale"][i])
        q = _rope(_mm(y, a["wq"][i].float(), fp8).view(s, h, dh),
                  float(cfg["rope_theta"]))
        kk = _rope(_mm(y, a["wk"][i].float(), fp8).view(s, hkv, dh),
                   float(cfg["rope_theta"]))
        v = _mm(y, a["wv"][i].float(), fp8).view(s, hkv, dh)
        kk = kk.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        qh, kh, vh = (t.transpose(0, 1) for t in (q, kk, v))  # [H, S, Dh]
        sc = _mm(qh, kh.transpose(1, 2), fp8) / math.sqrt(dh)
        p = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o = _mm(p, vh, fp8).transpose(0, 1).reshape(s, h * dh)
        x = x + _mm(o, a["wo"][i].float(), fp8)

        m = blk["moe"]
        y = _rms(x, blk["ln2"]["scale"][i])
        probs = torch.softmax(y @ m["router"][i].float(), -1)
        w, e_idx = torch.topk(probs, k_top, -1)
        w = w / w.sum(-1, keepdim=True)
        out = torch.zeros_like(y)
        for e in range(m["we_up"].shape[1]):
            rows, slot = (e_idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            up = _mm(y[rows], m["we_up"][i, e].float(), fp8)
            act = F.silu(up[:, :f]) * up[:, f:]
            out.index_add_(0, rows, _mm(act, m["we_down"][i, e].float(), fp8)
                           * w[rows, slot][:, None])
        x = x + out
    return _rms(x, params["final_norm"]["scale"])


def logits(cfg: dict, params: dict, tokens: torch.Tensor, rows: torch.Tensor,
           *, fp8: bool = False) -> torch.Tensor:
    """The logits over the published vocabulary at positions ``rows`` of
    the sequence ``tokens``: [len(rows), vocab], float32."""
    x = hidden(cfg, params, tokens, fp8=fp8)[rows]
    head = params["embed"][: cfg["vocab_size"]].float().T
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _mm(x, head, fp8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
