"""Model FLOPs of a decoder LM with a GQA attention block and either a
gated MLP or a top-k MoE, from its configuration (``configs/<lm>.json``).

The formulas follow ``repro_torch/launch/op_cost.py``'s rules for the ops
the model runs, written out per token so they can be computed from sizes
alone: a product of [m, k] by [k, n] is 2 m k n; attention is 2 S_kv Dh
for the scores and as much for the weighted sum, per query and head. The
MoE counts the routed (top-k) experts' products, not the capacity's empty
rows: model FLOPs, what the tokens need."""

from __future__ import annotations


def _sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    dh = d // h
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"], "dh": dh,
            "vocab": cfg["vocab_size"], "layers": cfg["num_hidden_layers"],
            "e": cfg["num_local_experts"], "k": cfg["num_experts_per_tok"],
            "f": cfg["intermediate_size"]}


def dense_flops_per_token(cfg: dict) -> int:
    """Forward FLOPs a token spends outside attention's two S-dependent
    products: the projections, the router, the routed experts and the
    logits head."""
    s = _sizes(cfg)
    d, dh = s["d"], s["dh"]
    proj = 2 * d * (s["h"] * dh) * 2 + 2 * d * (s["hkv"] * dh) * 2
    router = 2 * d * s["e"]
    experts = s["k"] * (2 * d * 2 * s["f"] + 2 * s["f"] * d)
    return s["layers"] * (proj + router + experts) + 2 * d * s["vocab"]


def attn_flops(cfg: dict, n_queries: int, kv_sum: int) -> int:
    """Attention's two products for ``n_queries`` queries that together see
    ``kv_sum`` keys (a causal prefill of S tokens: S (S + 1) / 2)."""
    s = _sizes(cfg)
    del n_queries
    return s["layers"] * s["h"] * 4 * s["dh"] * kv_sum


def prefill_flops(cfg: dict, s_len: int) -> int:
    return (s_len * dense_flops_per_token(cfg)
            + attn_flops(cfg, s_len, s_len * (s_len + 1) // 2))


def decode_flops(cfg: dict, context: int) -> int:
    """One generated token that sees ``context`` keys (its own included)."""
    return dense_flops_per_token(cfg) + attn_flops(cfg, 1, context)


def train_step_flops(cfg: dict, batch: int, seq: int,
                     recompute: bool = True) -> int:
    """Forward, backward (twice the forward) and, with activation
    recomputation, one more forward."""
    fwd = batch * prefill_flops(cfg, seq)
    return fwd * (4 if recompute else 3)
