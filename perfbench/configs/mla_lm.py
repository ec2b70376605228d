"""Builder of a DeepSeek-V2 decoder LM: multi-head latent attention in
every layer, a dense MLP in the first ``first_k_dense_replace`` layers and
a routed MoE beside shared experts in the rest (``configs/<lm>.json``,
deepseek_v2's ``config.json`` keys): its weights, made on the device from
the seed one layer at a time, in the port's parameter layout, and the
port's ``Model``. The weights are the harness's: the reference reads the
same tensors."""

from __future__ import annotations

import math

SEED_WEIGHTS = 1


def generator(seed: int, stream: int, device):
    import torch

    return torch.Generator(device).manual_seed(
        (int(seed) * 16 + stream) % (1 << 63))


def sizes(cfg: dict) -> dict:
    rnd = cfg["port"]["vocab_round"]
    layers = cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "r": cfg["kv_lora_rank"], "dn": cfg["qk_nope_head_dim"],
            "dr": cfg["qk_rope_head_dim"], "dv": cfg["v_head_dim"],
            "f_dense": cfg["intermediate_size"],
            "f": cfg["moe_intermediate_size"],
            "shared": cfg["n_shared_experts"], "e": cfg["n_routed_experts"],
            "k": cfg["num_experts_per_tok"], "layers": layers,
            "dense": dense, "moe": layers - dense,
            "vocab": cfg["vocab_size"],
            "vocab_padded": (cfg["vocab_size"] + rnd - 1) // rnd * rnd}


def check(cfg: dict) -> None:
    """What this builder makes: no query LoRA, a MoE in every layer after
    the dense ones, softmax top-k greedy routing in one group, YaRN whose
    cos / sin multiplier is 1 (mscale equal to mscale_all_dim)."""
    rs = cfg["rope_scaling"]
    if (cfg["q_lora_rank"] is not None or cfg["moe_layer_freq"] != 1
            or cfg["scoring_func"] != "softmax" or cfg["n_group"] != 1
            or cfg["topk_group"] != 1 or cfg["topk_method"] != "greedy"
            or cfg["tie_word_embeddings"] or cfg["attention_bias"]
            or cfg["routed_scaling_factor"] != 1 or rs["type"] != "yarn"
            or rs["mscale"] != rs["mscale_all_dim"]
            or cfg["port"]["family"] != "mla"):
        raise NotImplementedError(
            "this builder makes DeepSeek-V2 LMs with no query LoRA, softmax "
            "greedy routing in one group, YaRN with mscale equal to "
            "mscale_all_dim and an untied head")


def make_params(cfg: dict, seed: int, device) -> dict:
    """The port's layout: ``embed`` [Vp, D]; ``blocks`` stacked over every
    layer (``ln1`` / ``ln2`` scales, f32; ``mla``: wq [D, H (dn + dr)],
    wkv_a [D, r + dr], kv_norm scale [r] f32, wkv_b [r, H (dn + dv)], wo
    [H dv, D]); ``dense`` over the leading layers (``mlp``: wi [D, 2F]
    gate columns first, wo [F, D]); ``moe`` over the rest (router (f32) /
    we_up [E, D, 2F] / we_down [E, F, D] / ws_up [D, 2 S F] / ws_down [S F,
    D]); ``final_norm``; ``lm_head`` [D, Vp]. Each stack is drawn one layer
    at a time: a whole stack's float32 draw of the experts would not fit
    beside the weights."""
    import torch

    check(cfg)
    s = sizes(cfg)
    d, h, f, e = s["d"], s["h"], s["f"], s["e"]
    fd, fs = s["f_dense"], s["shared"] * f
    dt = getattr(torch, cfg["dtype"])
    f32 = torch.float32
    g = generator(seed, SEED_WEIGHTS, device)

    def normal(shape, sd, dtype=dt):
        return (torch.randn(shape, generator=g, device=device) * sd).to(dtype)

    def scale(shape):
        return 1.0 + normal(shape, 0.1, f32)

    sd = 1.0 / math.sqrt(d)
    layer = {
        "blocks": {
            "ln1": {"scale": lambda: scale((d,))},
            "mla": {"wq": lambda: normal((d, h * (s["dn"] + s["dr"])), sd),
                    "wkv_a": lambda: normal((d, s["r"] + s["dr"]), sd),
                    "kv_norm": {"scale": lambda: scale((s["r"],))},
                    "wkv_b": lambda: normal((s["r"], h * (s["dn"] + s["dv"])),
                                            1.0 / math.sqrt(s["r"])),
                    "wo": lambda: normal((h * s["dv"], d),
                                         1.0 / math.sqrt(h * s["dv"]))},
            "ln2": {"scale": lambda: scale((d,))}},
        "dense": {"mlp": {"wi": lambda: normal((d, 2 * fd), sd),
                          "wo": lambda: normal((fd, d),
                                               1.0 / math.sqrt(2.0 * fd))}},
        "moe": {"router": lambda: normal((d, e), sd, f32),
                "we_up": lambda: normal((e, d, 2 * f), sd),
                "we_down": lambda: normal((e, f, d), 1.0 / math.sqrt(2.0 * f)),
                "ws_up": lambda: normal((d, 2 * fs), sd),
                "ws_down": lambda: normal((fs, d),
                                          1.0 / math.sqrt(2.0 * fs))},
    }
    counts = {"blocks": s["layers"], "dense": s["dense"], "moe": s["moe"]}
    params = {"embed": normal((s["vocab_padded"], d), sd)}
    for name in ("blocks", "dense", "moe"):
        if counts[name]:
            params[name] = _stacked(layer[name], counts[name])
    params["final_norm"] = {"scale": scale((d,))}
    params["lm_head"] = normal((d, s["vocab_padded"]), sd)
    return params


def _stacked(makers: dict, n: int) -> dict:
    """``n`` layers of ``makers``' tensors, stacked [n, ...], drawn a layer
    at a time into the stack."""
    import torch

    out: dict = {}
    for i in range(n):
        _fill(makers, out, i, n, torch)
    return out


def _fill(makers: dict, out: dict, i: int, n: int, torch) -> None:
    for k, make in makers.items():
        if isinstance(make, dict):
            _fill(make, out.setdefault(k, {}), i, n, torch)
            continue
        t = make()
        if i == 0:
            out[k] = torch.empty((n, *t.shape), dtype=t.dtype,
                                 device=t.device)
        out[k][i].copy_(t)


def program(cfg: dict):
    """The port's ``Model`` for this configuration."""
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ModelConfig

    check(cfg)
    s = sizes(cfg)
    port = cfg["port"]
    rs = cfg["rope_scaling"]
    mc = ModelConfig(
        name=cfg["name"], family="mla", n_layers=s["layers"], d_model=s["d"],
        vocab=s["vocab"], n_heads=s["h"], n_kv_heads=s["h"],
        rope_theta=float(cfg["rope_theta"]), kv_lora_rank=s["r"],
        qk_nope_head_dim=s["dn"], qk_rope_head_dim=s["dr"],
        v_head_dim=s["dv"], yarn_factor=float(rs["factor"]),
        yarn_original_max_pos=int(rs["original_max_position_embeddings"]),
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale=float(rs["mscale_all_dim"]),
        d_ff=s["f_dense"], first_k_dense=s["dense"], n_experts=s["e"],
        top_k=s["k"], n_shared_experts=s["shared"], d_expert=s["f"],
        capacity_factor=port["capacity_factor"],
        moe_renormalize=bool(cfg["norm_topk_prob"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        prefill_chunk=port["prefill_chunk"],
        attn_kv_chunk=port["attn_kv_chunk"],
        attn_blocks_threshold=port["attn_blocks_threshold"],
        use_pallas_attention=bool(port.get("use_pallas_attention", False)),
        moe_ragged_tokens=int(port.get("moe_ragged_tokens", 0)),
        mlp=port["mlp"], norm=port["norm"], dtype=cfg["dtype"],
        vocab_round=port["vocab_round"])
    return build_model(mc)
