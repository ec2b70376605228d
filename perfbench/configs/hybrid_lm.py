"""Builder of a hybrid Mamba2 / attention LM with a routed MoE and a shared
expert in every layer (``configs/<lm>.json``, granitemoehybrid's
``config.json`` keys): its weights, made on the device from the seed one
layer at a time, in the port's parameter layout, and the port's ``Model``.
The weights are the harness's: the reference reads the same tensors."""

from __future__ import annotations

import math

SEED_WEIGHTS = 1


def generator(seed: int, stream: int, device):
    import torch

    return torch.Generator(device).manual_seed(
        (int(seed) * 16 + stream) % (1 << 63))


def sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    rnd = cfg["port"]["vocab_round"]
    kinds = cfg["layer_types"][: cfg["num_hidden_layers"]]
    din = cfg["mamba_expand"] * d
    if din != cfg["mamba_n_heads"] * cfg["mamba_d_head"]:
        raise ValueError("mamba_expand x hidden_size must be mamba_n_heads x "
                         "mamba_d_head")
    f, fs = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    if fs % f:
        raise ValueError("the shared MLP's width must be a multiple of an "
                         "expert's")
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"], "dh": d // h,
            "f": f, "shared": fs // f, "e": cfg["num_local_experts"],
            "k": cfg["num_experts_per_tok"], "layers": len(kinds),
            "kinds": tuple(kinds),
            "mamba": kinds.count("mamba"), "attn": kinds.count("attention"),
            "din": din, "sh": cfg["mamba_n_heads"], "sp": cfg["mamba_d_head"],
            "g": g, "n": n, "w": cfg["mamba_d_conv"],
            "conv": din + 2 * g * n, "in_proj": 2 * din + 2 * g * n
            + cfg["mamba_n_heads"],
            "vocab": cfg["vocab_size"],
            "vocab_padded": (cfg["vocab_size"] + rnd - 1) // rnd * rnd}


def make_params(cfg: dict, seed: int, device) -> dict:
    """The port's layout: ``embed`` [Vp, D]; ``blocks`` stacked over every
    layer (``ln1`` / ``ln2`` scales, f32; ``moe`` router (f32) / we_up [E,
    D, 2F] (gate columns first) / we_down [E, F, D] / ws_up [D, 2 S F] /
    ws_down [S F, D], the shared MLP as S experts of width F); ``mamba``
    stacked over the Mamba2 layers (in_proj [D, z | xBC | dt], conv_w [W,
    C], conv_b, a_log / d_skip / dt_bias / norm_scale f32, out_proj);
    ``attn`` over the attention layers (wq / wk / wv / wo); ``final_norm``.
    Each stack is drawn one layer at a time: a whole stack's float32 draw
    of the experts would not fit beside the weights."""
    import torch

    if (cfg["port"]["family"] != "hybrid_moe" or not cfg["tie_word_embeddings"]
            or cfg["attention_bias"] or cfg["mamba_proj_bias"]
            or not cfg["mamba_conv_bias"]):
        raise NotImplementedError("this builder makes tied-embedding hybrid "
                                  "MoE LMs with a conv bias and no other")
    s = sizes(cfg)
    d, dh, f, e = s["d"], s["dh"], s["f"], s["e"]
    fs = s["shared"] * f
    dt = getattr(torch, cfg["dtype"])
    f32 = torch.float32
    g = generator(seed, SEED_WEIGHTS, device)

    def normal(shape, sd, dtype=dt):
        return (torch.randn(shape, generator=g, device=device) * sd).to(dtype)

    def scale(shape):
        return 1.0 + normal(shape, 0.1, f32)

    def a_log(shape):
        u = torch.rand(shape, generator=g, device=device)
        return torch.log(1.0 + 15.0 * u)

    def dt_bias(shape):  # softplus^-1 of dt log-uniform in [1e-3, 1e-1]
        u = torch.rand(shape, generator=g, device=device)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt0 + torch.log(-torch.expm1(-dt0))

    sd = 1.0 / math.sqrt(d)
    layer = {
        "blocks": {
            "ln1": {"scale": lambda: scale((d,))},
            "ln2": {"scale": lambda: scale((d,))},
            "moe": {"router": lambda: normal((d, e), sd, f32),
                    "we_up": lambda: normal((e, d, 2 * f), sd),
                    "we_down": lambda: normal((e, f, d),
                                              1.0 / math.sqrt(2.0 * f)),
                    "ws_up": lambda: normal((d, 2 * fs), sd),
                    "ws_down": lambda: normal((fs, d),
                                              1.0 / math.sqrt(2.0 * fs))}},
        "mamba": {"in_proj": lambda: normal((d, s["in_proj"]), sd),
                  "conv_w": lambda: normal((s["w"], s["conv"]), 0.5),
                  "conv_b": lambda: normal((s["conv"],), 0.1),
                  "a_log": lambda: a_log((s["sh"],)),
                  "d_skip": lambda: torch.ones((s["sh"],), device=device),
                  "dt_bias": lambda: dt_bias((s["sh"],)),
                  "norm_scale": lambda: scale((s["din"],)),
                  "out_proj": lambda: normal((s["din"], d),
                                             1.0 / math.sqrt(s["din"]))},
        "attn": {"wq": lambda: normal((d, s["h"] * dh), sd),
                 "wk": lambda: normal((d, s["hkv"] * dh), sd),
                 "wv": lambda: normal((d, s["hkv"] * dh), sd),
                 "wo": lambda: normal((s["h"] * dh, d), sd / math.sqrt(2.0))},
    }
    counts = {"blocks": s["layers"], "mamba": s["mamba"], "attn": s["attn"]}
    # the embedding at sd 1 / (multiplier sqrt(D)): the multiplied rows
    # have an unscaled model's sd 1 / sqrt(D), and the tied head's logit
    # of a token's own row does not outweigh every other
    emb_sd = sd / float(cfg["embedding_multiplier"])
    params = {"embed": normal((s["vocab_padded"], d), emb_sd)}
    for name in ("blocks", "mamba", "attn"):
        params[name] = _stacked(layer[name], counts[name])
    params["final_norm"] = {"scale": scale((d,))}
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

    s = sizes(cfg)
    port = cfg["port"]
    nope = cfg["position_embedding_type"] == "nope"
    mc = ModelConfig(
        name=cfg["name"], family=port["family"], n_layers=s["layers"],
        d_model=s["d"], vocab=s["vocab"], n_heads=s["h"], n_kv_heads=s["hkv"],
        rope_theta=0.0 if nope else float(cfg["rope_theta"]),
        d_ff=s["f"], n_experts=s["e"], top_k=s["k"],
        n_shared_experts=s["shared"], d_expert=s["f"],
        capacity_factor=port["capacity_factor"], tie_embeddings=True,
        ssm_state=s["n"], ssm_expand=cfg["mamba_expand"],
        ssm_head_dim=s["sp"], ssm_chunk=cfg["mamba_chunk_size"],
        ssm_conv_width=s["w"], ssm_groups=s["g"], layer_types=s["kinds"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        attention_multiplier=float(cfg["attention_multiplier"]),
        logits_scaling=float(cfg["logits_scaling"]),
        norm_eps=float(cfg["rms_norm_eps"]), mlp=port["mlp"],
        norm=port["norm"], dtype=cfg["dtype"],
        vocab_round=port["vocab_round"])
    return build_model(mc)
