"""Builder of a Kimi-Linear decoder LM (``model_type`` kimi_linear): Kimi
Delta Attention and latent attention without RoPE in the layer pattern of
``linear_attn_config``, a dense MLP in the first
``first_k_dense_replace`` layers and a sigmoid-routed MoE beside a shared
expert in the rest, holding ``num_experts`` of the router's
``num_experts_published`` from ``expert_offset`` on
(``configs/<lm>.json``): its weights, made on the device from the seed
one layer at a time, in the port's parameter layout, and the port's
``Model``. The weights are the harness's: the reference reads the same
tensors."""

from __future__ import annotations

import math

SEED_WEIGHTS = 1


def generator(seed: int, stream: int, device):
    import torch

    return torch.Generator(device).manual_seed(
        (int(seed) * 16 + stream) % (1 << 63))


def layer_types(cfg: dict) -> tuple[str, ...]:
    """Each layer's mixer, "kda" or "mla", from ``linear_attn_config``'s
    1-based layer lists."""
    lac = cfg["linear_attn_config"]
    full = set(lac["full_attn_layers"])
    kinds = tuple("mla" if i + 1 in full else "kda"
                  for i in range(cfg["num_hidden_layers"]))
    if set(lac["kda_layers"]) | full != set(range(1, len(kinds) + 1)):
        raise ValueError("linear_attn_config does not cover every layer")
    return kinds


def sizes(cfg: dict) -> dict:
    rnd = cfg["port"]["vocab_round"]
    lac = cfg["linear_attn_config"]
    layers = cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    kinds = layer_types(cfg)
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "r": cfg["kv_lora_rank"], "dn": cfg["qk_nope_head_dim"],
            "dr": cfg["qk_rope_head_dim"], "dv": cfg["v_head_dim"],
            "kh": lac["num_heads"], "kd": lac["head_dim"],
            "kw": lac["short_conv_kernel_size"],
            "kr": cfg["port"]["kda_gate_rank"],
            "f_dense": cfg["intermediate_size"],
            "f": cfg["moe_intermediate_size"],
            "shared": cfg["num_shared_experts"], "e": cfg["num_experts"],
            "e_all": cfg["num_experts_published"],
            "k": cfg["num_experts_per_token"], "layers": layers,
            "dense": dense, "moe": layers - dense, "kinds": kinds,
            "n_kda": kinds.count("kda"), "n_mla": kinds.count("mla"),
            "vocab": cfg["vocab_size"],
            "vocab_padded": (cfg["vocab_size"] + rnd - 1) // rnd * rnd}


def check(cfg: dict) -> None:
    """What this builder makes: no query LoRA, latent attention without
    RoPE, a MoE in every layer after the dense ones, sigmoid top-k in one
    group renormalised, an untied head."""
    if (cfg["q_lora_rank"] is not None or cfg["moe_layer_freq"] != 1
            or cfg["moe_router_activation_func"] != "sigmoid"
            or not cfg["moe_renormalize"] or cfg["num_expert_group"] != 1
            or cfg["topk_group"] != 1 or cfg["tie_word_embeddings"]
            or not cfg["mla_use_nope"] or cfg["rope_scaling"] is not None
            or cfg["port"]["family"] != "linear_mla"):
        raise NotImplementedError(
            "this builder makes Kimi-Linear LMs with no query LoRA, latent "
            "attention without RoPE, sigmoid top-k routing renormalised in "
            "one group and an untied head")


def make_params(cfg: dict, seed: int, device) -> dict:
    """The port's layout: ``embed`` [Vp, D]; ``blocks`` stacked over every
    layer (``ln1`` / ``ln2`` scales, f32); ``kda`` over the KDA layers
    (wqkv [D, 3 H d], conv_w [W, 3 H d], w_beta [D, H], f_down [D, r],
    f_up [r, H d], dt_bias [H d] f32, a_log [H] f32, g_down [D, r], g_up
    [r, H d], g_bias [H d] f32, o_norm [d] f32, wo [H d, D]); ``mla`` over
    the latent layers (wq [D, H (dn + dr)], wkv_a [D, r + dr], kv_norm
    scale [r] f32, wkv_b [r, H (dn + dv)], wo [H dv, D]); ``dense`` over the
    leading layers (``mlp``: wi [D, 2F] gate columns first, wo [F, D]);
    ``moe`` over the rest (router [D, E_all] and router_bias [E_all], f32;
    we_up [E, D, 2F] / we_down [E, F, D] for the E experts held / ws_up
    [D, 2 S F] / ws_down [S F, D]); ``final_norm``; ``lm_head`` [D, Vp].
    Each stack is drawn one layer at a time."""
    import torch

    program(cfg)  # a program that cannot build it fails before any draw
    s = sizes(cfg)
    d, h, f, e = s["d"], s["h"], s["f"], s["e"]
    kh, kd, kr, kw = s["kh"], s["kd"], s["kr"], s["kw"]
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
        "blocks": {"ln1": {"scale": lambda: scale((d,))},
                   "ln2": {"scale": lambda: scale((d,))}},
        "kda": {"wqkv": lambda: normal((d, 3 * kh * kd), sd),
                "conv_w": lambda: normal((kw, 3 * kh * kd),
                                         1.0 / math.sqrt(kw)),
                "w_beta": lambda: normal((d, kh), sd),
                "f_down": lambda: normal((d, kr), sd),
                "f_up": lambda: normal((kr, kh * kd), 1.0 / math.sqrt(kr)),
                "dt_bias": lambda: dt_bias(torch.rand(
                    (kh * kd,), generator=g, device=device)),
                "a_log": lambda: torch.log(torch.linspace(
                    1.0, 16.0, kh, dtype=f32, device=device)),
                "g_down": lambda: normal((d, kr), sd),
                "g_up": lambda: normal((kr, kh * kd), 1.0 / math.sqrt(kr)),
                "g_bias": lambda: normal((kh * kd,), 0.1, f32),
                "o_norm": lambda: scale((kd,)),
                "wo": lambda: normal((kh * kd, d), 1.0 / math.sqrt(kh * kd))},
        "mla": {"wq": lambda: normal((d, h * (s["dn"] + s["dr"])), sd),
                "wkv_a": lambda: normal((d, s["r"] + s["dr"]), sd),
                "kv_norm": {"scale": lambda: scale((s["r"],))},
                "wkv_b": lambda: normal((s["r"], h * (s["dn"] + s["dv"])),
                                        1.0 / math.sqrt(s["r"])),
                "wo": lambda: normal((h * s["dv"], d),
                                     1.0 / math.sqrt(h * s["dv"]))},
        "dense": {"mlp": {"wi": lambda: normal((d, 2 * fd), sd),
                          "wo": lambda: normal((fd, d),
                                               1.0 / math.sqrt(2.0 * fd))}},
        "moe": {"router": lambda: normal((d, s["e_all"]), sd, f32),
                "router_bias": lambda: normal((s["e_all"],), 0.1, f32),
                "we_up": lambda: normal((e, d, 2 * f), sd),
                "we_down": lambda: normal((e, f, d), 1.0 / math.sqrt(2.0 * f)),
                "ws_up": lambda: normal((d, 2 * fs), sd),
                "ws_down": lambda: normal((fs, d),
                                          1.0 / math.sqrt(2.0 * fs))},
    }
    counts = {"blocks": s["layers"], "kda": s["n_kda"], "mla": s["n_mla"],
              "dense": s["dense"], "moe": s["moe"]}
    params = {"embed": normal((s["vocab_padded"], d), sd)}
    for name in ("blocks", "kda", "mla", "dense", "moe"):
        if counts[name]:
            params[name] = _stacked(layer[name], counts[name])
    params["final_norm"] = {"scale": scale((d,))}
    params["lm_head"] = normal((d, s["vocab_padded"]), sd)
    return params


def dt_bias(u):
    """The decay gate's bias from uniforms ``u``, as the fla package
    initialises it: softplus^-1 of dt, dt log-uniform over [0.001, 0.1]."""
    import torch

    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt + torch.log(-torch.expm1(-dt))


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
    mc = ModelConfig(
        name=cfg["name"], family="linear_mla", n_layers=s["layers"],
        d_model=s["d"], vocab=s["vocab"], n_heads=s["h"], n_kv_heads=s["h"],
        rope_theta=float(cfg["rope_theta"]), layer_types=s["kinds"],
        kv_lora_rank=s["r"], qk_nope_head_dim=s["dn"],
        qk_rope_head_dim=s["dr"], v_head_dim=s["dv"], mla_nope=True,
        kda_heads=s["kh"], kda_head_dim=s["kd"], kda_conv_width=s["kw"],
        kda_gate_rank=s["kr"], d_ff=s["f_dense"], first_k_dense=s["dense"],
        n_experts=s["e_all"], experts_held=s["e"],
        expert_offset=int(cfg["expert_offset"]), top_k=s["k"],
        n_shared_experts=s["shared"], d_expert=s["f"],
        capacity_factor=port["capacity_factor"], moe_score="sigmoid",
        moe_routed_scale=float(cfg["routed_scaling_factor"]),
        moe_renormalize=True, norm_eps=float(cfg["rms_norm_eps"]),
        prefill_chunk=port["prefill_chunk"],
        attn_kv_chunk=port["attn_kv_chunk"],
        attn_blocks_threshold=port["attn_blocks_threshold"],
        use_pallas_attention=bool(port.get("use_pallas_attention", False)),
        mlp=port["mlp"], norm=port["norm"], dtype=cfg["dtype"],
        vocab_round=port["vocab_round"])
    return build_model(mc)
