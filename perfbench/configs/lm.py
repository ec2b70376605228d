"""Builder of a mixture-of-experts LM configuration (``configs/<lm>.json``,
the published ``config.json``'s keys): its weights, made on the device
from the seed in a few large draws, in the port's parameter layout, and the
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
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    rnd = cfg["port"]["vocab_round"]
    return {"d": d, "h": h, "hkv": cfg["num_key_value_heads"], "dh": d // h,
            "f": cfg["intermediate_size"], "e": cfg["num_local_experts"],
            "k": cfg["num_experts_per_tok"], "layers": cfg["num_hidden_layers"],
            "vocab": cfg["vocab_size"],
            "vocab_padded": (cfg["vocab_size"] + rnd - 1) // rnd * rnd}


def make_params(cfg: dict, seed: int, device) -> dict:
    """The port's layout: ``embed`` [Vp, D]; ``blocks`` stacked over the
    layers (``ln1`` / ``ln2`` scales, ``attn`` wq / wk / wv / wo, ``moe``
    router (f32) / we_up [E, D, 2F] (gate columns first) / we_down [E, F,
    D]); ``final_norm``."""
    import torch

    if cfg["port"]["family"] != "moe" or not cfg["tie_word_embeddings"]:
        raise NotImplementedError("this builder makes tied-embedding MoE LMs")
    s = sizes(cfg)
    d, L, dh = s["d"], s["layers"], s["dh"]
    dt = getattr(torch, cfg["dtype"])
    g = generator(seed, SEED_WEIGHTS, device)

    def normal(shape, sd, dtype=dt):
        return (torch.randn(shape, generator=g, device=device) * sd).to(dtype)

    def scale(shape):
        return 1.0 + normal(shape, 0.1, torch.float32)

    sd = 1.0 / math.sqrt(d)
    return {
        "embed": normal((s["vocab_padded"], d), sd),
        "blocks": {
            "ln1": {"scale": scale((L, d))},
            "attn": {"wq": normal((L, d, s["h"] * dh), sd),
                     "wk": normal((L, d, s["hkv"] * dh), sd),
                     "wv": normal((L, d, s["hkv"] * dh), sd),
                     "wo": normal((L, s["h"] * dh, d), sd / math.sqrt(2.0))},
            "ln2": {"scale": scale((L, d))},
            "moe": {"router": normal((L, d, s["e"]), sd, torch.float32),
                    "we_up": normal((L, s["e"], d, 2 * s["f"]), sd),
                    "we_down": normal((L, s["e"], s["f"], d),
                                      1.0 / math.sqrt(2.0 * s["f"]))},
        },
        "final_norm": {"scale": scale((d,))},
    }


def program(cfg: dict):
    """The port's ``Model`` for this configuration."""
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ModelConfig

    s = sizes(cfg)
    port = cfg["port"]
    mc = ModelConfig(
        name=cfg["name"], family=port["family"], n_layers=s["layers"],
        d_model=s["d"], vocab=s["vocab"], n_heads=s["h"], n_kv_heads=s["hkv"],
        d_ff=s["f"], n_experts=s["e"], top_k=s["k"], n_shared_experts=0,
        d_expert=s["f"], tie_embeddings=True, mlp=port["mlp"],
        norm=port["norm"], rope_theta=float(cfg["rope_theta"]),
        capacity_factor=port["capacity_factor"], dtype=cfg["dtype"],
        vocab_round=port["vocab_round"],
        use_pallas_attention=port["use_pallas_attention"])
    return build_model(mc)
