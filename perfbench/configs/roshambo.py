"""Builder of a RoShamBo CNN configuration (``configs/roshambo-*.json``):
its weights, made on the device from the seed, and the port's model
object. The weights are the harness's: the reference reads the same
tensors and derives its own layouts from them."""

from __future__ import annotations

import math

SEED_WEIGHTS = 1


def generator(seed: int, stream: int, device):
    import torch

    return torch.Generator(device).manual_seed(
        (int(seed) * 16 + stream) % (1 << 63))


def make_params(cfg: dict, seed: int, device) -> dict:
    """{layer: {"w": [K, K, Cin, Cout] (HWIO), "b": [Cout]}, "fc": {"w":
    [F, classes], "b": [classes]}} in the configuration's dtype, from one
    normal draw on ``device``."""
    import torch

    from perfbench.counts.cnn import feature_size

    dt = getattr(torch, cfg["dtype"])
    k = cfg["kernel"]
    feat = feature_size(cfg)
    sizes = [k * k * L["c_in"] * L["c_out"] for L in cfg["layers"]]
    sizes += [L["c_out"] for L in cfg["layers"]]
    sizes += [feat * cfg["n_classes"], cfg["n_classes"]]
    g = generator(seed, SEED_WEIGHTS, device)
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    parts = list(torch.split(flat, sizes))
    n = len(cfg["layers"])
    params = {}
    for i, L in enumerate(cfg["layers"]):
        sd = math.sqrt(2.0 / (k * k * L["c_in"]))
        params[L["name"]] = {
            "w": (parts[i] * sd).reshape(k, k, L["c_in"], L["c_out"]).to(dt),
            "b": (parts[n + i] * 0.05).to(dt)}
    params["fc"] = {
        "w": (parts[2 * n] * math.sqrt(1.0 / feat)).reshape(
            feat, cfg["n_classes"]).to(dt),
        "b": (parts[2 * n + 1] * 0.05).to(dt)}
    return params


def program(cfg: dict):
    """The port's ``RoShamBoCNN`` for this configuration."""
    from repro_torch.accel.roshambo import ConvSpec, RoShamBoCNN, RoShamBoConfig

    specs = tuple(ConvSpec(L["name"], L["c_in"], L["c_out"], cfg["kernel"],
                           L["pool"]) for L in cfg["layers"])
    return RoShamBoCNN(RoShamBoConfig(input_hw=cfg["input_hw"],
                                      n_classes=cfg["n_classes"],
                                      layers=specs, dtype=cfg["dtype"]))
