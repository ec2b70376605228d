"""Normalisation layers (pure functions over explicit params), computed in
float32 and cast back to the input's type, as in the reference."""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import batch_sharded


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_params(kind: str, d: int, device=None) -> dict:
    if kind == "rms":
        return {"scale": torch.ones((d,), device=device)}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """A ``DTensor`` result is made batch-sharded again (``batch_sharded``):
    the rules shard a [D] scale over "model", which would leave the
    activations split over their features into the products that follow.
    ``eps`` is the RMS norm's (the layer norm keeps its 1e-5)."""
    if kind == "rms":
        return batch_sharded(rms_norm(x, params["scale"], eps))
    return batch_sharded(layer_norm(x, params["scale"], params["bias"]))
