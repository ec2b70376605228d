"""Feed-forward blocks: gated SiLU (llama-style) and GELU (classic)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (
    column_halves, contract_on_data, few_rows, is_dtensor, shard_placements)


def mlp_params(generator: torch.Generator, d_model: int, d_ff: int,
               kind: str, dtype: torch.dtype, device=None) -> dict:
    """``wi`` [D, 2F] (gated: ``[gate | up]``) or [D, F], ``wo`` [F, D],
    normal with the reference's scales, drawn on the generator's device."""
    width = 2 * d_ff if kind == "gated_silu" else d_ff
    g_dev = generator.device
    wi = torch.randn((d_model, width), generator=generator, device=g_dev)
    wo = torch.randn((d_ff, d_model), generator=generator, device=g_dev)
    return {"wi": (wi / math.sqrt(d_model)).to(device, dtype),
            "wo": (wo / math.sqrt(2.0 * d_ff)).to(device, dtype)}


def mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """A gated ``DTensor`` ``wi`` is taken as its two column halves
    (``column_halves``), the same products on the same columns; where a
    rank holds few rows (``few_rows``: a decode step) the product's
    columns are gathered instead, so the weight stays where it lies. Rows
    replicated on the data axes (B = 1) split each product's contraction
    over them (``contract_on_data``)."""
    if kind == "gated_silu" and is_dtensor(p["wi"]):
        if is_dtensor(x) and few_rows(x):
            h = contract_on_data(x, p["wi"]).redistribute(
                x.device_mesh, shard_placements(x.device_mesh, x.shape[0]))
            gate, up = h.chunk(2, dim=-1)
            return contract_on_data(F.silu(gate) * up, p["wo"])
        wg, wu = column_halves(p["wi"])
        return (F.silu(x @ wg) * (x @ wu)) @ p["wo"]
    h = contract_on_data(x, p["wi"])
    if kind == "gated_silu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return contract_on_data(h, p["wo"])
