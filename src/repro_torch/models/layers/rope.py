"""Rotary position embeddings (llama convention: first/second half split),
computed in float32, and YaRN's frequencies and attention scale
(DeepSeek-V2's ``yarn_find_correction_range``, ``yarn_linear_ramp_mask``
and ``yarn_get_mscale``)."""

from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """[head_dim//2] inverse frequencies (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_correction_range(dim: int, theta: float, original_max_pos: int,
                          beta_fast: float, beta_slow: float
                          ) -> tuple[int, int]:
    """(low, high): the frequency indices below which RoPE keeps its
    frequencies and above which they are divided by the factor."""
    def at(rotations: float) -> float:
        return (dim * math.log(original_max_pos / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    return (max(math.floor(at(beta_fast)), 0),
            min(math.ceil(at(beta_slow)), dim - 1))


def yarn_freqs(dim: int, theta: float, factor: float, original_max_pos: int,
               beta_fast: float, beta_slow: float,
               device=None) -> torch.Tensor:
    """[dim//2] YaRN inverse frequencies (float32): RoPE's below ``low``,
    RoPE's over ``factor`` above ``high``, a linear ramp between."""
    low, high = yarn_correction_range(dim, theta, original_max_pos,
                                      beta_fast, beta_slow)
    extra = rope_freqs(dim, theta, device)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature term, 1 for a factor of at most 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               inv_freq: torch.Tensor | None = None) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (int). ``inv_freq`` [Dh/2]
    replaces RoPE's frequencies (YaRN's)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device) if inv_freq is None else inv_freq
    ang = positions[..., :, None].float() * inv  # [..., S, dh/2]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
