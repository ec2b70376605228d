"""Rotary position embeddings (llama convention: first/second half split),
computed in float32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """[head_dim//2] inverse frequencies (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (int)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)  # [dh/2]
    ang = positions[..., :, None].float() * inv  # [..., S, dh/2]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
