"""Public wrapper: one decode step's attention over a [B, S_max, Hkv, Dh]
KV cache."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_bshd
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, *, scale: float | None = None) -> torch.Tensor:
    """q: [B, 1, H, Dh]; k, v: [B, S_max, Hkv, Dh]; slot b attends its rows
    j < min(length_b + 1, S_max) -> [B, 1, H, Dh]. On the card the kernel
    reads the cache where it lies; a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length, scale=scale)
    return decode_attention_bshd(q, k, v, length, scale=scale)
