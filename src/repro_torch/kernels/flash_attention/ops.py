"""Public wrapper: [B, S, H, Dh] GQA flash attention."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain version on [B, S, H, Dh] tensors, through the reference's
    [BH, S, Dh] layout: the wrapper's path for CPU tensors, and what the
    kernel is held against on the card."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, sq, dh)
    kf = k.transpose(1, 2).reshape(b * hkv, k.shape[1], dh)
    vf = v.transpose(1, 2).reshape(b * hkv, v.shape[1], dh)
    of = attention_ref(qf, kf, vf, causal=causal, window=window,
                       n_rep=h // hkv)
    return of.reshape(b, h, sq, dh).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, Hkv, Dh] -> [B, Sq, H, Dh].

    On the card the kernel reads the tensors by stride (no transposes); a
    CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention_bshd(q, k, v, causal=causal, window=window)
