"""Plain PyTorch version of flash attention (materialised scores): the
same function as ``csrc/flash_attention.cu``, and the wrapper's path for
CPU tensors. On the card it is held against the kernel with
``torch.backends.cuda.matmul.allow_tf32 = False``."""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0**30  # finite: a fully masked row averages instead of NaN


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  n_rep: int = 1, q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, D]; k: [BHkv, Skv, D], v: [BHkv, Skv, Dv] with BH =
    BHkv * n_rep (query head h reads kv head h // n_rep); query row i at
    key position ``q_offset + i``. Scores in f32 scaled by 1/sqrt(D),
    probabilities cast to q's type before the PV product; output [BH, Sq,
    Dv] in q's type."""
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=0)
        v = v.repeat_interleave(n_rep, dim=0)
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)
