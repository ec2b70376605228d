"""Plain PyTorch versions of decode attention (``csrc/decode_attention.cu``)
and of latent decode attention (``csrc/mla_decode.cu``): the path for
CPU tensors, and what the kernels are held against on the card.
Each materialises every row's scores and masks the rows past each slot's
live ones."""

from __future__ import annotations

import math

import torch


def live_rows(length, batch: int, s_max: int, device) -> torch.Tensor:
    """[B] int64: the cache rows slot b attends, min(length_b + 1, S_max)
    (no fewer than 0), for an int, 0-d or [B] ``length``."""
    n = torch.as_tensor(length, device=device).long() + 1
    return n.clamp(0, s_max).expand(batch)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, *, scale: float | None = None
                         ) -> torch.Tensor:
    """q: [B, 1, H, Dh]; k, v: [B, S_max, Hkv, Dh] (Hkv divides H; query
    head h reads KV head h // (H / Hkv)); ``length`` as :func:`live_rows`
    takes it, at least 0. Scores in f32 times ``scale`` (None:
    1/sqrt(Dh)); the probabilities, relative to the row's maximum, cast to
    q's type before the PV product, which and whose normaliser are summed
    in f32; output in q's type, [B, 1, H, Dh]."""
    b, _, h, dh = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qg = q[:, 0].float().reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k.float()) * scale
    live = (torch.arange(s_max, device=q.device)[None]
            < live_rows(length, b, s_max, q.device)[:, None])
    s = torch.where(live[:, None, None], s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bgrs,bsgd->bgrd", p.to(q.dtype).float(), v.float())
    o = o / p.sum(-1)[..., None]
    return o.reshape(b, 1, h, dh).to(q.dtype)


def mla_decode_ref(q: torch.Tensor, rows: torch.Tensor, length, *,
                   scale: float, value_dim: int) -> torch.Tensor:
    """q: [B, H, Dr]; rows: [B, S_max, Dr], every head reading every row;
    ``length`` as :func:`live_rows` takes it, at least 0. Scores in f32
    times ``scale``; the probabilities, relative to the row's maximum,
    cast to q's type before the PV product against each row's first
    ``value_dim`` columns, which and whose normaliser are summed in f32;
    output in q's type, [B, H, value_dim]."""
    b, s_max = q.shape[0], rows.shape[1]
    s = torch.einsum("bhd,bsd->bhs", q.float(), rows.float()) * scale
    live = (torch.arange(s_max, device=q.device)[None]
            < live_rows(length, b, s_max, q.device)[:, None])
    s = torch.where(live[:, None], s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhs,bsd->bhd", p.to(q.dtype).float(),
                     rows[..., :value_dim].float())
    return (o / p.sum(-1)[..., None]).to(q.dtype)
