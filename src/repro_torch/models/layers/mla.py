"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1) over a
latent KV cache.

For token t, head i and hidden state h (no query LoRA):

- q_i = (h W_Q)_i, ``qk_nope_head_dim + qk_rope_head_dim`` wide: q_i^C the
  first columns, q_i^R = RoPE(the rest);
- [c; k^R_raw] = h W_DKV; c <- RMSNorm(c), ``kv_lora_rank`` wide;
  k^R = RoPE(k^R_raw), one key of ``qk_rope_head_dim`` shared by every
  head;
- [k_i^C; v_i] = (c W_UKV)_i;
- s = (q_i^C . k_i^C + q_i^R . k^R) sigma, sigma = mscale^2 / sqrt(q width)
  with YaRN's mscale of ``yarn_mscale``; o = W_O concat_i sum softmax(s)
  v_i.

RoPE takes YaRN's frequencies over the rope columns
(``models/layers/rope.py``), in the port's half-split layout; with
``cfg.mla_nope`` (Kimi-Linear's ``mla_use_nope``) nothing is rotated, and
q^R, k^R are the projections' columns as they are.

The cache holds one row a token and layer, c then k^R
(:class:`LatentCache`), written in the cache's type. A prefill (more than
one new token) writes its rows, decompresses K and V from every cached row
up to the chunk's end and attends them causally: with
``use_pallas_attention`` through the flash kernel's two-width entry
(``kernels/flash_attention``, ``flash_attention_dkv``: bf16 on the tensor
cores, its plain version on CPU tensors), else through the plain routes
(``attention``: K is q's width, V ``v_head_dim``); with no cache the
sequence attends its own decompressed K/V. A decode step (one new token) is
absorbed, exactly in real arithmetic: q~_i = q_i^C W_UK,i^T, the score
(q~_i . c + q_i^R . k^R) sigma, o~_i = sum p c and o_i = o~_i W_UV,i. On
the card the latent decode kernel (``kernels/decode_attention``, entry
``mla_decode``) reads each slot's live rows, and raises ``ValueError``
where it is not built for the call (bf16, 16 or 32 heads, rows of 576,
values of 512); CPU tensors take its plain version.

While a profiler records, a prefill's cache write, decompression and
attention are a span named ``mla.prefill``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attention.kernel import mla_decode_bsd
from repro_torch.kernels.decode_attention.ref import mla_decode_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_dkv
from repro_torch.models.layers.attention import (
    Length, _cache_write, _positions, attention)
from repro_torch.models.layers.norm import rms_norm
from repro_torch.models.layers.rope import apply_rope, yarn_freqs, yarn_mscale
from repro_torch.utils import trace


class LatentCache(NamedTuple):
    """Preallocated latent decode cache for one layer (or, stacked, for
    all): ``kv`` [(L,) B, S_max, kv_lora_rank + qk_rope_head_dim], each row
    c then k^R; ``length`` the tokens already cached, as a ``KVCache``'s
    (an int, a 0-d tensor or [B] per-slot lengths)."""

    kv: torch.Tensor
    length: Length


def mla_params(generator: torch.Generator, cfg, dtype: torch.dtype,
               device=None) -> dict:
    """``wq`` [D, H (dn + dr)], ``wkv_a`` [D, r + dr] (c's columns
    first), ``kv_norm`` (f32 scale [r]), ``wkv_b`` [r, H (dn + dv)] (each
    head's k^C columns, then its v columns), ``wo`` [H dv, D]; normal with
    sd 1/sqrt(fan-in), drawn on the generator's device."""
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    g_dev = generator.device

    def draw(shape):
        w = torch.randn(shape, generator=generator, device=g_dev)
        return (w / math.sqrt(shape[0])).to(device, dtype)

    return {"wq": draw((d, h * (dn + dr))), "wkv_a": draw((d, r + dr)),
            "kv_norm": {"scale": torch.ones((r,), device=device)},
            "wkv_b": draw((r, h * (dn + dv))), "wo": draw((h * dv, d))}


def mla_scale(cfg) -> float:
    """sigma: 1/sqrt(the q width) times YaRN's mscale squared."""
    m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
         if cfg.yarn_factor else 1.0)
    return m * m / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE over the rope columns x [..., S, H, dr], at YaRN's frequencies
    where set. YaRN's cos / sin multiplier, mscale(factor, mscale) over
    mscale(factor, mscale_all_dim), is 1: the config holds one mscale for
    both, as DeepSeek-V2's configs give them equal."""
    inv = None
    if cfg.yarn_factor:
        inv = _yarn_inv_freq(x.shape[-1], cfg.rope_theta, cfg.yarn_factor,
                             cfg.yarn_original_max_pos, cfg.yarn_beta_fast,
                             cfg.yarn_beta_slow, x.device)
    return apply_rope(x, positions, cfg.rope_theta, inv_freq=inv)


@functools.lru_cache(maxsize=16)
def _yarn_inv_freq(*args) -> torch.Tensor:
    """``yarn_freqs`` of these arguments, made once a device: every layer
    and step reads the same constant (its construction is ~15 small ops a
    call, which a prefill chunk's host would repeat twice a layer)."""
    return yarn_freqs(*args)


def decompress(p: dict, cfg, rows: torch.Tensor):
    """(K [B, S, H, dn + dr], V [B, S, H, dv]) of latent rows [B, S, r +
    dr]: k_i^C and v_i from c W_UKV, k^R shared by every head."""
    b, s = rows.shape[:2]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    c, k_pe = rows.split([r, cfg.qk_rope_head_dim], dim=-1)
    kv = (c @ p["wkv_b"]).view(b, s, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, h, -1)], dim=-1)
    return k, v


def absorbed(p: dict, cfg, q_nope: torch.Tensor, q_pe: torch.Tensor,
             rows: torch.Tensor, length) -> torch.Tensor:
    """One new token a slot, absorbed: q_nope [B, H, dn] and q_pe [B, H,
    dr] against the latent rows [B, S_max, r + dr] after this step's write
    (``length`` the tokens cached before it) -> o [B, H, dv]: the latent
    kernel on the card, its plain version on the CPU."""
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    w = p["wkv_b"].view(r, h, dn + dv)
    q_lat = torch.cat([torch.einsum("bhd,rhd->bhr", q_nope, w[..., :dn]),
                       q_pe], dim=-1)
    route = mla_decode_ref if q_lat.device.type == "cpu" else mla_decode_bsd
    o_lat = route(q_lat, rows, length, scale=mla_scale(cfg), value_dim=r)
    return torch.einsum("bhr,rhd->bhd", o_lat, w[..., dn:])


def mla_apply(p: dict, x: torch.Tensor, cfg, *,
              cache: LatentCache | None = None,
              positions: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, LatentCache | None]:
    """x [B, S, D] -> (out [B, S, D], the cache with this call's rows
    written at ``cache.length``, in place, and its length advanced; None
    without a cache). ``positions``: [S] absolute positions for RoPE
    (default: arange, offset by the cache's length)."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    offset = cache.length if cache is not None else 0
    if positions is None:
        positions = _positions(offset, s, x.device)
    q = (x @ p["wq"]).view(b, s, h, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = (x @ p["wkv_a"]).split([r, dr], dim=-1)
    c = rms_norm(c, p["kv_norm"]["scale"], cfg.norm_eps)
    if not cfg.mla_nope:
        # q^R's heads and k^R as one more head, rotated in one call
        q_pe, k_pe = _rope(cfg, torch.cat([q_pe, k_pe[:, :, None]], dim=2),
                           positions).split([h, 1], dim=2)
        k_pe = k_pe[:, :, 0]
    row = torch.cat([c, k_pe], dim=-1)  # [B, S, r + dr]
    sigma = mla_scale(cfg)
    kw = dict(kv_chunk=cfg.attn_kv_chunk,
              blocks_threshold=cfg.attn_blocks_threshold, scale=sigma)
    new = None
    if cache is None:
        k, v = decompress(p, cfg, row)
        o = _attend(cfg, torch.cat([q_nope, q_pe], dim=-1), k, v, 0, kw)
    elif s == 1:
        _cache_write(cache.kv[:, :, None], row[:, :, None], cache.length)
        new = LatentCache(cache.kv, cache.length + s)
        o = absorbed(p, cfg, q_nope[:, 0], q_pe[:, 0], cache.kv,
                     cache.length)[:, None]
    else:
        with trace.span("mla.prefill"):
            o, new = _prefill(p, cfg, torch.cat([q_nope, q_pe], dim=-1),
                              row, cache, kw)
    return o.reshape(b, s, h * dv) @ p["wo"], new


def _prefill(p: dict, cfg, q: torch.Tensor, row: torch.Tensor,
             cache: LatentCache, kw: dict):
    """Several new tokens against the cache: their rows written, K/V
    decompressed from the cached rows up to their end (an int length), or
    from every row with the rest masked (tensor lengths), then attended
    causally through the plain routes."""
    s = q.shape[1]
    length = cache.length
    _cache_write(cache.kv[:, :, None], row[:, :, None], length)
    new = LatentCache(cache.kv, length + s)
    if isinstance(length, int):
        end = min(max(length, 0), cache.kv.shape[1] - s) + s
        k, v = decompress(p, cfg, cache.kv[:, :end])
        return _attend(cfg, q, k, v, end - s, kw), new
    k, v = decompress(p, cfg, cache.kv)
    return attention(q, k, v, q_offset=length, kv_valid=length + s,
                     **kw), new


def _attend(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_offset: int, kw: dict) -> torch.Tensor:
    """Causal attention of q [B, S, H, dn + dr] (row i at key position
    ``q_offset + i``) over the decompressed K [B, S_kv, H, dn + dr] and V
    [B, S_kv, H, dv]: the flash kernel's two-width entry where
    ``cfg.use_pallas_attention`` (it scales by 1/sqrt(dn + dr); sigma's
    rest goes into q), else the plain routes."""
    if cfg.use_pallas_attention:
        q = q * (kw["scale"] * math.sqrt(q.shape[-1]))
        return flash_attention_dkv(q, k, v, q_offset=q_offset)
    return attention(q, k, v, q_offset=q_offset, **kw)
