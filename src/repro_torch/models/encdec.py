"""Encoder-decoder transformer (the seamless-m4t backbone).

The audio frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings [B, S_enc, D]; the encoder is a bidirectional
transformer over them; the decoder is an autoregressive stack with
cross-attention. Both stacks keep the reference's params layout (leading
[L] axis); where the reference scans a stack, a Python loop indexes layer
``i`` (a view), and the decoder's self-attention cache is written in place,
as ``models/lm.py`` does. The encoder calls attention without the flash
kernel, as the reference's does, so no path here reaches the kernel.

The decode cache is ``{"self": KVCache, "cross": KVCache}`` stacked over
the decoder layers: the self cache with one length for every layer (a
Python int), the cross cache holding each layer's projected encoder K/V,
filled once by :func:`prefill` and read by every decode step.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import default_device
from repro_torch.dist.sharding import (
    batch_sharded, contract_on_data, is_dtensor, layer_at)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (
    KVCache,
    attend_projected,
    attn_apply,
    attn_params,
)
from repro_torch.models.layers.mlp import mlp_apply, mlp_params
from repro_torch.models.layers.norm import apply_norm, norm_params
from repro_torch.models.lm import (
    cache_for,
    head_product,
    lookup,
    make_remat,
    stack_blocks,
    unstack,
)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attn(cfg: ModelConfig, p: dict, x: torch.Tensor, **kw):
    return attn_apply(p, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                      head_dim=cfg.head_dim_, kv_chunk=cfg.attn_kv_chunk,
                      blocks_threshold=cfg.attn_blocks_threshold, **kw)


def init_enc_block(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    return {
        "ln1": norm_params(cfg.norm, cfg.d_model, device),
        "attn": attn_params(generator, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim_, bias=cfg.qkv_bias,
                            dtype=_dt(cfg), device=device),
        "ln2": norm_params(cfg.norm, cfg.d_model, device),
        "mlp": mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.mlp, _dt(cfg),
                          device),
    }


def init_dec_block(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    def attn():
        return attn_params(generator, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim_, bias=cfg.qkv_bias,
                           dtype=_dt(cfg), device=device)

    return {
        "ln1": norm_params(cfg.norm, cfg.d_model, device),
        "attn": attn(),
        "ln_x": norm_params(cfg.norm, cfg.d_model, device),
        "xattn": attn(),
        "ln2": norm_params(cfg.norm, cfg.d_model, device),
        "mlp": mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.mlp, _dt(cfg),
                          device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the reference's shapes, dtypes and scales, drawn
    from ``generator`` on its own device, one block at a time into the
    stacked [L, ...] tensors."""
    device = default_device(device)
    sd = 1.0 / math.sqrt(cfg.d_model)
    g_dev = generator.device

    def draw(shape):
        w = torch.randn(shape, generator=generator, device=g_dev) * sd
        return w.to(device, _dt(cfg))

    return {
        "embed": draw((cfg.vocab_padded, cfg.d_model)),
        "enc_blocks": stack_blocks(
            lambda: init_enc_block(generator, cfg, device), cfg.n_enc_layers,
            device),
        "dec_blocks": stack_blocks(
            lambda: init_dec_block(generator, cfg, device), cfg.n_layers,
            device),
        "enc_norm": norm_params(cfg.norm, cfg.d_model, device),
        "final_norm": norm_params(cfg.norm, cfg.d_model, device),
        "lm_head": draw((cfg.d_model, cfg.vocab_padded)),
    }


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, S_enc, D] (stub frontend output) -> encoder states."""

    def block(p, x):
        h, _ = _attn(cfg, p["attn"], apply_norm(cfg.norm, p["ln1"], x),
                     rope_theta=cfg.rope_theta, causal=False)
        x = batch_sharded(x + h)
        return batch_sharded(x + mlp_apply(
            p["mlp"], apply_norm(cfg.norm, p["ln2"], x), cfg.mlp))

    block = make_remat(cfg)(block)
    x = frames.to(_dt(cfg))
    for p in unstack(params["enc_blocks"]):
        x = block(p, x)
    return apply_norm(cfg.norm, params["enc_norm"], x)


def _dec_block(cfg, p, x, enc, self_cache=None, cross_cache=None):
    h, new_self = _attn(cfg, p["attn"], apply_norm(cfg.norm, p["ln1"], x),
                        rope_theta=cfg.rope_theta, cache=self_cache)
    x = batch_sharded(x + h)
    h, new_cross = _attn(cfg, p["xattn"], apply_norm(cfg.norm, p["ln_x"], x),
                         rope_theta=0.0, xk=enc, cache=cross_cache,
                         causal=False)
    x = batch_sharded(x + h)
    x = batch_sharded(x + mlp_apply(
        p["mlp"], apply_norm(cfg.norm, p["ln2"], x), cfg.mlp))
    return x, new_self, new_cross


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits through the untied ``lm_head``, as the reference's
    ``preferred_element_type=float32`` einsum."""
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return head_product(x, params["lm_head"])


def forward(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor):
    """Scoring forward: logits over the decoder positions, aux = 0."""
    enc = encode(cfg, params, frames)
    x = lookup(params["embed"], tokens)
    block = make_remat(cfg)(lambda p, h: _dec_block(cfg, p, h, enc)[0])
    for p in unstack(params["dec_blocks"]):
        x = block(p, x)
    return (_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_dec_cache(cfg: ModelConfig, batch: int, s_max: int, s_enc: int,
                   device=None) -> dict:
    """Self cache [L, B, s_max, Hkv, Dh] at length 0 and cross cache
    [L, B, s_enc, Hkv, Dh], zeros, on ``device`` (the card by default)."""
    device = default_device(device)
    dt = _dt(cfg)

    def stack(s: int) -> KVCache:
        shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim_)
        return KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device), 0)

    return {"self": stack(s_max), "cross": stack(s_enc)}


def _fill_cross(cfg, p, enc, cc: KVCache) -> KVCache:
    """The encoder's K/V projected through one layer's cross-attention,
    written into that layer's cross cache ``cc`` in place."""
    b, s_enc, _ = enc.shape
    kf = enc @ p["xattn"]["wk"] + p["xattn"].get("bk", 0)
    vf = enc @ p["xattn"]["wv"] + p["xattn"].get("bv", 0)
    if is_dtensor(kf):  # the cache's placements (its rows), then heads
        kf, vf = (t.redistribute(t.device_mesh, cc.k.placements)
                  for t in (kf, vf))
    k = kf.reshape(b, s_enc, cfg.n_kv_heads, cfg.head_dim_)
    v = vf.reshape(b, s_enc, cfg.n_kv_heads, cfg.head_dim_)
    cc.k.copy_(k)
    cc.v.copy_(v)
    return KVCache(cc.k, cc.v, s_enc)


def prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, s_max: int):
    """Encode, then run the decoder over the prompt, filling the self and
    cross caches; returns (last logits, caches). The cross cache holds the
    projected encoder K/V, so decode steps never project the encoder
    states again."""
    enc = encode(cfg, params, frames)
    x = lookup(params["embed"], tokens)
    caches = cache_for(x, lambda dev: init_dec_cache(
        cfg, x.shape[0], s_max, enc.shape[1], dev))
    sc, cc = caches["self"], caches["cross"]
    length = sc.length
    for i, p in enumerate(unstack(params["dec_blocks"])):
        cross = _fill_cross(cfg, p, enc, KVCache(layer_at(cc.k, i),
                                                 layer_at(cc.v, i), 0))
        x, new_self, _ = _dec_block(
            cfg, p, x, enc, self_cache=KVCache(
                layer_at(sc.k, i), layer_at(sc.v, i), sc.length),
            cross_cache=cross)
        length = new_self.length
    return (_logits(cfg, params, x[:, -1:]),
            {"self": KVCache(sc.k, sc.v, length),
             "cross": KVCache(cc.k, cc.v, enc.shape[1])})


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                caches: dict):
    """One decoder token against the prebuilt self / cross caches (the
    self cache updated in place and returned)."""
    x = lookup(params["embed"], token)
    sc, cc = caches["self"], caches["cross"]
    length = sc.length
    for i, p in enumerate(unstack(params["dec_blocks"])):
        x, new_self, _ = _dec_block_cached(
            cfg, p, x,
            KVCache(layer_at(sc.k, i), layer_at(sc.v, i), sc.length),
            KVCache(layer_at(cc.k, i), layer_at(cc.v, i), cc.length))
        length = new_self.length
    return (_logits(cfg, params, x),
            {"self": KVCache(sc.k, sc.v, length), "cross": cc})


def _dec_block_cached(cfg, p, x, self_cache: KVCache, cross_cache: KVCache):
    h, new_self = _attn(cfg, p["attn"], apply_norm(cfg.norm, p["ln1"], x),
                        rope_theta=cfg.rope_theta, cache=self_cache)
    x = x + h
    # cross-attention straight against the cached projected encoder K/V
    b, s, _ = x.shape
    xq = apply_norm(cfg.norm, p["ln_x"], x)
    o, _ = attend_projected(
        contract_on_data(xq, p["xattn"]["wq"]) + p["xattn"].get("bq", 0),
        None, None,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_,
        rope_theta=0.0, window=0, kv_chunk=cfg.attn_kv_chunk,
        blocks_threshold=cfg.attn_blocks_threshold, use_pallas=False,
        cache=cross_cache, positions=None, cross=True, causal=False)
    x = x + contract_on_data(o.reshape(b, s, cfg.n_heads * cfg.head_dim_),
                             p["xattn"]["wo"])
    x = x + mlp_apply(p["mlp"], apply_norm(cfg.norm, p["ln2"], x), cfg.mlp)
    return x, new_self, cross_cache
