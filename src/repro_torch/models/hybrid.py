"""Hybrid Mamba2 + shared-attention model (zamba2 backbone).

Zamba2's design: a deep stack of Mamba2 blocks, plus ONE shared transformer
block (attention + MLP over the concatenation [x, x_embed0], i.e. width
2*d_model) whose weights are reused at every application point, specialised
by per-application LoRA adapters (on the q projection and the MLP input
projection). The shared block runs before every group of
``hybrid_attn_every`` Mamba layers.

Params keep the reference's pytree: ``groups`` is a list (one entry per
group) of dicts stacked over the group's layers. The reference scans each
group with ``lax.scan``; here a Python loop indexes the stacked tensors.
The shared block's attention is the plain ``attention`` (no flash kernel),
as in the reference. The decode cache is a list of per-group
``{"ssm": stacked SSMState, "kv": KVCache}``, updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import default_device
from repro_torch.dist.sharding import (
    batch_sharded, column_halves, contract_on_data, is_dtensor, layer_at)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (
    KVCache,
    attend_projected,
    attn_params,
)
from repro_torch.models.layers.mlp import mlp_params
from repro_torch.models.layers.norm import apply_norm, norm_params
from repro_torch.models.layers.ssm import (
    SSMState,
    mamba2_apply,
    mamba2_params,
    ssm_state_zeros,
)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def n_groups(cfg: ModelConfig) -> int:
    return math.ceil(cfg.n_layers / cfg.hybrid_attn_every)


def group_sizes(cfg: ModelConfig) -> list[int]:
    full, rem = divmod(cfg.n_layers, cfg.hybrid_attn_every)
    return [cfg.hybrid_attn_every] * full + ([rem] if rem else [])


def _head_dim2(cfg: ModelConfig) -> int:
    return (2 * cfg.d_model) // cfg.n_heads


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the reference's shapes, dtypes and scales, drawn
    from ``generator`` on its own device, one mamba layer at a time into
    each group's stacked [size, ...] tensors."""
    device = default_device(device)
    dt = _dt(cfg)
    d2 = 2 * cfg.d_model
    g_dev = generator.device

    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, device=g_dev) * scale
        return w.to(device, dt)

    groups = [lm.stack_blocks(
        lambda: {"ln1": norm_params(cfg.norm, cfg.d_model, device),
                 "mixer": mamba2_params(generator, cfg, dt, device)},
        size, device) for size in group_sizes(cfg)]

    shared = {
        "ln1": norm_params(cfg.norm, d2, device),
        "attn": attn_params(generator, d2, cfg.n_heads, cfg.n_kv_heads,
                            _head_dim2(cfg), bias=False, dtype=dt,
                            device=device),
        "ln2": norm_params(cfg.norm, d2, device),
        "mlp": mlp_params(generator, d2, cfg.d_ff, cfg.mlp, dt, device),
        "proj_out": draw((d2, cfg.d_model), 1.0 / math.sqrt(d2)),
    }
    r = cfg.hybrid_lora_rank
    ng = n_groups(cfg)
    mlp_width = 2 * cfg.d_ff if cfg.mlp == "gated_silu" else cfg.d_ff
    loras = {
        "a_q": draw((ng, d2, r), 1.0 / math.sqrt(d2)),
        "b_q": torch.zeros((ng, r, cfg.n_heads * _head_dim2(cfg)), dtype=dt,
                           device=device),
        "a_mlp": draw((ng, d2, r), 1.0 / math.sqrt(d2)),
        "b_mlp": torch.zeros((ng, r, mlp_width), dtype=dt, device=device),
    }
    sd = 1.0 / math.sqrt(cfg.d_model)
    return {
        "embed": draw((cfg.vocab_padded, cfg.d_model), sd),
        "groups": groups,
        "shared": shared,
        "loras": loras,
        "final_norm": norm_params(cfg.norm, cfg.d_model, device),
        "lm_head": draw((cfg.d_model, cfg.vocab_padded), sd),
    }


def _shared_block(cfg: ModelConfig, shared: dict, loras: dict, gi: int,
                  x: torch.Tensor, x0: torch.Tensor, *,
                  cache: KVCache | None = None):
    """Shared attention+MLP over concat([x, x0]) with group-gi LoRA.

    Returns (new_x [B,S,D], new_cache); the cache's K/V are written in
    place. Rows replicated on the data axes (B = 1) split each product's
    contraction over them (``contract_on_data``)."""
    hd = _head_dim2(cfg)
    b, s, _ = x.shape
    mm = contract_on_data
    h = torch.cat([x, x0], dim=-1)
    hn = apply_norm(cfg.norm, shared["ln1"], h)

    p = shared["attn"]
    # LoRA on q
    q = mm(hn, p["wq"]) + mm(mm(hn, layer_at(loras["a_q"], gi)),
                             layer_at(loras["b_q"], gi))
    o, new_cache = attend_projected(
        q, mm(hn, p["wk"]), mm(hn, p["wv"]), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=hd, rope_theta=cfg.rope_theta,
        window=0, kv_chunk=cfg.attn_kv_chunk,
        blocks_threshold=cfg.attn_blocks_threshold, use_pallas=False,
        cache=cache, positions=None, cross=False, causal=True)
    h = batch_sharded(h + mm(o.reshape(b, s, cfg.n_heads * hd), p["wo"]))

    h2 = apply_norm(cfg.norm, shared["ln2"], h)
    wi, b_mlp = shared["mlp"]["wi"], layer_at(loras["b_mlp"], gi)
    lo = mm(h2, layer_at(loras["a_mlp"], gi))
    if cfg.mlp == "gated_silu" and is_dtensor(wi):
        # the [gate | up] columns a half at a time (``column_halves``)
        (wg, wu), (bg, bu) = column_halves(wi), column_halves(b_mlp)
        z = F.silu(mm(h2, wg) + mm(lo, bg)) * (mm(h2, wu) + mm(lo, bu))
    elif cfg.mlp == "gated_silu":
        gate, up = (h2 @ wi + lo @ b_mlp).chunk(2, dim=-1)
        z = F.silu(gate) * up
    else:  # jax.nn.gelu's default
        z = F.gelu(mm(h2, wi) + mm(lo, b_mlp), approximate="tanh")
    h = batch_sharded(h + mm(z, shared["mlp"]["wo"]))
    return mm(h, shared["proj_out"]), new_cache


def _mamba_group_scan(cfg: ModelConfig, gparams: dict, x: torch.Tensor,
                      states: SSMState | None = None):
    """Run the mamba layers of one group in order. ``states``: the group's
    stacked SSMState, updated in place (and returned), or None (then each
    layer runs through ``make_remat``, as the reference's scan body)."""

    def layer(lp, h):
        return batch_sharded(h + mamba2_apply(
            lp["mixer"], apply_norm(cfg.norm, lp["ln1"], h), cfg)[0])

    remat_layer = lm.make_remat(cfg)(layer)
    for i, lp in enumerate(lm.unstack(gparams)):
        if states is None:
            x = remat_layer(lp, x)
            continue
        hn = apply_norm(cfg.norm, lp["ln1"], x)
        st = SSMState(layer_at(states.ssm, i), layer_at(states.conv, i))
        out, new_st = mamba2_apply(lp["mixer"], hn, cfg, state=st)
        x = batch_sharded(x + out)
        lm.write_state(states, i, new_st)
    return x, states


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Scoring forward. Returns (logits [B,S,Vp] f32, aux=0)."""
    x = lm.lookup(params["embed"], tokens)
    x0 = x
    # remat the shared block, as the reference does: its [B,H,S,S] f32
    # scores would otherwise stay in memory for the whole backward
    shared = lm.make_remat(cfg)(lambda sh, lo, gi, a, b: _shared_block(
        cfg, sh, lo, gi, a, b)[0])
    for gi in range(n_groups(cfg)):
        h = shared(params["shared"], params["loras"], gi, x, x0)
        x = batch_sharded(x + h)
        x, _ = _mamba_group_scan(cfg, params["groups"][gi], x)
    logits = lm.logits_from_hidden(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """Per group: stacked SSM states + one shared-attn KV cache.

    The shared-attn cache is the only O(S) memory; SSM state is O(1)."""
    device = default_device(device)
    dt = _dt(cfg)
    st = ssm_state_zeros(cfg, batch, dt, device)
    hd = _head_dim2(cfg)
    return [{"ssm": SSMState(*(t[None].repeat(size, *([1] * t.dim()))
                               for t in st)),
             "kv": KVCache.zeros(batch, s_max, cfg.n_kv_heads, hd, dt,
                                 device)}
            for size in group_sizes(cfg)]


def _run_cached(cfg: ModelConfig, params: dict, x: torch.Tensor, caches):
    x0 = x
    new_caches = []
    for gi in range(n_groups(cfg)):
        h, kv = _shared_block(cfg, params["shared"], params["loras"], gi, x,
                              x0, cache=caches[gi]["kv"])
        x = batch_sharded(x + h)
        x, ssm = _mamba_group_scan(cfg, params["groups"][gi], x,
                                   states=caches[gi]["ssm"])
        new_caches.append({"ssm": ssm, "kv": kv})
    return x, new_caches


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            s_max: int):
    """Fill the caches from a prompt; returns (last_logits, caches)."""
    x = lm.lookup(params["embed"], tokens)
    caches = lm.cache_for(x, lambda dev: init_cache(cfg, x.shape[0], s_max,
                                                    dev))
    x, new_caches = _run_cached(cfg, params, x, caches)
    return lm.logits_from_hidden(cfg, params, x[:, -1:]), new_caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor, caches):
    """One decode step. token: [B, 1]; caches from prefill/init_cache
    (updated in place and returned)."""
    x = lm.lookup(params["embed"], token)
    x, new_caches = _run_cached(cfg, params, x, caches)
    return lm.logits_from_hidden(cfg, params, x), new_caches
