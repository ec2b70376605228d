"""Decoder-only LM: the dense, vlm, moe, ssm and hybrid_moe families.

Params keep the reference's pytree layout: a dict of tensors whose
``blocks`` subtree is stacked over layers (leading [L] axis), so the port's
params and the reference's ``init_params`` carry over one to one
(:func:`params_from_jax`). The reference scans the stack with
``lax.scan``; here a Python loop (:func:`stack_apply`) walks per-layer
views of the stack (:func:`unstack`, no copy) layer by layer, each under
:func:`make_remat` when there is no cache. The skeleton is

    x -> [ layer_0 ... layer_{L-1} ] -> final_norm -> lm_head

with every family's layer the one :func:`layer_apply`: norm -> mixer
(attention or Mamba2) -> residual, then, where the block has one, norm ->
MLP or MoE -> residual. The dense and vlm families' layers are attention
and MLP, the moe family's attention and MoE, the ssm family's Mamba2
alone; the vlm family puts its patch embeddings before the text
(``prefix_embeds``). The decode cache is a stacked ``KVCache`` or
``SSMState``; each layer's new entries are written into the stacked
[L, ...] tensors in place (the reference scans a fresh cache out).

The hybrid_moe family (granite-4.0-h) has no JAX counterpart. Its layers
are Mamba2 or attention, as ``cfg.layer_types`` says, each followed by the
routed MoE plus the shared expert, with the published scalar multipliers
(``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier``, ``logits_scaling``) and ``norm_eps``, all of
which every family reads (at their defaults they change nothing). Its
params stack the norms and the MoE over every layer (``blocks``) and each
mixer kind over its own layers (``mamba``, ``attn``); its decode cache, a
:class:`HybridCache`, holds the attention layers' K/V and the Mamba2
layers' state side by side, advanced together by one step.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import default_device
from repro_torch.dist.sharding import (
    batch_sharded, contract_on_data, is_dtensor, layer_at)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import (
    KVCache, Length, attn_apply, attn_params)
from repro_torch.models.layers.mlp import mlp_apply, mlp_params
from repro_torch.models.layers.moe import moe_apply, moe_params
from repro_torch.models.layers.norm import apply_norm, norm_params
from repro_torch.models.layers.ssm import (
    SSMState,
    mamba2_apply,
    mamba2_params,
    ssm_state_zeros,
)
from repro_torch.utils import trace
from repro_torch.utils.pytree import tree_map, unstack


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _save_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots_nb"``: keep the outputs of the matrix products
    with no batch dimension (``mm`` / ``addmm``, the layers' weight
    products), recompute everything else, as the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def make_remat(cfg: ModelConfig) -> Callable:
    """Block-level activation checkpointing honouring ``cfg.remat`` and
    ``cfg.remat_policy``, as the reference's ``jax.checkpoint``: under
    grad, a wrapped block keeps its inputs and recomputes its activations
    in the backward (``torch.utils.checkpoint``, non-reentrant). With grad
    off (scoring, prefill, decode) the block runs as it is."""
    if not cfg.remat:
        return lambda f: f
    kw = {}
    if cfg.remat_policy == "dots_nb":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_products)

    def wrap(f: Callable) -> Callable:
        def run(*args):
            if not torch.is_grad_enabled():
                return f(*args)
            return checkpoint(f, *args, use_reentrant=False, **kw)
        return run
    return wrap


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block_params(generator: torch.Generator, cfg: ModelConfig,
                      device=None) -> dict:
    """Params for ONE block (``init_params`` stacks them); a hybrid_moe
    block's mixer is drawn with its kind's stack."""
    dt = _dtype(cfg)
    if cfg.family == "ssm":
        return {"ln1": norm_params(cfg.norm, cfg.d_model, device),
                "mixer": mamba2_params(generator, cfg, dt, device)}
    p = {"ln1": norm_params(cfg.norm, cfg.d_model, device)}
    if cfg.family != "hybrid_moe":
        p["attn"] = _attn_params(generator, cfg, device)
    p["ln2"] = norm_params(cfg.norm, cfg.d_model, device)
    if cfg.family in ("moe", "hybrid_moe"):
        p["moe"] = moe_params(generator, cfg.d_model, cfg.n_experts,
                              cfg.d_expert or cfg.d_ff, cfg.n_shared_experts,
                              dt, device)
    else:
        p["mlp"] = mlp_params(generator, cfg.d_model, cfg.d_ff, cfg.mlp, dt,
                              device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params with the reference's shapes, dtypes and scales, drawn
    from ``generator`` on its own device (so the values do not depend on
    ``device``), one block at a time into the stacked [L, ...] tensors."""
    device = default_device(device)
    dt = _dtype(cfg)
    g_dev = generator.device
    sd = 1.0 / math.sqrt(cfg.d_model)

    def draw(shape):
        w = torch.randn(shape, generator=generator, device=g_dev) * sd
        return w.to(device, dt)

    params: dict = {"embed": draw((cfg.vocab_padded, cfg.d_model))}
    params["blocks"] = stack_blocks(
        lambda: init_block_params(generator, cfg, device), cfg.n_layers,
        device)
    if cfg.family == "hybrid_moe":  # each mixer kind over its own layers
        params["mamba"] = stack_blocks(
            lambda: mamba2_params(generator, cfg, dt, device),
            len(cfg.mamba_layers), device)
        params["attn"] = stack_blocks(
            lambda: _attn_params(generator, cfg, device),
            len(cfg.attn_layers), device)
    params["final_norm"] = norm_params(cfg.norm, cfg.d_model, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((cfg.d_model, cfg.vocab_padded))
    return params


def _attn_params(generator: torch.Generator, cfg: ModelConfig,
                 device) -> dict:
    return attn_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_, bias=cfg.qkv_bias, dtype=_dtype(cfg),
                       device=device)


def stack_blocks(make_block: Callable[[], dict], n: int, device) -> dict:
    """``n`` blocks from ``make_block()``, drawn one at a time into
    stacked [n, ...] tensors (one block's draws in memory at a time)."""
    stacked = None
    for i in range(n):
        one = make_block()
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty(
                (n, *t.shape), dtype=t.dtype, device=device), one)
        _copy_into(stacked, one, i)
    return stacked


def _copy_into(stacked: dict, one: dict, i: int) -> None:
    for k, v in one.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy twin
        return torch.from_numpy(np.array(a).view(np.uint16)  # a copy
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(params_np: dict, device: "torch.device | str") -> dict:
    """The reference's ``init_params`` pytree, given as numpy arrays, as the
    port's params dict: same keys, same [L, ...]-stacked layouts, same
    values."""
    return tree_map(lambda a: _to_tensor(a, device), params_np)


# ---------------------------------------------------------------------------
# one layer, and the stack of them
# ---------------------------------------------------------------------------

def layer_apply(cfg: ModelConfig, kind: str, p: dict, mixer: dict,
                x: torch.Tensor, *, cache=None, positions=None):
    """One decoder layer: norm -> the mixer (``kind`` "attention" or
    "mamba", its params ``mixer``) -> residual, then, where the block ``p``
    holds an MLP or a MoE, norm -> that FFN -> residual. ``cache`` is the
    mixer's ``KVCache`` or ``SSMState``, or None. Returns (x, the mixer's
    new cache or state, aux): the MoE router's load-balance loss (an f32
    scalar tensor), None for a block without a MoE. A ``DTensor`` residual
    stream is kept batch-sharded (``batch_sharded``)."""
    h = apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        h, new = mamba2_apply(mixer, h, cfg, state=cache)
    else:
        h, new = attn_apply(
            mixer, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window, kv_chunk=cfg.attn_kv_chunk,
            blocks_threshold=cfg.attn_blocks_threshold,
            use_pallas=cfg.use_pallas_attention,
            scale=cfg.attention_multiplier or None, cache=cache,
            positions=positions)
    x = _residual(cfg, x, h)
    aux = None
    if "moe" in p:
        h, metrics = moe_apply(p["moe"], apply_norm(cfg.norm, p["ln2"], x,
                                                    cfg.norm_eps),
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               ep_sharding=cfg.moe_ep_sharding)
        aux = metrics.aux_loss
    elif "mlp" in p:
        h = mlp_apply(p["mlp"], apply_norm(cfg.norm, p["ln2"], x,
                                           cfg.norm_eps), cfg.mlp)
    else:  # the ssm family's block: the mixer alone
        return x, new, aux
    return _residual(cfg, x, h), new, aux


def _residual(cfg: ModelConfig, x: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """``x`` plus the branch ``h`` times ``cfg.residual_multiplier`` (no
    product where that is 1)."""
    r = cfg.residual_multiplier
    return batch_sharded(x + (h if r == 1.0 else h * r))


def _layers(cfg: ModelConfig, params: dict):
    """Each layer in order as (kind, block params, mixer params, slot in
    the cache). The kinds are ``cfg.layer_types`` where set, else one kind
    for every layer (Mamba2 for the attention-free ssm family). The
    reference's families keep a layer's mixer in its block (``attn`` /
    ``mixer``) and stack their caches over every layer, so the slot is the
    layer's index; hybrid_moe stacks each mixer kind over its own layers
    (``params["attn"]`` / ``params["mamba"]``), as its cache does, so the
    slot is the layer's place among its kind's."""
    kinds = cfg.layer_types or (
        "mamba" if cfg.is_attention_free else "attention",) * cfg.n_layers
    blocks = unstack(params["blocks"])
    stacks = {kind: unstack(params[key])
              for kind, key in (("attention", "attn"), ("mamba", "mamba"))
              if params.get(key) is not None}
    for i, kind in enumerate(kinds):
        if kind in stacks:
            j = kinds[:i].count(kind)
            yield kind, blocks[i], stacks[kind][j], j
        else:
            yield kind, blocks[i], blocks[i][
                "attn" if kind == "attention" else "mixer"], i


def write_state(stacked, i: int, new: SSMState) -> None:
    """One Mamba2 layer's new state and conv tail into slot ``i`` of a
    stacked state (an ``SSMState`` or a :class:`HybridCache`)."""
    layer_at(stacked.ssm, i).copy_(new.ssm)
    layer_at(stacked.conv, i).copy_(new.conv)


def stack_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, caches,
                positions):
    """Run the layers in order (:func:`_layers`). With a cache (a stacked
    ``KVCache`` or ``SSMState``, or a :class:`HybridCache`) each layer
    runs on its slot of it, updated in place; without, each layer runs
    under :func:`make_remat`. Returns (x, the cache of the type given, its
    length advanced, aux): the sum of the layers' router losses, an f32
    scalar on ``x``'s device."""
    layer = make_remat(cfg)(
        lambda kind, p, m, h: layer_apply(cfg, kind, p, m, h,
                                          positions=positions))
    aux, length = 0.0, None
    for kind, p, mixer, slot in _layers(cfg, params):
        if caches is None:
            x, _, a = layer(kind, p, mixer, x)
        elif kind == "mamba":
            x, st, a = layer_apply(
                cfg, kind, p, mixer, x, cache=SSMState(
                    layer_at(caches.ssm, slot), layer_at(caches.conv, slot)))
            write_state(caches, slot, st)
        else:
            x, kv, a = layer_apply(
                cfg, kind, p, mixer, x, cache=KVCache(
                    layer_at(caches.k, slot), layer_at(caches.v, slot),
                    caches.length), positions=positions)
            length = kv.length
        if a is not None:
            aux += a
    if not isinstance(aux, torch.Tensor):
        # a fill on the device, not a copy from pageable host memory
        aux = torch.full((), aux, dtype=torch.float32, device=x.device)
    if caches is None or isinstance(caches, SSMState):
        return x, caches, aux
    if length is None:  # no attention layer has advanced it
        length = caches.length + x.shape[1]
    return x, caches._replace(length=length), aux


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    x = lookup(params["embed"], tokens)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if prefix_embeds is not None:  # vlm: image patches before text
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``. With a ``DTensor`` table split over its features
    (the rules' choice where D divides "model"), each rank looks its own
    tokens up in its own columns and the result is sharded as they are:
    DTensor's own index op would gather the table and the tokens whole."""
    if not (is_dtensor(embed) or is_dtensor(tokens)) or (
            is_dtensor(embed) and any(p.is_shard(0)
                                      for p in embed.placements)):
        return embed[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (embed if is_dtensor(embed) else tokens).device_mesh
    rep = [Replicate()] * mesh.ndim
    e_pl = embed.placements if is_dtensor(embed) else rep
    t_pl = tokens.placements if is_dtensor(tokens) else rep
    # a rank's table gradient holds its own tokens' rows only: a partial
    # sum over the mesh dims that split the tokens
    grad_pl = [Partial() if pt.is_shard() and pe.is_replicate() else pe
               for pe, pt in zip(e_pl, t_pl)]
    local = (embed.to_local(grad_placements=grad_pl) if is_dtensor(embed)
             else embed)[tokens.to_local() if is_dtensor(tokens) else tokens]
    pl = [Shard(tokens.dim()) if pe.is_shard(1) else pt
          for pe, pt in zip(e_pl, t_pl)]
    shape = (*tokens.shape, embed.shape[1])
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, mesh, pl, shape=shape, stride=stride)


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       x: torch.Tensor) -> torch.Tensor:
    """f32 logits, as the reference's ``preferred_element_type=float32``:
    bf16 products are exact in f32 and summed in f32. On the card a bf16
    head is one bf16-in, f32-out product (``torch.mm`` with ``out_dtype``),
    with no f32 copy of the head (qwen2.5-3b's would be 2048 x 152064 x 4 B
    = 1.25 GB a call); its f32 output is summed in f32 whatever
    ``allow_bf16_reduced_precision_reduction`` says, which governs bf16
    outputs only. On the CPU, which has no such product, the operands are
    cast up, which is exact for bf16. A bf16 result would round the logits
    and move the greedy argmax. The logits are divided by
    ``cfg.logits_scaling`` (1: as they are)."""
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = head_product(x, head)
    if cfg.logits_scaling != 1.0:
        out = out / cfg.logits_scaling
    return out


def head_product(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ head``, as :func:`logits_from_hidden` takes it (a
    ``DTensor`` ``x`` through the up-cast product: DTensor has no rule
    for ``torch.mm``'s ``out_dtype``; rows replicated on the data axes
    split its contraction over them, ``contract_on_data``)."""
    if (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and head.dtype == torch.bfloat16 and not is_dtensor(x)):
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad
                                        or head.requires_grad):
            out = _HeadProduct.apply(x2, head)
        else:
            out = torch.mm(x2, head, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], head.shape[-1])
    return contract_on_data(x.float(), head.float())


class _HeadProduct(torch.autograd.Function):
    """The bf16-in, f32-out head product with a backward: ``torch.mm``
    with ``out_dtype`` has no derivative. The backward is two more bf16
    products into f32, the f32 cotangent rounded to bf16 first (an f32
    product would need the f32 copy of the head that the forward avoids),
    each gradient rounded to its operand's type."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        gx = gh = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(gb, head.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            gh = torch.mm(x2.t(), gb, out_dtype=torch.float32).to(head.dtype)
        return gx, gh


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None):
    """Scoring forward: tokens [B, S_text] -> logits [B, S, Vp], aux."""
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = stack_apply(cfg, params, x, None, positions)
    return logits_from_hidden(cfg, params, x), aux


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device=None) -> "KVCache | SSMState | HybridCache":
    """Stacked [L, ...] decode cache: for the dense family K/V with one
    length for every layer (they advance together), a Python int; for the
    ssm family the recurrent state (``s_max`` unused: it is O(1)); for the
    hybrid_moe family both, each over its own layers (:class:`HybridCache`)."""
    device = default_device(device)
    dt = _dtype(cfg)

    def states(n: int) -> SSMState:
        return SSMState(*(t[None].repeat(n, *([1] * t.dim())) for t in
                          ssm_state_zeros(cfg, batch, dt, device)))

    def kv(n: int) -> KVCache:
        shape = (n, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
        return KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device), 0)

    if cfg.family == "ssm":
        return states(cfg.n_layers)
    if cfg.family == "hybrid_moe":
        return HybridCache(*kv(len(cfg.attn_layers)),
                           *states(len(cfg.mamba_layers)))
    return kv(cfg.n_layers)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, s_max: int,
            *, prefix_embeds: torch.Tensor | None = None):
    """Fill the cache from a prompt; returns (last_logits, cache). While a
    profiler records, the call is a span named ``lm.prefill``."""
    with trace.span("lm.prefill"):
        x = embed_tokens(cfg, params, tokens, prefix_embeds)
        caches = cache_for(x, lambda dev: init_cache(cfg, x.shape[0], s_max,
                                                     dev))
        positions = torch.arange(x.shape[1], device=x.device)
        x, new_caches, _ = stack_apply(cfg, params, x, caches, positions)
        return logits_from_hidden(cfg, params, x[:, -1:]), new_caches


def cache_for(x: torch.Tensor, make: Callable):
    """``make(device)``, a new decode cache for ``x``'s rows, on ``x``'s
    device; for a ``DTensor`` ``x`` a tree of ``DTensor``s under
    ``decode_cache_sharding`` on ``x``'s mesh (slots on the data axes, an
    SSM state's heads on "model"), each rank allocating only its shard
    (``zeros_sharded``; the tree is laid out on the ``meta`` device
    first)."""
    if not is_dtensor(x):
        return make(x.device)
    from repro_torch.dist.sharding import decode_cache_sharding, zeros_sharded

    cache = make("meta")
    return zeros_sharded(cache, decode_cache_sharding(cache, x.device_mesh),
                         x.device)


def prefill_chunked(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    s_max: int, *, chunk: int = 4096,
                    prefix_embeds: torch.Tensor | None = None):
    """Blocks-mode prefill: run the prompt through the stack in sequence
    chunks, carrying the KV cache between chunks. Semantically identical to
    :func:`prefill` (causal attention never looks ahead), and the same
    ``lm.prefill`` span."""
    with trace.span("lm.prefill"):
        x = embed_tokens(cfg, params, tokens, prefix_embeds)
        s = x.shape[1]
        caches = cache_for(x, lambda dev: init_cache(cfg, x.shape[0], s_max,
                                                     dev))
        if s % chunk:
            raise ValueError(
                f"prompt length {s} not divisible by chunk {chunk}")
        last = None
        for c0 in range(0, s, chunk):
            xc = x[:, c0:c0 + chunk]
            xc, caches, _ = stack_apply(cfg, params, xc, caches, None)
            last = xc[:, -1:]
        return logits_from_hidden(cfg, params, last), caches


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                caches: "KVCache | SSMState"):
    """One decode step. token: [B, 1]; caches from prefill/init_cache
    (updated in place and returned). While a profiler records, the call
    is a span named ``lm.decode``."""
    with trace.span("lm.decode"):
        x = embed_tokens(cfg, params, token)
        x, new_caches, _ = stack_apply(cfg, params, x, caches, None)
        return logits_from_hidden(cfg, params, x), new_caches


# ---------------------------------------------------------------------------
# the hybrid_moe decode cache
# ---------------------------------------------------------------------------

class HybridCache(NamedTuple):
    """The hybrid_moe decode cache. ``k`` / ``v`` [La, B, S_max, Hkv, Dh]
    and ``length`` as a stacked ``KVCache``'s, over the attention layers;
    ``ssm`` [Lm, B, H, P, N] (f32) and ``conv`` [Lm, B, W-1, conv_dim] as
    a stacked ``SSMState``'s, over the Mamba2 layers. Every layer takes
    the same tokens, so one length serves them all."""

    k: torch.Tensor
    v: torch.Tensor
    length: Length
    ssm: torch.Tensor
    conv: torch.Tensor
