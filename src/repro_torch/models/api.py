"""Public model API: ``build_model(cfg)`` returns a :class:`Model` of plain
functions, as the reference's does:

- ``init(generator, device=None) -> params``  (the card unless ``device``
  names another)
- ``forward(params, batch) -> (logits, aux)``           (teacher-forced)
- ``loss(params, batch) -> (scalar, metrics)``
- ``prefill(params, batch, s_max) -> (logits, cache)``
- ``decode(params, token, cache) -> (logits, cache)``
- ``init_cache(batch, s_max, s_enc=None, device=None) -> cache``

Batches are dicts of tensors. Keys by family, as the reference's:

- dense / moe / ssm / hybrid / hybrid_moe: ``tokens`` [B,S], ``labels``
  [B,S]
- vlm: ``tokens`` [B,S_text], ``patch_embeds`` [B,n_prefix,D],
  ``labels`` [B,S_text] (the loss is taken over the text positions only)
- audio: ``frames`` [B,S_enc,D], ``tokens`` [B,S_dec], ``labels`` [B,S_dec]

The dense, vlm, moe, ssm and hybrid_moe families run through
``models/lm.py``, the
hybrid family through ``models/hybrid.py`` and the audio family through
``models/encdec.py``. For the dry run (``launch/dryrun.py``),
:func:`input_specs` and :func:`cache_specs` give every input of a shape
cell and the decode cache as tensors with no storage: fake tensors (on the
CPU) under the caller's ``FakeTensorMode``, else ``meta`` tensors, in place
of the reference's ``ShapeDtypeStruct``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.models import encdec, hybrid, lm
from repro_torch.models.config import ModelConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over valid positions (labels >= 0), and accuracy.

    logits: [B,S,Vp] float32; labels: [B,S] int (-1 = ignore). ``DTensor``
    logits take :func:`_sharded_cross_entropy`."""
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels)
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    denom = valid.sum().clamp_min(1)
    acc = ((logits.argmax(-1) == safe) & valid).sum() / denom
    return nll.sum() / denom, acc


def _sharded_cross_entropy(logits, labels):
    """:func:`cross_entropy` over ``DTensor`` logits: the vocab gathered
    and partial sums reduced (``_replicate_dim``), then each rank's rows
    scored on its local tensors (DTensor's backward of the label
    ``gather`` would build the whole batch's logits on every rank), and
    the sums taken as ``DTensor``s again."""
    from torch.distributed.tensor import DTensor, Replicate

    logits = _replicate_dim(logits, logits.dim() - 1)
    mesh, pl = logits.device_mesh, logits.placements
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    lab = labels.redistribute(mesh, pl).to_local()
    lg = logits.to_local()
    valid = lab >= 0
    safe = lab.clamp_min(0).long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, safe[..., None])[..., 0]
    nll, hit, valid = (DTensor.from_local(t, mesh, pl) for t in (
        (logz - gold) * valid, (lg.argmax(-1) == safe) & valid, valid))
    denom = valid.sum().clamp_min(1)
    return nll.sum() / denom, hit.sum() / denom


def _replicate_dim(t, dim: int):
    """``t`` (a ``DTensor``) with every mesh dim that shards tensor dim
    ``dim``, or holds partial sums (a tied head's product contracts over
    the model-sharded features), made ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate() if (isinstance(p, Shard) and p.dim == dim)
                  or p.is_partial() else p for p in t.placements]
    return t.redistribute(placements=placements)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio",
                          "hybrid_moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "audio":
        return _build_encdec(cfg)
    vlm = cfg.family == "vlm"

    def init(generator: torch.Generator, device=None) -> dict:
        return lm.init_params(cfg, generator, device)

    def fwd(params, batch):
        return lm.forward(cfg, params, batch["tokens"],
                          prefix_embeds=batch["patch_embeds"] if vlm
                          else None)

    def pre(params, batch, s_max):
        pe = batch.get("patch_embeds") if vlm else None
        s_tok = batch["tokens"].shape[1]
        if (cfg.prefill_chunk and pe is None
                and s_tok % cfg.prefill_chunk == 0
                and s_tok > cfg.prefill_chunk):
            return lm.prefill_chunked(cfg, params, batch["tokens"], s_max,
                                      chunk=cfg.prefill_chunk)
        return lm.prefill(cfg, params, batch["tokens"], s_max,
                          prefix_embeds=pe)

    def dec(params, token, cache):
        return lm.decode_step(cfg, params, token, cache)

    def icache(batch_size, s_max, s_enc=None, device=None):
        return lm.init_cache(cfg, batch_size, s_max, device)

    return Model(cfg=cfg, init=init, forward=fwd, loss=_loss(cfg, fwd),
                 prefill=pre, decode=dec, init_cache=icache)


def _loss(cfg: ModelConfig, fwd: Callable) -> Callable:
    def loss(params, batch):
        logits, aux = fwd(params, batch)
        if cfg.family == "vlm":  # the text positions, after the prefix
            logits = logits[:, cfg.n_prefix_tokens:]
        ce, acc = cross_entropy(logits, batch["labels"], cfg.vocab_padded)
        total = ce + cfg.router_aux_coef * aux
        return total, {"loss": ce, "aux": aux, "acc": acc}
    return loss


def _build_hybrid(cfg: ModelConfig) -> Model:
    def init(generator: torch.Generator, device=None) -> dict:
        return hybrid.init_params(cfg, generator, device)

    def fwd(params, batch):
        return hybrid.forward(cfg, params, batch["tokens"])

    def pre(params, batch, s_max):
        return hybrid.prefill(cfg, params, batch["tokens"], s_max)

    def dec(params, token, cache):
        return hybrid.decode_step(cfg, params, token, cache)

    def icache(batch_size, s_max, s_enc=None, device=None):
        return hybrid.init_cache(cfg, batch_size, s_max, device)

    return Model(cfg=cfg, init=init, forward=fwd, loss=_loss(cfg, fwd),
                 prefill=pre, decode=dec, init_cache=icache)


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(generator: torch.Generator, device=None) -> dict:
        return encdec.init_params(cfg, generator, device)

    def fwd(params, batch):
        return encdec.forward(cfg, params, batch["frames"], batch["tokens"])

    def pre(params, batch, s_max):
        return encdec.prefill(cfg, params, batch["frames"], batch["tokens"],
                              s_max)

    def dec(params, token, cache):
        return encdec.decode_step(cfg, params, token, cache)

    def icache(batch_size, s_max, s_enc=None, device=None):
        return encdec.init_dec_cache(cfg, batch_size, s_max, s_enc or s_max,
                                     device)

    return Model(cfg=cfg, init=init, forward=fwd, loss=_loss(cfg, fwd),
                 prefill=pre, decode=dec, init_cache=icache)


def _spec_device() -> str:
    """Where a stand-in lives: the CPU under an active ``FakeTensorMode``
    (its tensors have no storage), else the ``meta`` device."""
    from torch._guards import active_fake_mode

    return "cpu" if active_fake_mode() is not None else "meta"


def input_specs(cfg: ModelConfig, cell, *, for_init: bool = False) -> dict:
    """Stand-ins for every model input of a shape cell: the reference's
    keys, shapes and dtypes (tokens and labels int32), allocating nothing.
    ``decode`` cells describe the single-token step against a seq_len cache
    (built separately by :func:`cache_specs`)."""
    b, s = cell.global_batch, cell.seq_len
    dev = _spec_device()
    f = getattr(torch, cfg.dtype)

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    if cell.kind == "decode":
        return {"tokens": sds((b, 1), i32)}
    if cfg.family == "audio":
        return {"frames": sds((b, s, cfg.d_model), f),
                "tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
    if cfg.family == "vlm":
        s_text = s - cfg.n_prefix_tokens
        return {"tokens": sds((b, s_text), i32),
                "patch_embeds": sds((b, cfg.n_prefix_tokens, cfg.d_model), f),
                "labels": sds((b, s_text), i32)}
    return {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> Any:
    """``init_cache(batch, s_max)``'s tree, allocating nothing."""
    return build_model(cfg).init_cache(batch, s_max, device=_spec_device())
