"""Public model API: ``build_model(cfg)`` returns a :class:`Model` of plain
functions, as the reference's does:

- ``init(generator, device=None) -> params``  (the card unless ``device``
  names another)
- ``forward(params, batch) -> (logits, aux)``           (teacher-forced)
- ``loss(params, batch) -> (scalar, metrics)``
- ``prefill(params, batch, s_max) -> (logits, cache)``
- ``decode(params, token, cache) -> (logits, cache)``
- ``init_cache(batch, s_max, s_enc=None, device=None) -> cache``

Batches are dicts of tensors: ``tokens`` [B,S] and ``labels`` [B,S]. The
dense and ssm families run through ``models/lm.py``, the hybrid family
through ``models/hybrid.py``; every other family raises
``NotImplementedError`` naming its ROADMAP item. The reference's dry-run
helpers (``input_specs``, ``cache_specs``) are ROADMAP slice 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import hybrid, lm
from repro_torch.models.config import ModelConfig

# family -> the ROADMAP (Queue 1) item that ports it
_NOT_PORTED = {
    "vlm": "slice 4, item 15 (the vlm prefix-token config)",
    "audio": "slice 4, item 14 (models/encdec.py)",
    "moe": "slice 4, item 13 (models/layers/moe.py)",
}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over valid positions (labels >= 0), and accuracy.

    logits: [B,S,Vp] float32; labels: [B,S] int (-1 = ignore)."""
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    denom = valid.sum().clamp_min(1)
    acc = ((logits.argmax(-1) == safe) & valid).sum() / denom
    return nll.sum() / denom, acc


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
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP Queue 1, "
            f"{_NOT_PORTED[cfg.family]}")
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)

    def init(generator: torch.Generator, device=None) -> dict:
        return lm.init_params(cfg, generator, device)

    def fwd(params, batch):
        return lm.forward(cfg, params, batch["tokens"])

    def pre(params, batch, s_max):
        s_tok = batch["tokens"].shape[1]
        if (cfg.prefill_chunk and s_tok % cfg.prefill_chunk == 0
                and s_tok > cfg.prefill_chunk):
            return lm.prefill_chunked(cfg, params, batch["tokens"], s_max,
                                      chunk=cfg.prefill_chunk)
        return lm.prefill(cfg, params, batch["tokens"], s_max)

    def dec(params, token, cache):
        return lm.decode_step(cfg, params, token, cache)

    def icache(batch_size, s_max, s_enc=None, device=None):
        return lm.init_cache(cfg, batch_size, s_max, device)

    return Model(cfg=cfg, init=init, forward=fwd, loss=_loss(cfg, fwd),
                 prefill=pre, decode=dec, init_cache=icache)


def _loss(cfg: ModelConfig, fwd: Callable) -> Callable:
    def loss(params, batch):
        logits, aux = fwd(params, batch)
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
