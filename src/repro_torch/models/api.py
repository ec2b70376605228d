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
dense family is ported; every other family raises ``NotImplementedError``
naming its ROADMAP item. The reference's dry-run helpers (``input_specs``,
``cache_specs``) are ROADMAP slice 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

# family -> the ROADMAP (Queue 1) item that ports it
_NOT_PORTED = {
    "vlm": "slice 4, item 15 (the vlm prefix-token config)",
    "audio": "slice 4, item 14 (models/encdec.py)",
    "moe": "slice 4, item 13 (models/layers/moe.py)",
    "ssm": "slice 4, item 12 (models/layers/ssm.py)",
    "hybrid": "slice 4, item 12 (models/hybrid.py)",
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
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")

    def init(generator: torch.Generator, device=None) -> dict:
        return lm.init_params(cfg, generator, device)

    def fwd(params, batch):
        return lm.forward(cfg, params, batch["tokens"])

    def loss(params, batch):
        logits, aux = fwd(params, batch)
        ce, acc = cross_entropy(logits, batch["labels"], cfg.vocab_padded)
        total = ce + cfg.router_aux_coef * aux
        return total, {"loss": ce, "aux": aux, "acc": acc}

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

    return Model(cfg=cfg, init=init, forward=fwd, loss=loss, prefill=pre,
                 decode=dec, init_cache=icache)
