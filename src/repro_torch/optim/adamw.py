"""AdamW with mixed precision, the reference's arithmetic in plain PyTorch.

Params stay in the model's compute dtype (bf16 at full width); the
optimizer state carries an f32 master copy plus f32 first and second
moments, and ``step`` as an int32 0-d tensor on the device.

Unlike the reference, which returns new trees (its train step donates
the old buffers), the update writes the moments, the master copy, the
step and the params IN PLACE, and it goes leaf by leaf in flat chunks
(``utils.pytree.CHUNK`` elements), casting each gradient chunk to f32
inside its own update: a tree-wide f32 copy of the gradients would hold
another 13.6 GB at qwen2.5-3b's size. Nothing here synchronises with the
host: the non-finite skip is a ``torch.where`` on a device flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.utils.pytree import (
    chunks,
    global_norm,
    tree_finite,
    tree_leaves,
    tree_map,
)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    skip_nonfinite: bool = True  # fault tolerance: skip bad steps


def adamw_init(params: Any) -> dict:
    # a copy: an f32 leaf's master must NOT alias the param, which the
    # update overwrites with the rounded master
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": tree_map(
            lambda x: x.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
        "v": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), params),
    }


def adamw_update(cfg: AdamWConfig, grads: Any, opt_state: dict, params: Any,
                 lr_scale: "torch.Tensor | float" = 1.0
                 ) -> tuple[Any, dict, dict]:
    """Returns (params, opt_state, metrics): ``params`` and ``opt_state``
    are the objects given, updated in place. The update runs in a
    ``torch.profiler`` range named ``optim.adamw``."""
    with torch.profiler.record_function("optim.adamw"):
        return _update(cfg, grads, opt_state, params, lr_scale)


def _update(cfg, grads, opt_state, params, lr_scale):
    gnorm = global_norm(grads)
    if is_dtensor(gnorm):  # summed over every shard: a plain scalar
        gnorm = gnorm.full_tensor()
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    # cfg.grad_clip / max(gnorm, 1e-9) as a true division (a Python
    # number over a tensor is a reciprocal times the number in torch)
    clip = torch.minimum(one, (one * cfg.grad_clip)
                         / torch.clamp(gnorm, min=1e-9))
    old_step = opt_state["step"]
    if is_dtensor(old_step):  # replicated: every rank holds the step
        old_step = old_step.to_local()
    if is_dtensor(lr_scale):
        lr_scale = lr_scale.full_tensor()
    step = old_step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale
    ok = tree_finite(grads) if cfg.skip_nonfinite else None
    if is_dtensor(ok):
        ok = ok.full_tensor()
    ok = ok.to(gnorm.device) if ok is not None else None

    def keep(old: torch.Tensor, new: torch.Tensor) -> None:
        old.copy_(new if ok is None else torch.where(ok, new, old))

    for g, m, v, ma, p in zip(*(tree_leaves(tree) for tree in (
            grads, opt_state["m"], opt_state["v"], opt_state["master"],
            params))):
        if is_dtensor(p):  # each rank updates its own shard
            g = g.redistribute(p.device_mesh, p.placements)
            g, m, v, ma, p = (x.to_local() for x in (g, m, v, ma, p))
        if not all(x.is_contiguous() for x in (m, v, ma, p)):
            raise ValueError("adamw_update writes the state and the params "
                             "in place: each leaf must be contiguous")
        decay = ma.dim() >= 2  # decoupled weight decay on matrices only
        for gc, mc, vc, mac, pc in zip(*(chunks(x) for x in (g, m, v, ma, p))):
            g32 = gc.float() * clip
            m_new = cfg.b1 * mc + (1 - cfg.b1) * g32
            v_new = cfg.b2 * vc + (1 - cfg.b2) * torch.square(g32)
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            if decay:
                update = update + cfg.weight_decay * mac
            keep(mc, m_new)
            keep(vc, v_new)
            keep(mac, mac - lr * update)
            pc.copy_(mac)  # the master rounded to the param's type
    keep(old_step, step.to(old_step.dtype))
    metrics = {"grad_norm": gnorm,
               "step_ok": one if ok is None else ok.to(torch.float32)}
    return params, opt_state, metrics
