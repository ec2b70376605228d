"""Fault-tolerant training loop with microbatched (blocks-mode) steps.

Microbatching IS the paper's Blocks partitioning applied to the batch
dimension: the global batch is split into ``n_microbatches`` chunks run
one after another, bounding activation memory exactly like chunked DMA
bounds staging-buffer memory. Gradients accumulate in f32.

The step runs eagerly (the reference jits it): the loss's gradients come
from ``torch.autograd.grad`` on detached copies of the params' handles,
so the params themselves never carry ``requires_grad`` and the optimizer
updates them in place afterwards (no donation needed).

Loop-level fault tolerance (see repro_torch.dist.fault):
- restart: Trainer.run resumes from the latest checkpoint if one exists;
- async checkpoints via CheckpointManager (INTERRUPT-mode writes);
- straggler detection on per-step wall time;
- non-finite steps are skipped inside adamw_update (weights untouched).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import default_device
from repro_torch.dist.fault import FaultState
from repro_torch.dist.sharding import global_rows, is_dtensor
from repro_torch.models.api import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    n_microbatches: int = 1
    warmup: int = 10
    log_every: int = 10
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    checkpoint_dir: str = ""
    checkpoint_every: int = 100
    async_checkpoint: bool = True


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads): ``model.loss`` and its gradient in each
    param, a tree like ``params`` (zeros where a param is unused, as
    ``jax.grad`` gives)."""
    handles = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(handles)
    with torch.enable_grad():
        loss, metrics = model.loss(handles, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), _detached(metrics), tree_unflatten(params, grads)


def _split_micro(x: torch.Tensor, n: int) -> list:
    """``x`` [B, ...] as ``n`` microbatches of B / n rows: contiguous row
    blocks, as the reference's reshape makes them. For a ``DTensor`` batch
    microbatch i is the global rows [i B / n, (i + 1) B / n), placed by
    the batch rule for B / n rows (``global_rows``)."""
    rows = x.shape[0] // n
    if is_dtensor(x):
        return [global_rows(x, i * rows, rows) for i in range(n)]
    r = x.reshape((n, rows) + tuple(x.shape[1:]))
    return [r[i] for i in range(n)]


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Build the (params, opt_state, batch) -> (params, opt_state, metrics)
    step; params and opt_state are updated in place and returned."""
    n_micro = tcfg.n_microbatches

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            _, metrics, grads = value_and_grad(model, params, batch)
            # the f32 cast of the gradients happens leaf by leaf inside
            # adamw_update (the reference casts the whole tree here)
        else:
            micro = {k: _split_micro(x, n_micro) for k, x in batch.items()}
            gacc = [torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p)
                    else torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                    for p in tree_leaves(params)]
            dev = gacc[0].device
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            asum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                _, m, g = value_and_grad(
                    model, params, {k: x[i] for k, x in micro.items()})
                for a, b in zip(gacc, tree_leaves(g)):
                    a.add_(b)  # b's type promoted to f32, as b.astype(f32)
                del g
                lsum = lsum + m["loss"]
                asum = asum + m["acc"]
            grads = tree_unflatten(params, [a.div_(n_micro) for a in gacc])
            metrics = {"loss": lsum / n_micro, "acc": asum / n_micro,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=dev)}
        # the schedule reads the step BEFORE the update's increment
        lr_scale = cosine_schedule(opt_state["step"], warmup=tcfg.warmup,
                                   total=tcfg.steps)
        params, opt_state, om = adamw_update(tcfg.opt, grads, opt_state,
                                             params, lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def _block(t: torch.Tensor) -> None:
    """Wait for ``t``'s device, as ``block_until_ready``: on the card the
    whole step (the optimizer's update included) ends at this point."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class Trainer:
    model: Model
    tcfg: TrainConfig
    fault: FaultState = field(default_factory=FaultState)
    history: list[dict] = field(default_factory=list)

    def run(self, data_iter, generator: torch.Generator | None = None,
            initial_state=None, device=None) -> dict:
        """Train for tcfg.steps; restart-safe. Returns final state dict.

        The params come from ``initial_state`` (params, opt_state), else
        ``model.init(generator, device)``: ``device`` is the card unless it
        names another, and ``generator`` defaults to one on that device
        seeded with 0."""
        step_fn = make_train_step(self.model, self.tcfg)

        ckpt = None
        start_step = 0
        if self.tcfg.checkpoint_dir:
            ckpt = CheckpointManager(self.tcfg.checkpoint_dir,
                                     every=self.tcfg.checkpoint_every,
                                     async_write=self.tcfg.async_checkpoint)
        if initial_state is not None:
            params, opt_state = initial_state
        else:
            device = default_device(device)
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            params = self.model.init(generator, device)
            opt_state = adamw_init(params)
            if ckpt is not None:
                restored = ckpt.restore_latest(
                    {"params": params, "opt": opt_state})
                if restored is not None:
                    start_step = restored[0]
                    params = restored[1]["params"]
                    opt_state = restored[1]["opt"]
                    self.fault.restarts += 1

        metrics = {}
        try:
            for step in range(start_step, self.tcfg.steps):
                batch = next(data_iter)
                t0 = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                _block(metrics["loss"])
                dt = time.perf_counter() - t0
                self.fault.record_step(dt, float(metrics["step_ok"]))
                if (step % self.tcfg.log_every == 0
                        or step == self.tcfg.steps - 1):
                    row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = step
                    row["dt_s"] = dt
                    self.history.append(row)
                if ckpt is not None:
                    ckpt.maybe_save(step + 1,
                                    {"params": params, "opt": opt_state})
        finally:
            if ckpt is not None:
                ckpt.wait()
        return {"params": params, "opt_state": opt_state, "metrics": metrics,
                "fault": self.fault}
