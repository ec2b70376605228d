"""Checkpointing: atomic, restartable, optionally async (INTERRUPT-mode).

Format, the reference's: one .npz per checkpoint (tree paths -> arrays)
plus a small JSON manifest; writes go to a temp name and rename atomically
so a crash mid-write never corrupts the latest checkpoint. A key is the
leaf's path, dict keys and list indices joined by ``/``, as the reference
builds it from ``jax.tree_util.tree_flatten_with_path``; bf16 leaves are
widened to f32 (``np.savez`` cannot store bf16) and cast back on restore.
So either package restores the other's checkpoints.

RX (device->host) of the state is itself a policy-driven transfer: the
async mode writes the file on a private completion worker (the
kernel-driver pattern) so training continues during the write — the
paper's 'free the PS for other tasks' argument, applied to checkpointing.
The snapshot to host is complete before ``maybe_save`` returns: the
port's optimizer updates the params and its state in place, so a copy
still in flight when the next step starts would read updated values.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.validated import make_lock
from repro_torch.core.runtime import DedicatedWorkerPool
from repro_torch.core.transfer import Ticket
from repro_torch.utils.pytree import tree_map, tree_paths, tree_unflatten


def _key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _host_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # np.savez cannot persist bf16; store widened, restore casts
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(path): _host_array(leaf) for path, leaf in tree_paths(tree)}


def _unflatten_into(template: Any, flat: dict[str, np.ndarray]) -> Any:
    """``template``'s tree with each tensor leaf read from ``flat``, in the
    leaf's dtype (widened leaves cast back) and on its device."""
    leaves = [torch.from_numpy(np.array(flat[_key(path)])).to(leaf.dtype)
              .reshape(leaf.shape).to(leaf.device)
              for path, leaf in tree_paths(template)]
    return tree_unflatten(template, leaves)


def save_checkpoint(directory: str, step: int, state: Any, *,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(state)
    tmp = os.path.join(directory, f".tmp-step-{step}.npz")
    final = os.path.join(directory, f"step-{step:08d}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, final)  # atomic
    manifest = os.path.join(directory, "manifest.json")
    entries = []
    if os.path.exists(manifest):
        with open(manifest) as f:
            entries = json.load(f)["checkpoints"]
    entries = [e for e in entries if e["step"] != step]
    entries.append({"step": step, "file": os.path.basename(final),
                    "time": time.time()})
    entries.sort(key=lambda e: e["step"])
    # GC old checkpoints
    while len(entries) > keep:
        old = entries.pop(0)
        try:
            os.remove(os.path.join(directory, old["file"]))
        except FileNotFoundError:
            pass
    with open(manifest, "w") as f:
        json.dump({"checkpoints": entries}, f)
    return final


def restore_latest(directory: str, template: Any) -> tuple[int, Any] | None:
    manifest = os.path.join(directory, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        entries = json.load(f)["checkpoints"]
    if not entries:
        return None
    last = entries[-1]
    with np.load(os.path.join(directory, last["file"])) as z:
        flat = {k: z[k] for k in z.files}
    return last["step"], _unflatten_into(template, flat)


def _snapshot(leaf: Any) -> Any:
    """A host copy of ``leaf``, complete on return (never an alias: on the
    CPU the live tensor is updated in place by the next step)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


@dataclass
class CheckpointManager:
    """Periodic checkpoints with sync (POLLING) or async (INTERRUPT) writes."""

    directory: str
    every: int = 100
    keep: int = 3
    async_write: bool = True
    _pending: Ticket | None = None  # guarded-by: _lock
    _lock: threading.Lock = None  # type: ignore[assignment]
    _pool: DedicatedWorkerPool = None  # type: ignore[assignment]

    def __post_init__(self):
        self._lock = make_lock("CheckpointManager._lock")
        # one DEDICATED writer worker per manager: a multi-second write
        # must never occupy a shared TransferRuntime worker (that is
        # the head-of-line blocking the runtime's QoS exists to stop)
        self._pool = DedicatedWorkerPool(workers=1)

    def maybe_save(self, step: int, state: Any) -> bool:
        if step == 0 or step % self.every:
            return False
        if not self.async_write:
            save_checkpoint(self.directory, step, state, keep=self.keep)
            return True
        self.wait()  # never two writers racing (buffer-in-flight rule)
        # snapshot to host NOW, completely (the next step updates the
        # params and the optimizer state in place), write on the
        # completion thread.
        flat_state = tree_map(_snapshot, state)
        done, out = self._pool.submit(
            lambda: save_checkpoint(self.directory, step, flat_state,
                                    keep=self.keep))
        with self._lock:
            self._pending = Ticket(done, out)
        return True

    def wait(self) -> None:
        with self._lock:
            if self._pending is not None:
                # the lock IS the never-two-writers rule: a second saver
                # must queue behind the in-flight write, and only
                # maybe_save/wait ever contend on this lock.
                self._pending.wait()  # lock-ok: serializes writers by design
                self._pending = None

    def restore_latest(self, template: Any):
        return restore_latest(self.directory, template)
