"""Elastic re-meshing: plan the device mesh after hosts join or leave.

The reference's ``dist/elastic.py``, copied: it is plain Python over mesh
shapes and byte counts. When a host dies mid-run the fleet shrinks; the
replacement mesh must keep the model-parallel axis intact (tensor-parallel
shards are not re-partitionable without moving parameter bytes) while
giving up data-parallel replicas. :func:`shrink_mesh` computes that plan;
:func:`reshard_plan` says what a transition between two plans actually
costs — the distributed analogue of the paper's question "how many bytes
must move, and who is blocked while they do". A :class:`MeshPlan` is the
shape and the dim names a :class:`torch.distributed.device_mesh.DeviceMesh`
of that plan would take (:mod:`repro_torch.launch.mesh`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshPlan:
    """A named device-mesh shape, e.g. (data, model) or (pod, data, model)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError("shape and axis_names must align")

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def shrink_mesh(n_devices: int, model_parallel: int,
                multi_pod: bool = False) -> MeshPlan:
    """Largest mesh of at most ``n_devices`` that preserves the model axis.

    Single-pod: (data, model). Multi-pod: (pod, data, model) with the pod
    axis the largest power of two dividing the data extent (gradient
    all-reduces stay hierarchical: intra-pod ring, then inter-pod)."""
    if model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    data = n_devices // model_parallel
    if data < 1:
        raise ValueError(
            f"cannot keep model axis of {model_parallel} with only "
            f"{n_devices} devices"
        )
    if not multi_pod:
        return MeshPlan((data, model_parallel), ("data", "model"))
    pods = 1
    while data % (pods * 2) == 0:
        pods *= 2
    return MeshPlan((pods, data // pods, model_parallel),
                    ("pod", "data", "model"))


def reshard_plan(param_millions: float, old: MeshPlan,
                 new: MeshPlan) -> dict:
    """Cost plan for moving a run from ``old`` to ``new``.

    If the model-parallel width changed, every parameter shard must be
    re-partitioned (params move); otherwise only the optimizer state of
    vanished data replicas is re-materialised from the survivors' copy."""
    model_old = old.axis_size("model")
    model_new = new.axis_size("model")
    params_move = model_old != model_new
    grad_replicas = new.n_devices // model_new
    param_bytes = param_millions * 1e6 * 2  # bf16 resting precision
    bytes_to_move = param_bytes if params_move else 0.0
    return {
        "params_move": params_move,
        "grad_replicas": grad_replicas,
        "model_parallel": model_new,
        "devices_lost": max(0, old.n_devices - new.n_devices),
        "bytes_to_move": bytes_to_move,
    }
