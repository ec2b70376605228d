"""Production meshes, as ``torch.distributed`` device meshes.

Single pod : (data=16, model=16)           = 256 ranks
Multi-pod  : (pod=2, data=16, model=16)    = 512 ranks

(The reference sizes them for TPU v5e pods; the shapes and dim names are
kept.) Functions, not module-level constants: importing this module
touches no process-group state. Each function builds its mesh over the
process group the caller has already initialised
(``torch.distributed.init_process_group``, with its address, world size
and rank) and raises if there is none: it never starts a world of its own.
The device type is ``"cuda"`` (one card a rank) unless the caller asks for
``"cpu"`` (gloo, or the ``fake`` backend of the tests).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(address, world size, rank) before building a mesh")
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh

    world = _world()
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(data, model) mesh over the current world (tests / smoke runs)."""
    data = _world() // model_parallel
    return _mesh((data, model_parallel), ("data", "model"), device_type)
