"""Sharding rules: trees -> ``DTensor`` placements on the production meshes.

The reference's rules (``dist/sharding.py``), kept exactly as pure functions
of a leaf's shape and the mesh's {dim name: size} map. They are
deliberately conservative — an axis is only assigned to a tensor dimension
when the dimension is exactly divisible by the mesh extent, otherwise the
leaf (dimension) stays replicated. Replication is always *correct* (just
more memory), so every spec these functions emit is safe on any mesh; the
rules only decide what is profitably partitioned:

- parameters / optimizer state: the model (tensor-parallel) axis on the last
  divisible dimension (output features), falling back to the largest;
- batches: the data-parallel axes (``pod`` x ``data`` when both exist) on the
  leading (batch) dimension;
- KV/SSM caches: data-parallel axes on the slot/batch dimension (dim 1 of
  the layer-stacked layout).

Each function returns the input tree with a :class:`Sharding` in place of
every leaf: the mesh, the ``DTensor`` placements of each mesh dim
(``Shard(d)`` / ``Replicate()``) and ``.spec``, the reference-style tuple
of axis names per tensor dim (None, a name, or a tuple of names such as
``("pod", "data")``). One tensor dim over two mesh dims is ``Shard(d)`` on
both, in the reference's order (the mesh's dim order). ``mesh`` is a
:class:`~torch.distributed.device_mesh.DeviceMesh`, or its {dim name: size}
map for a plan with no mesh built (``Sharding.mesh`` is then None and
:func:`distribute_tree` refuses it). :func:`distribute_tree` places a tree
under such a tree of shardings. A model runs over ``DTensor`` params under
``torch.distributed.tensor.experimental.implicit_replication()``, which
lets the plain tensors it makes (positions, rotary tables) meet them as
replicated; the loss gathers vocab-sharded logits itself
(``models/api.py:cross_entropy``), and every kernel wrapper refuses a
``DTensor`` (``kernels/_build.py:refuse_dtensor``).

The port's decode cache keeps one ``[B]`` length vector for every layer,
where the reference keeps ``[L]`` per-layer lengths (ROADMAP, the
continuous-batching divergence): a 1-d leaf replicates under both rules.
Scalars (an int length) replicate too. Trees are nested dicts, lists,
tuples and NamedTuples (``KVCache``, ``SSMState``), as ``jax.tree`` walks
them.
"""

from __future__ import annotations

import functools
import math
import sys
from dataclasses import dataclass
from typing import Any, Callable, Mapping

Spec = tuple  # per tensor dim: None, a mesh dim name, or a tuple of names


@dataclass(frozen=True)
class Sharding:
    """Where one leaf lives: ``placements`` has one entry a mesh dim."""

    mesh: Any  # DeviceMesh, or None for a plan from a {name: size} map
    placements: tuple
    spec: Spec


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a ``DTensor`` (never, while no code has imported
    ``torch.distributed.tensor``: the check costs no import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _data_axes(sizes: dict[str, int], extent: int) -> tuple[str, ...] | None:
    """Largest data-parallel axis group whose product divides ``extent``."""
    for names in (("pod", "data"), ("data",)):
        if all(n in sizes for n in names):
            total = math.prod(sizes[n] for n in names)
            if extent >= total and extent % total == 0:
                return names
    return None


def _param_spec(shape: tuple[int, ...], sizes: dict[str, int]) -> Spec:
    model = sizes.get("model", 1)
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    if model > 1 and ndim >= 1:
        # prefer the trailing (output-feature) dim, then the largest
        for d in sorted(range(ndim),
                        key=lambda d: (d == ndim - 1, shape[d]),
                        reverse=True):
            if shape[d] >= model and shape[d] % model == 0:
                spec[d] = "model"
                break
    return tuple(spec)


def _lead_spec(shape: tuple[int, ...], sizes: dict[str, int],
               dim: int) -> Spec:
    """The data axes on tensor dim ``dim`` where they divide it."""
    spec: list[Any] = [None] * len(shape)
    if len(shape) > dim:
        axes = _data_axes(sizes, shape[dim])
        if axes is not None:
            spec[dim] = axes if len(axes) > 1 else axes[0]
    return tuple(spec)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _named(mesh, spec: Spec) -> Sharding:
    from torch.distributed.tensor import Replicate, Shard

    placements = []
    for name in _sizes(mesh):
        dims = [d for d, s in enumerate(spec)
                if s == name or (isinstance(s, tuple) and name in s)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return Sharding(None if isinstance(mesh, Mapping) else mesh,
                    tuple(placements), spec)


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``):
    dicts, lists, tuples and NamedTuples keep their structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return None if tree is None else fn(tree, *rest)


def param_sharding(params: Any, mesh) -> Any:
    """Tensor-parallel sharding for a parameter tree."""
    sizes = _sizes(mesh)
    return _map(lambda leaf: _named(mesh, _param_spec(_shape(leaf), sizes)),
                params)


def opt_state_sharding(opt_state: Any, mesh) -> Any:
    """Optimizer state mirrors the parameter rules (moments are
    parameter-shaped; scalars like step counters replicate)."""
    return param_sharding(opt_state, mesh)


def batch_sharding_tree(batch: Any, mesh) -> Any:
    """Data-parallel sharding for an input-batch tree (batch dim 0)."""
    sizes = _sizes(mesh)
    return _map(lambda leaf: _named(mesh, _lead_spec(_shape(leaf), sizes, 0)),
                batch)


def cache_sharding(cache: Any, mesh) -> Any:
    """Decode-cache sharding: slots (batch) on the data axes. Cache leaves
    are layer-stacked ``[L, B, ...]``; the port's ``[B]`` lengths (the
    reference's ``[L]``) and scalar lengths replicate."""
    sizes = _sizes(mesh)

    def spec_for(leaf) -> Sharding:
        shape = _shape(leaf)
        spec = _lead_spec(shape, sizes, 1) if len(shape) >= 2 else (
            (None,) * len(shape))
        return _named(mesh, spec)

    return _map(spec_for, cache)


def zeros_sharded(tree: Any, shardings: Any, device) -> Any:
    """Zero ``DTensor``s with the shapes and dtypes of ``tree``'s tensor
    leaves (``meta`` tensors will do) under ``shardings``, each rank
    allocating only its own shard on ``device`` (even shards, as the
    rules give); non-tensor leaves are kept."""
    import torch
    from torch.distributed.tensor import DTensor

    def place(leaf, sh: Sharding):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape = list(leaf.shape)
        for i, p in enumerate(sh.placements):
            if p.is_shard():
                shape[p.dim] //= sh.mesh.size(i)
        local = torch.zeros(shape, dtype=leaf.dtype, device=device)
        stride = tuple(math.prod(leaf.shape[d + 1:])
                       for d in range(leaf.dim()))
        return DTensor.from_local(local, sh.mesh, list(sh.placements),
                                  shape=leaf.shape, stride=stride)

    return _map(place, tree, shardings)


def shard_placements(mesh, batch: int,
                     dims: Mapping[int, int] | None = None) -> tuple:
    """The placements a batch- and head-parallel computation runs its
    shards on: ``Shard(0)`` on the data axes where they divide ``batch``
    (``_data_axes``), and on "model" ``Shard(d)`` for the first tensor dim
    ``d`` in ``dims`` ({dim: number of heads}) whose head count the axis
    divides, so that a shard holds whole heads; ``Replicate()``
    elsewhere. DTensor cannot run an attention or a scan whose batch and
    head dims it shards on two mesh dims (the products it lowers to merge
    them), so such code computes on the local shards of these placements
    (:func:`local_shard`) and wraps its result back (``DTensor.from_local``)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = _sizes(mesh)
    data = _data_axes(sizes, batch) or ()
    heads = [d for d, n in (dims or {}).items()
             if "model" in sizes and n % sizes["model"] == 0]
    return tuple(Shard(0) if name in data
                 else Shard(heads[0]) if name == "model" and heads
                 else Replicate() for name in sizes)


def batch_sharded(x):
    """``x`` as it is where it is a plain tensor; a ``DTensor`` activation
    ``[B, ...]`` redistributed to its batch on the data axes and replicated
    on every other mesh dim (``shard_placements(mesh, B)``), and its
    gradient brought to the same placements on the way back. Left to
    itself, DTensor's propagation can leave the residual stream, or its
    gradient, sharded on the sequence over "model", and the products that
    follow (which merge batch and sequence) then have no sharding it can
    run; XLA's partitioner reshards such a case by itself."""
    if not is_dtensor(x):
        return x
    return _batch_sharded_fn().apply(x)


@functools.cache
def _batch_sharded_fn():
    import torch

    class BatchSharded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return _to_batch(t)

        @staticmethod
        def backward(ctx, g):
            return _to_batch(g)

    return BatchSharded


def _to_batch(t):
    return t.redistribute(t.device_mesh,
                          shard_placements(t.device_mesh, t.shape[0]))


def layer_at(t, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` tensor: ``t[i]``; for a
    ``DTensor`` not sharded on its layer dim, the slice of its local
    tensor as a ``DTensor`` (a view: writes reach the stack), since
    DTensor's own ``select`` and ``unbind`` gather the whole stack."""
    return layers_of(t)[i] if is_dtensor(t) else t[i]


def layers_of(t) -> tuple:
    """``t.unbind(0)``, with :func:`layer_at`'s rule for a ``DTensor``."""
    from torch.distributed.tensor import DTensor, Shard

    if not is_dtensor(t) or any(p.is_shard(0) for p in t.placements):
        return t.unbind(0)
    mesh = t.device_mesh
    placements = [Shard(p.dim - 1) if p.is_shard() else p
                  for p in t.placements]
    shape = t.shape[1:]
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return tuple(DTensor.from_local(u, mesh, placements, shape=shape,
                                    stride=stride)
                 for u in t.to_local().unbind(0))


def column_halves(w) -> tuple:
    """The two halves of a ``DTensor`` weight's last dim (a gated
    product's ``[gate | up]``), each on ``w``'s own placements. A product
    over the whole ``w`` comes out sharded on the last dim, where a shard
    can hold columns of both halves; DTensor's ``chunk`` then reshards the
    activations (an all-to-all onto the sequence) before products that
    merge batch and sequence can run. Gathering the weight instead moves
    its bytes, not the activations', and keeps each half column-parallel."""
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    whole = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return tuple(h.redistribute(mesh, w.placements)
                 for h in whole.chunk(2, dim=-1))


def local_shard(t, placements) -> tuple:
    """``t`` (a ``DTensor``) redistributed to ``placements`` (even shards):
    this rank's local tensor and its offset into the global tensor, a dim
    at a time (from the mesh coordinate; no tensor op, so it holds under
    ``FakeTensorMode`` too)."""
    mesh = t.device_mesh
    local = t.redistribute(mesh, placements).to_local()
    coord = mesh.get_coordinate()
    offset = []
    for d in range(t.dim()):
        idx = 0
        for i, pl in enumerate(placements):
            if pl.is_shard(d):
                idx = idx * mesh.size(i) + coord[i]
        offset.append(idx * local.shape[d])
    return local, tuple(offset)


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` as a ``DTensor`` under the
    :class:`Sharding` at its place in ``shardings`` (every rank passes the
    whole tensor and keeps its shard, as ``distribute_tensor`` does);
    non-tensor leaves (an int length) are kept as they are."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, sh: Sharding):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if sh.mesh is None:
            raise ValueError("a plan from a {name: size} map has no mesh to "
                             "distribute over")
        return distribute_tensor(leaf, sh.mesh, list(sh.placements))

    return _map(place, tree, shardings)
