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

The port adds two placements the reference leaves to XLA's partitioner
(ROADMAP, the dry-run divergences): :func:`decode_cache_sharding` keeps an
SSM state's heads on "model", where XLA keeps its output state, and
:func:`contract_on_data` splits a product whose rows the batch rule leaves
replicated (B = 1) over the idle data axes, as XLA splits it.

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


def decode_cache_sharding(cache: Any, mesh) -> Any:
    """The port's decode-cache placements: ``cache_sharding``'s, except
    that an SSM state's running state ``[L, B, H, P, N]`` (the ``ssm``
    leaf of an ``SSMState``) also puts its heads (dim 2) on "model" where
    H divides it, as the mixer splits them (``model_split``). The
    reference's rule places only XLA's input, and XLA keeps its output
    state head-sharded; a cache on the rule's placement would have the
    new heads gathered over "model" every layer. The conv tail keeps the
    rule's placement."""
    sizes = _sizes(mesh)

    def place(tree):
        if getattr(tree, "_fields", None) == ("ssm", "conv"):
            ssm = cache_sharding(tree.ssm, mesh)
            spec = list(ssm.spec)
            h = _shape(tree.ssm)[2] if len(spec) == 5 else 0
            if h and "model" in sizes and h % sizes["model"] == 0:
                spec[2] = "model"
                ssm = _named(mesh, tuple(spec))
            return type(tree)(ssm, cache_sharding(tree.conv, mesh))
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v) for v in tree]
        return cache_sharding(tree, mesh)

    return place(cache)


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
    if not is_dtensor(t) or any(p.is_shard(0) for p in t.placements):
        return t[i]
    return _layer(t, t.to_local()[i])


def layers_of(t) -> tuple:
    """``t.unbind(0)``, with :func:`layer_at`'s rule for a ``DTensor``."""
    if not is_dtensor(t) or any(p.is_shard(0) for p in t.placements):
        return t.unbind(0)
    return tuple(_layer(t, u) for u in t.to_local().unbind(0))


def _layer(t, local):
    """``local``, one layer of the stacked ``DTensor`` ``t``'s local
    tensor, as a ``DTensor`` of one layer's shape."""
    from torch.distributed.tensor import DTensor, Shard

    placements = [Shard(p.dim - 1) if p.is_shard() else p
                  for p in t.placements]
    shape = t.shape[1:]
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, t.device_mesh, placements, shape=shape,
                              stride=stride)


def few_rows(x) -> bool:
    """Whether the ``DTensor`` activation ``x`` [..., D] holds fewer rows
    on this rank than it has features, with no gradient taken (a decode
    step): a product over it then moves fewer bytes by gathering its
    output's columns than by gathering its weight's (``column_segments``),
    a weight having D rows. Under grad the weight's segments are taken
    whatever the rows: the backward of a gathered output repeats work
    on every "model" rank. Where the rows are also replicated on the data
    axes (B = 1), :func:`contract_on_data` splits the products over
    them."""
    import torch

    return (not torch.is_grad_enabled()
            and math.prod(x.to_local().shape[:-1]) < x.shape[-1])


def contract_on_data(x, w):
    """``x @ w``; for a ``DTensor`` activation ``x`` [B, ..., K] whose rows
    the batch rule leaves replicated on the data axes (``_data_axes``
    finds none for B, as at B = 1) and a ``DTensor`` weight ``w`` [K, N],
    with no gradient taken, the product split over those idle axes as
    XLA's partitioner splits it: ``x`` to ``Shard(-1)`` and ``w`` to
    ``Shard(0)`` on the data axes whose product divides K (local slices of
    replicated tensors: no bytes move), a product of ``Partial()`` sums
    there, then an all-reduce back to ``Replicate()``. ``w``'s "model"
    placement is kept (``x`` is whole there); a ``w`` already split on K
    takes the plain product. Otherwise every data rank would repeat its
    "model" shard's whole product."""
    import torch

    if (torch.is_grad_enabled() or not (is_dtensor(x) and is_dtensor(w))
            or w.dim() != 2 or any(p.is_shard(0) for p in w.placements)):
        return x @ w
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    sizes = _sizes(mesh)
    names = list(sizes)
    axes = _data_axes(sizes, x.shape[-1]) or ()
    data = [names.index(n) for n in axes if sizes[n] > 1]
    if (not data or _data_axes(sizes, x.shape[0]) is not None
            or not all(x.placements[i].is_replicate() for i in data)):
        return x @ w
    xs = x.redistribute(mesh, [Shard(x.dim() - 1) if i in data
                               else Replicate() for i in range(mesh.ndim)])
    ws = w.redistribute(mesh, [Shard(0) if i in data else p
                               for i, p in enumerate(w.placements)])
    out = xs @ ws
    return out.redistribute(mesh, [Replicate() if i in data else p
                                   for i, p in enumerate(out.placements)])


def column_segments(w, widths: Mapping[str, int]) -> dict:
    """The named column segments of a weight's last dim, ``widths`` wide in
    order (a gated product's ``[gate | up]``, the SSM projection's ``[z |
    x | B | C | dt]``); for a ``DTensor`` each on ``w``'s own placements.
    The rules split the last dim evenly, not on the segments' boundaries,
    so a product over the whole ``w`` comes out with a shard holding
    columns of several segments, and splitting it reshards the
    activations. Gathering the weight instead moves its bytes, not the
    activations', and keeps each segment column-parallel."""
    parts = list(widths.values())
    if not is_dtensor(w):
        return dict(zip(widths, w.split(parts, dim=-1)))
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    whole = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    return {name: seg.redistribute(mesh, w.placements)
            for name, seg in zip(widths, whole.split(parts, dim=-1))}


def column_halves(w) -> tuple:
    """The two halves of a ``DTensor`` weight's last dim (a gated
    product's ``[gate | up]``), each on ``w``'s own placements
    (:func:`column_segments`)."""
    half = w.shape[-1] // 2
    return tuple(column_segments(w, {"gate": half, "up": half}).values())


def model_split(mesh, n: int) -> tuple:
    """How "model" splits ``n`` heads or experts: (its mesh dim or None,
    whether it divides ``n``, this rank's first, its count); where it
    does not divide (or there is no "model"), every rank takes all ``n``."""
    names = list(mesh.mesh_dim_names)
    m = names.index("model") if "model" in names else None
    if m is None or n % mesh.size(m):
        return m, False, 0, n
    count = n // mesh.size(m)
    return m, True, mesh.get_coordinate()[m] * count, count


def local_shard(t, placements) -> tuple:
    """``t`` (a ``DTensor``) redistributed to ``placements`` (even shards):
    this rank's local tensor and its offset into the global tensor, a dim
    at a time (from the mesh coordinate; no tensor op, so it holds under
    ``FakeTensorMode`` too)."""
    r = t.redistribute(t.device_mesh, placements)
    return r.to_local(), tuple(shard_start(r, d) for d in range(t.dim()))


def rows_to_columns(local, mesh, dims: list):
    """All-to-alls that move a split from a tensor's dim 0 to its dim 1:
    ``local`` is this rank's block of rows [b, S, ...] (dim 0 split over
    the mesh dims ``dims``, outer first, every column here); the result is
    every row's block of this rank's columns [b x n, S / n, ...] (dim 1
    split over the same dims in the same order), as ``DTensor``'s
    ``Shard(0)`` -> ``Shard(1)`` leaves it. One all-to-all a mesh dim
    (``mesh.get_group(i)``), each moving 1 / n of the block, where
    DTensor's redistribution on a CPU mesh gathers the whole tensor
    first."""
    import torch.distributed._functional_collectives as funcol

    x = local
    rest = tuple(x.shape[2:])
    for i in dims:
        n = mesh.size(i)
        b, s = x.shape[0], x.shape[1]
        # column block j of every row to rank j along this dim
        x = x.reshape(b, n, s // n, *rest).transpose(0, 1).reshape(
            n * b, s // n, *rest)
        x = funcol.wait_tensor(funcol.all_to_all_single(
            x.contiguous(), None, None, mesh.get_group(i)))
    # the rows arrive with the last dim's sender outermost: put them back
    # in the global order (the first dim's sender outermost)
    k = len(dims)
    sizes = [mesh.size(i) for i in reversed(dims)]
    x = x.reshape(*sizes, -1, *x.shape[1:])
    return x.permute(*reversed(range(k)), *range(k, x.dim())).reshape(
        -1, *x.shape[k + 1:])


def shard_start(t, dim: int) -> int:
    """Where this rank's (even) shard of the ``DTensor`` ``t`` starts on
    tensor dim ``dim`` (from the mesh coordinate and the shapes)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return idx * (t.shape[dim] // n)


def global_rows(x, start: int, count: int):
    """Rows ``[start, start + count)`` of a ``DTensor`` batch ``x`` (dim 0
    on the data axes, whole elsewhere), placed by the batch rule for
    ``count`` rows (:func:`shard_placements`): each rank writes the rows
    it holds into zeros, and the sum over the data axes is scattered (one
    nonzero term a row, so it is exact). A microbatch of the global batch,
    as the reference's reshape splits it."""
    import torch
    from torch.distributed.tensor import DTensor, Partial

    mesh = x.device_mesh
    local, off = x.to_local(), shard_start(x, 0)
    part = torch.zeros((count, *local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    lo, hi = max(start, off), min(start + count, off + local.shape[0])
    if lo < hi:
        part[lo - start:hi - start] = local[lo - off:hi - off]
    return DTensor.from_local(part, mesh, [
        Partial() if pl.is_shard(0) else pl for pl in x.placements]
    ).redistribute(mesh, shard_placements(mesh, count))


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
