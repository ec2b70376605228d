"""Small tree utilities over the port's params and optimizer state: nested
dicts and lists of tensors, the reference's pytrees.

Leaves are visited as ``jax.tree_util`` visits them: a dict's keys in
sorted order, a list's items in order, None an empty subtree. Reductions
over a leaf (``global_norm``, ``tree_finite``) walk it in flat chunks of
at most ``CHUNK`` elements, so a stacked [L, ...] leaf of a full-width
model never needs an f32 temporary of its whole size."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

CHUNK = 1 << 26  # elements of one reduction chunk (256 MiB in f32)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists (the hybrid's
    ``groups`` is a list of stacked dicts); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def tree_paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) in the reference's order; a path holds dict keys and
    list indices, as ``jax.tree_util.tree_flatten_with_path`` gives them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` (in ``tree_leaves`` order)
    in place of its own."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return None if t is None else next(it)

    return build(template)


def unstack(blocks: Any) -> list:
    """The per-layer trees of a stacked [L, ...] tree: views from one
    ``unbind`` a leaf. Under autograd the unbind's backward stacks the
    layers' gradients once, where indexing ``t[i]`` a layer would add a
    zero-filled gradient of the whole stack a layer (O(L^2) bytes: 36
    fills and adds of qwen2.5-3b's 3.2 GB MLP stack a step). A ``DTensor``
    leaf is split on its local tensor (``dist.sharding.layers_of``)."""
    from repro_torch.dist.sharding import layers_of

    per_leaf = tree_map(layers_of, blocks)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda u: u[i], per_leaf) for i in range(n)]


def chunks(t: torch.Tensor) -> list[torch.Tensor]:
    """Flat views of ``t`` of at most ``CHUNK`` elements (a copy only if
    ``t`` is not contiguous); a ``DTensor`` whole (DTensor cannot flatten
    a sharded dim)."""
    from repro_torch.dist.sharding import is_dtensor

    if is_dtensor(t):
        return [t]
    return list(t.reshape(-1).split(CHUNK))


def _floating(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor leaves."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def tree_params(tree: Any) -> int:
    """Total element count of all tensor leaves."""
    return sum(t.numel() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda t: t.to(dtype) if _floating(t) else t, tree)


def tree_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: every floating leaf is finite. Never synchronises
    with the host (the NaN-guarded update reads it on the device)."""
    flags = [torch.isfinite(c).all() for t in tree_leaves(tree)
             if _floating(t) for c in chunks(t)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    total = None
    for t in tree_leaves(tree):
        for c in chunks(t):
            cf = c.float()
            sq = torch.dot(cf, cf) if cf.dim() == 1 else cf.square().sum()
            total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)
