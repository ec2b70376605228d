"""Collective traffic a device moves, read from the collectives PyTorch
issues: the port's counterpart of the reference's
``launch/hlo_analysis.py``.

The reference parses post-partitioning HLO text (``collective_bytes``) and
takes each collective's group size from its ``replica_groups``
(``_group_size``). Here :class:`CollectiveCounter`, a
``TorchDispatchMode``, sees each ``_c10d_functional`` op as it dispatches
(the ops ``DTensor``'s redistributions and ``torch.distributed``'s
functional collectives lower to), reads its result's bytes and takes the
group size from the op's arguments or, where it has none, from its group
name. The effective bytes a device moves are the reference's ring factors,
kept exactly (:func:`effective_bytes`; ``size`` is the result's bytes, as
an HLO op's type is its result's):

  all-gather        : size * (g-1)/g        (size = the gathered result)
  reduce-scatter    : size * (g-1)/g * g    (size = the scattered result)
  all-reduce        : 2 * size * (g-1)/g    (reduce-scatter + all-gather)
  all-to-all        : size * (g-1)/g
  collective-permute: size                  (here: isend / irecv /
                                             batch_p2p_ops)

The port adds ``broadcast`` (``size``), which the reference's partitioned
modules never hold. The reference's ``duplicate_fusion_count`` (repeated
fusion names, a remat hint) has no counterpart: eager PyTorch runs no
fusions (ROADMAP, the dry-run divergences).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


def effective_bytes(kind: str, size: float, g: int) -> float:
    """Bytes one device moves for a collective of ``kind`` whose result
    holds ``size`` bytes, over a group of ``g`` (the reference's factors)."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return size * frac
    if kind == "all-reduce":
        return 2 * size * frac
    if kind == "reduce-scatter":
        return size * frac * g
    if kind == "all-to-all":
        return size * frac
    if kind in ("collective-permute", "broadcast"):
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def add(self, kind: str, eff: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + eff
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def row(self) -> dict:
        return {"collective_bytes": self.total_bytes,
                "by_kind": {k: float(v) for k, v in self.bytes_by_kind.items()},
                "counts": dict(self.count_by_kind)}


def _nbytes(out) -> int:
    ts = out if isinstance(out, (list, tuple)) else [out]
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


# op name -> (kind, index of its group size or None, index of its group)
_OPS = {
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 1, 2),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", 1, 2),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): (
        "all-gather", 1, 2),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 2, 3),
    ("_c10d_functional", "reduce_scatter_tensor_out"): (
        "reduce-scatter", 2, 3),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): (
        "reduce-scatter", 2, 3),
    ("_c10d_functional", "all_reduce"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_reduce_coalesced_"): ("all-reduce", None, 2),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", None, 3),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", None, 3),
    ("_c10d_functional", "broadcast"): ("broadcast", None, 2),
    ("_c10d_functional", "broadcast_"): ("broadcast", None, 2),
    ("_c10d_functional", "isend"): ("collective-permute", None, 3),
    ("_c10d_functional", "irecv"): ("collective-permute", None, 3),
    ("_c10d_functional", "batch_p2p_ops"): ("collective-permute", None, 4),
}


def collective_of(func, args: tuple):
    """(kind, group size, group name) of a functional collective op; None
    for any other op (``wait_tensor`` included: a collective counts once,
    where it is issued)."""
    hit = _OPS.get((func.namespace, func._opname))
    if hit is None:
        return None
    kind, size_at, group_at = hit
    group = args[group_at]
    if size_at is not None:
        return kind, int(args[size_at]), group
    from torch.distributed.distributed_c10d import _resolve_process_group

    return kind, _resolve_process_group(group).size(), group


class CollectiveCounter(TorchDispatchMode):
    """Counts the effective bytes of every functional collective issued
    while it is active (``.stats``). Over ``DTensor``s it steps aside
    (``NotImplemented``), so ``DTensor`` lowers its redistributions into
    functional collectives on local shards first and the counts are a
    device's, as ``CommDebugMode`` does."""

    def __init__(self) -> None:
        super().__init__()
        self.stats = CollectiveStats()
        self.bytes_by_group: dict[str, float] = {}  # process-group name

    def record(self, func, args: tuple, out) -> None:
        """Count ``func`` if it is a collective."""
        hit = collective_of(func, args)
        if hit is None:
            return
        kind, g, group = hit
        eff = effective_bytes(kind, _nbytes(out), g)
        self.stats.add(kind, eff)
        self.bytes_by_group[group] = self.bytes_by_group.get(group, 0.0) + eff

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.record(func, args, out)
        return out
