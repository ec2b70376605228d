"""Per-device roofline quantities of a PyTorch computation, counted op by
op as it dispatches: the port's counterpart of the reference's
``launch/hlo_cost.py``.

:class:`OpCost` is a ``TorchDispatchMode``; run a computation under it and
read :attr:`OpCost.cost` (the reference's :class:`Cost` fields) and
:meth:`OpCost.top_traffic_ops`:

- FLOPs: ``torch.utils.flop_counter``'s formulas (its registry: mm, addmm,
  bmm, baddbmm, convolution, the attention ops), with its decomposition of
  ops it has no formula for, as ``FlopCounterMode`` counts; the reference
  counts dot and convolution ops, and the two agree on the models' forwards
  (``tests/test_torch_dryrun.py``).
- bytes: operand + result bytes of every op (the reference's rule); views,
  which move nothing, count none. PyTorch runs every op unfused, where XLA
  costs a fusion at its call site only, so these bytes exceed the
  reference's.
- collective bytes: :mod:`repro_torch.launch.collective_cost`'s ring
  factors over the functional collectives issued.
- live bytes: each storage an op creates counts from its creation until
  Python frees it, on top of what :meth:`OpCost.track` registered live at
  the start (params, optimizer state, batch, caches); ``peak_bytes`` is the
  most at once, the counterpart of XLA's ``memory_analysis`` (argument +
  temporaries). The caching allocator's rounding and reuse are not
  modelled.

The reference multiplies while-loop bodies by their trip counts, because
XLA costs a loop body once; eager dispatch sees every op of every layer,
so there are no trip counts here. Over ``DTensor``s the mode steps aside
(``NotImplemented``), so every count is of the local shards' ops: a
device's. ``DTensor``'s sharding propagation runs ops under a fake mode of
its own; those are skipped (the rule of
``torch.distributed._tools.mem_tracker``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch._guards import active_fake_mode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.collective_cost import CollectiveCounter


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)


# ops that only ask for metadata; counted as nothing, as FlopCounterMode
# lets them pass
_META = {torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default, torch.ops.prim.layout.default,
         torch.ops.prim.device.default}
_MOVE_NOTHING = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
                 torch.ops.aten.lift_fresh.default,
                 torch.ops._c10d_functional.wait_tensor.default}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# the method that runs an op on global-shape fake tensors for its output
# metadata, by its name in this and in earlier PyTorch releases
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class _Marked:
    """How deep the calls of the functions it wrapped are."""

    def __init__(self) -> None:
        self.depth = 0

    def wrap(self, fn):
        def marked(*args, **kwargs):
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
        return marked


class OpCost(CollectiveCounter):
    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_ops = 0
        self.argument_bytes = 0  # what track() registered
        self._storages: dict[int, tuple] = {}
        self._traffic: dict[tuple[str, str], list] = {}
        self._fake_on_entry = None
        self._depth = 0
        self._propagating = _Marked()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        if not self._depth:  # not the re-entry of a decomposition
            self._fake_on_entry = active_fake_mode()
            # DTensor derives each op's output metadata by running the op
            # on global-shape fake tensors, under the active fake mode
            # where there is one (ours, in a dry run): mark those ops, which
            # are no device's work
            self._prop_name = next(n for n in _PROPAGATORS
                                   if hasattr(ShardingPropagator, n))
            self._prop = getattr(ShardingPropagator, self._prop_name)
            setattr(ShardingPropagator, self._prop_name,
                    self._propagating.wrap(self._prop))
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._depth -= 1
        if not self._depth:
            setattr(ShardingPropagator, self._prop_name, self._prop)
        return super().__exit__(*exc)

    @property
    def cost(self) -> Cost:
        return Cost(self.flops, self.bytes, self.stats.total_bytes,
                    dict(self.stats.bytes_by_kind))

    def track(self, tree) -> int:
        """Register the storages of ``tree``'s tensors (a ``DTensor``'s
        local shard) as live; returns the bytes newly registered."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._live(t.to_local() if hasattr(t, "to_local") else t)
        self.argument_bytes += self.live_bytes - before
        return self.live_bytes - before

    def _live(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":  # a layout, no device memory
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key][0]() is st:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self.live_bytes -= n
            self._storages.pop(key, None)

        self._storages[key] = (weakref.ref(st, freed), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def top_traffic_ops(self, n: int = 20) -> list[dict]:
        """The ops that moved the most bytes (operand + result bytes summed
        over their calls), as the reference's ``top_traffic_ops`` rows."""
        rows = [{"effective_bytes": float(b), "opcode": op, "shape": shape,
                 "count": c} for (op, shape), (b, c) in self._traffic.items()]
        rows.sort(key=lambda r: -r["effective_bytes"])
        return rows[:n]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        if func in _META:
            return func(*args, **kwargs)
        if (func is torch.ops._c10d_functional.wait_tensor.default
                and active_fake_mode() is not None):
            return args[0]  # its fake kernel would make a copy
        if func not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if (self._propagating.depth
                or active_fake_mode() is not self._fake_on_entry):
            return out  # DTensor's sharding propagation, not a device op
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.record(func, args, out)
        outs = _tensors(out)
        if not func.is_view and func not in _MOVE_NOTHING:
            moved = _nbytes(_tensors(args) + _tensors(kwargs) + outs)
            self.bytes += moved
            key = (str(packet), str([tuple(t.shape) for t in outs])[:64])
            row = self._traffic.setdefault(key, [0, 0])
            row[0] += moved
            row[1] += 1
        for t in outs:
            self._live(t)
        return out
