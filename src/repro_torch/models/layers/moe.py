"""Mixture-of-experts FFN with capacity-based dispatch (Switch-style).

Supports fine-grained MoE (deepseek: 64 routed top-6 + 2 shared experts,
narrow d_expert) and classic MoE (granite: 32 routed top-8).

Dispatch is capacity-based gather/scatter: tokens are routed to at most
``capacity`` seats per expert; the experts run as one batched product over
stacked weights [E, D, F]. FLOPs are O(top_k * tokens * D * F), the
active-parameter count.

The reference's order of operations is kept exactly: the k-major seat
order (every token's primary expert seated before any secondary one), the
capacity computed from shapes (Python ints, no host sync), the gate
weights cast to the activations' type, and the combine summed k by k into
an accumulator of that type (in bf16 the rounding of that sum is part of
the result). Its translation: ``jax.lax.top_k`` -> ``torch.topk``, the
stable ``argsort`` -> ``torch.argsort(stable=True)``, the
``associative_scan(maximum)`` over group starts -> ``torch.cummax``, the
dispatch ``.at[slot].set`` -> an indexed write (only the dummy last row
takes duplicate writes), ``f_e``'s ``.at[].add`` -> ``scatter_add_``.

While a ``torch.profiler`` records, the layer's phases are ranges named
``moe.dispatch`` (routing, seats, the dispatch writes), ``moe.experts``
(the expert products), ``moe.combine`` (the weighted gathers) and
``moe.shared`` (the shared experts), so a trace splits the layer's device
time between them; with no profiler they cost nothing.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import column_halves, is_dtensor


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor  # load-balance loss (Switch)
    dropped_frac: torch.Tensor  # fraction of (token, slot) pairs over capacity


def _span(name: str):
    """A profiler range while a profiler records; otherwise nothing (the
    decode step runs this layer once a layer)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _shard_experts(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference's sharding constraint: ``x`` (a ``DTensor``)
    redistributed to ``spec``, a mesh dim name (or None) a tensor dim —
    ``("model", None, None)`` for an expert-major intermediate (expert
    parallelism), ``("data", None)`` for a token-major one — every mesh
    dim it does not name replicated. Returned unchanged where ``x`` is a
    plain tensor (no mesh), or where the mesh lacks a named dim or the
    dim's extent does not divide the tensor's, as the reference's
    ``try/except`` returns it (a hint never changes the math)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    named = {name: d for d, name in enumerate(spec) if name is not None}
    if any(name not in sizes or x.shape[d] % sizes[name]
           for name, d in named.items()):
        return x
    return x.redistribute(mesh, [Shard(named[name]) if name in named
                                 else Replicate() for name in sizes])


def moe_params(generator: torch.Generator, d_model: int, n_experts: int,
               d_expert: int, n_shared: int, dtype: torch.dtype,
               device=None) -> dict:
    """The reference's shapes and scales, drawn on the generator's device;
    the router stays f32 in every dtype."""
    g_dev = generator.device
    sd_in = 1.0 / math.sqrt(d_model)
    sd_out = 1.0 / math.sqrt(2.0 * d_expert)

    def draw(shape, scale, dt):
        w = torch.randn(shape, generator=generator, device=g_dev) * scale
        return w.to(device, dt)

    p = {
        "router": draw((d_model, n_experts), sd_in, torch.float32),
        "we_up": draw((n_experts, d_model, 2 * d_expert), sd_in, dtype),
        "we_down": draw((n_experts, d_expert, d_model), sd_out, dtype),
    }
    if n_shared:
        p["ws_up"] = draw((d_model, 2 * n_shared * d_expert), sd_in, dtype)
        p["ws_down"] = draw((n_shared * d_expert, d_model), sd_out, dtype)
    return p


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              ep_sharding: bool = True) -> tuple[torch.Tensor, MoEMetrics]:
    """x: [B, S, D] -> [B, S, D].

    Routing: softmax over experts, top-k, weights renormalised over the k.
    Tokens beyond an expert's capacity are dropped (their residual passes
    through): standard capacity-based MoE semantics. ``ep_sharding``
    constrains the expert-major intermediates to the "model" axis and the
    gathered tokens to "data", at the reference's four sites
    (:func:`_shard_experts`; nothing without a mesh).

    Over a ``DTensor`` ``x`` the routing and the dispatch writes run on the
    gathered tokens and router (every rank holds them whole, as the
    reference's buffer is replicated over "data"; DTensor has no sharded
    stable sort), and the dispatch buffer enters the expert products as a
    replicated ``DTensor``."""
    b, s, d = x.shape
    e = p["we_up"].shape[0]
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    capacity = max(int(math.ceil(top_k * t / e * capacity_factor)), 1)
    mesh = x.device_mesh if is_dtensor(x) else None
    xr, router = xt, p["router"]
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate

        rep = [Replicate()] * mesh.ndim
        xr, router = (v.full_tensor() if is_dtensor(v) else v
                      for v in (xt, router))

    with _span("moe.dispatch"):
        logits = xr.float() @ router  # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)

        # each (token, slot)'s seat in its expert's queue, k-major: a
        # stable sort groups the seats by expert, and a seat's place is its
        # distance from its group's start
        flat_e = gate_idx.T.reshape(-1)  # [K*T], slot-major
        tk = flat_e.shape[0]
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        arange = torch.arange(tk, device=dev)
        is_start = torch.ones(tk, dtype=torch.bool, device=dev)
        is_start[1:] = sorted_e[1:] != sorted_e[:-1]
        group_start = torch.cummax(torch.where(is_start, arange, 0),
                                   dim=0)[0]
        pos = torch.empty_like(arange)
        pos[order] = arange - group_start
        keep = pos < capacity
        dropped = 1.0 - keep.float().mean()

        # dispatch into [E, C, D], one k-slot at a time; a dropped seat
        # writes the dummy last row
        slot = torch.where(keep, flat_e * capacity + pos, e * capacity)
        slot_k = slot.reshape(top_k, t)  # [K, T]
        buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=dev)
        for k in range(top_k):
            buf[slot_k[k]] = xr
        xe = buf[:-1].reshape(e, capacity, d)
        if mesh is not None:
            xe = DTensor.from_local(xe, mesh, rep)
        ep = ("model", None, None)
        if ep_sharding:
            xe = _shard_experts(xe, ep)

    with _span("moe.experts"):  # gated silu, batched over experts
        if mesh is not None and not ep_sharding:
            gate, up = (torch.bmm(xe, w)
                        for w in column_halves(p["we_up"]))
        else:
            h = torch.bmm(xe, p["we_up"])
            if ep_sharding:
                h = _shard_experts(h, ep)
            gate, up = h.chunk(2, dim=-1)
        ye = torch.bmm(F.silu(gate) * up, p["we_down"])  # [E, C, D]
        if ep_sharding:
            ye = _shard_experts(ye, ep)

    with _span("moe.combine"):  # a gather per k-slot, summed k by k
        yflat = ye.reshape(e * capacity, d)
        if mesh is not None:
            # the gathers on the whole expert outputs, every rank's tokens
            # replicated (DTensor's gather from rows sharded over "model"
            # leaves a masked partial that its later reductions mishandle)
            yfull = yflat.full_tensor()
        w = torch.where(keep, gate_vals.T.reshape(-1), 0.0).to(x.dtype)
        w_k = w.reshape(top_k, t)
        if mesh is not None:  # the gates' gradient comes back whole
            w_k = DTensor.from_local(w_k, mesh, rep)
        out = torch.zeros((t, d), dtype=x.dtype, device=dev)
        for k in range(top_k):
            idx = slot_k[k].clamp_max(e * capacity - 1)
            got = (yflat[idx] if mesh is None  # [T, D]
                   else DTensor.from_local(yfull[idx], mesh, rep))
            if ep_sharding:  # token-major again
                got = _shard_experts(got, ("data", None))
            out = out + got * w_k[k][:, None]

    if "ws_up" in p:  # shared experts (always on)
        with _span("moe.shared"):
            if is_dtensor(p["ws_up"]):
                gs, us = (xt @ w for w in column_halves(p["ws_up"]))
            else:
                gs, us = (xt @ p["ws_up"]).chunk(2, dim=-1)
            out = out + (F.silu(gs) * us) @ p["ws_down"]

    # Switch aux loss: E * sum_e f_e * P_e
    f_e = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, flat_e, keep.float()) / keep.sum().clamp_min(1)
    aux = e * torch.sum(f_e * probs.mean(0))
    if mesh is not None:  # computed whole on every rank: replicated
        aux = DTensor.from_local(aux, mesh, rep)
    return out.reshape(b, s, d), MoEMetrics(aux, dropped)
