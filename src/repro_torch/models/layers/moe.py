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
    """The identity: the port's model runs with no mesh. The reference
    constrains expert-major intermediates to the 'model' axis here (only
    with ``moe_ep_sharding``, which no config sets); expert sharding under
    a ``DeviceMesh`` is ROADMAP Queue 1 item 27."""
    return x


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
    through): standard capacity-based MoE semantics. ``ep_sharding`` is
    accepted for the reference's signature and changes nothing here."""
    b, s, d = x.shape
    e = p["we_up"].shape[0]
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    capacity = max(int(math.ceil(top_k * t / e * capacity_factor)), 1)

    with _span("moe.dispatch"):
        logits = xt.float() @ p["router"]  # [T, E]
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
            buf[slot_k[k]] = xt
        xe = _shard_experts(buf[:-1].reshape(e, capacity, d), None)

    with _span("moe.experts"):  # gated silu, batched over experts
        gate, up = torch.bmm(xe, p["we_up"]).chunk(2, dim=-1)
        ye = torch.bmm(F.silu(gate) * up, p["we_down"])  # [E, C, D]

    with _span("moe.combine"):  # a gather per k-slot, summed k by k
        yflat = ye.reshape(e * capacity, d)
        w = torch.where(keep, gate_vals.T.reshape(-1), 0.0).to(x.dtype)
        w_k = w.reshape(top_k, t)
        out = torch.zeros((t, d), dtype=x.dtype, device=dev)
        for k in range(top_k):
            got = yflat[slot_k[k].clamp_max(e * capacity - 1)]  # [T, D]
            out = out + got * w_k[k][:, None]

    if "ws_up" in p:  # shared experts (always on)
        with _span("moe.shared"):
            gs, us = (xt @ p["ws_up"]).chunk(2, dim=-1)
            out = out + (F.silu(gs) * us) @ p["ws_down"]

    # Switch aux loss: E * sum_e f_e * P_e
    f_e = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, flat_e, keep.float()) / keep.sum().clamp_min(1)
    aux = e * torch.sum(f_e * probs.mean(0))
    return out.reshape(b, s, d), MoEMetrics(aux, dropped)
