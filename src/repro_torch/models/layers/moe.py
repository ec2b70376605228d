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
time between them (spans of :mod:`repro_torch.utils.trace`), and the
counters ``moe.rows`` / ``moe.seats`` tally the expert products' rows
against the seats they serve; with no profiler they cost a flag read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import column_halves, is_dtensor
from repro_torch.utils import trace


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor  # load-balance loss (Switch)
    dropped_frac: torch.Tensor  # fraction of (token, slot) pairs over capacity


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
              ep_sharding: bool = True,
              renormalize: bool = True,
              ragged_tokens: int = 0) -> tuple[torch.Tensor, MoEMetrics]:
    """x: [B, S, D] -> [B, S, D].

    Routing: softmax over experts, top-k, weights renormalised over the k
    (``renormalize``; off, the k softmax weights as they are, DeepSeek-V2's
    ``norm_topk_prob`` false).
    Tokens beyond an expert's capacity are dropped (their residual passes
    through): standard capacity-based MoE semantics. ``ep_sharding``
    constrains the expert-major intermediates to the "model" axis and the
    gathered tokens to "data", at the reference's four sites
    (:func:`_shard_experts`; nothing without a mesh). A ``DTensor`` ``x``
    takes :func:`_sharded_moe`, expert parallelism with the same seats.

    ``ragged_tokens`` (0: never): on a bf16 prefill (S > 1) of at least
    this many tokens, where the capacity seats every token (no seat can
    drop), grad mode is off and no CUDA graph is being captured, the
    experts run over their own seats alone (:func:`_ragged_experts`,
    grouped products) instead of over the padded [E, C, D] buffer, which
    at capacity T holds E / top_k times the seated rows. The seats, the
    gate weights and the k-by-k combine are the same, and nothing on that
    route waits on the host. A one-token step (S = 1, a decode step) keeps
    the padded buffer, eager or captured, so the eager step before a
    capture runs the kernels the capture records.

    Each call counts ``moe.rows``, the rows the expert products compute
    (E * C padded, top_k * T grouped), and ``moe.seats``, top_k * T."""
    b, s, d = x.shape
    e = p["we_up"].shape[0]
    t = b * s
    capacity = max(int(math.ceil(top_k * t / e * capacity_factor)), 1)
    ragged = (not is_dtensor(x) and s > 1 and 0 < ragged_tokens <= t
              and capacity >= t and x.dtype == torch.bfloat16
              and not torch.is_grad_enabled()
              and not (x.is_cuda and torch.cuda.is_current_stream_capturing()))
    trace.count("moe.rows", top_k * t if ragged else e * capacity)
    trace.count("moe.seats", top_k * t)
    if is_dtensor(x):
        return _sharded_moe(p, x, top_k=top_k, capacity=capacity,
                            ep_sharding=ep_sharding, renormalize=renormalize)
    xt = x.reshape(t, d)
    if ragged:
        out, metrics = _ragged_moe(p, xt, top_k, renormalize)
        return out.reshape(b, s, d), metrics

    with trace.span("moe.dispatch"):
        probs, gate_vals, gate_idx = _gates(xt, p["router"], top_k,
                                            renormalize)
        seats = _seats(gate_idx, e, capacity)
        slot_k = seats.slot.reshape(top_k, t)  # [K, T]
        # dispatch into [E, C, D], one k-slot at a time; a dropped seat
        # writes the dummy last row
        buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype,
                          device=x.device)
        for k in range(top_k):
            buf[slot_k[k]] = xt
        xe = buf[:-1].reshape(e, capacity, d)
        ep = ("model", None, None)
        if ep_sharding:
            xe = _shard_experts(xe, ep)

    with trace.span("moe.experts"):  # gated silu, batched over experts
        h = torch.bmm(xe, p["we_up"])
        if ep_sharding:
            h = _shard_experts(h, ep)
        gate, up = h.chunk(2, dim=-1)
        ye = torch.bmm(F.silu(gate) * up, p["we_down"])  # [E, C, D]
        if ep_sharding:
            ye = _shard_experts(ye, ep)

    with trace.span("moe.combine"):  # a gather per k-slot, summed k by k
        yflat = ye.reshape(e * capacity, d)
        w_k = _gate_weights(seats, gate_vals, x.dtype).reshape(top_k, t)
        out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        for k in range(top_k):
            got = yflat[slot_k[k].clamp_max(e * capacity - 1)]  # [T, D]
            if ep_sharding:  # token-major again
                got = _shard_experts(got, ("data", None))
            out = out + got * w_k[k][:, None]

    out = _shared_experts(p, xt, out)
    # Switch aux loss: E * sum_e f_e * P_e
    aux = e * torch.sum(seats.f_e * probs.mean(0))
    return out.reshape(b, s, d), MoEMetrics(aux, seats.dropped)


def _ragged_moe(p: dict, xt: torch.Tensor, top_k: int,
                renormalize: bool) -> tuple[torch.Tensor, MoEMetrics]:
    """:func:`moe_apply` on tokens xt [T, D] where every seat is kept: the
    same gates, seats and k-by-k combine, the experts over their own seats
    (:func:`_ragged_experts`)."""
    t, d = xt.shape
    e = p["we_up"].shape[0]
    with trace.span("moe.dispatch"):
        probs, gate_vals, gate_idx = _gates(xt, p["router"], top_k,
                                            renormalize)
        flat_e = gate_idx.T.reshape(-1)  # [K*T], slot-major, as _seats'
        # every seat kept: _seats' f_e and dropped, without the queue places
        counts = _seat_counts(flat_e, e)
        f_e = counts.float() / float(top_k * t)
    with trace.span("moe.experts"):
        ys = _ragged_experts(p, xt, flat_e, counts)  # [K*T, D]
    with trace.span("moe.combine"):
        w_k = gate_vals.T.to(xt.dtype)  # [K, T]
        out = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
        for k in range(top_k):
            out = out + ys[k * t:(k + 1) * t] * w_k[k][:, None]
    out = _shared_experts(p, xt, out)
    aux = e * torch.sum(f_e * probs.mean(0))
    return out, MoEMetrics(aux, torch.zeros((), device=xt.device))


def _seat_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[E] int64: each expert's seats among ``flat_e``, summed on the
    device (CUDA's ``torch.bincount`` reads its input's range on the host
    to size its output, a sync)."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def _ragged_experts(p: dict, xt: torch.Tensor, flat_e: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Every seat's expert output [K*T, D], seat-major (``k * T + t``), with
    each expert run over its own seats only (``counts`` [E]: its seats):
    the seats sorted by expert (stably), each projection one grouped
    product over the experts' row groups (``torch._grouped_mm``, bf16; the
    groups' ends stay on the device), then put back in seat order."""
    t = xt.shape[0]
    order = torch.argsort(flat_e, stable=True)
    ends = counts.cumsum(0).to(torch.int32)  # each expert's seats' end
    xs = xt[order % t]  # seat k * T + t holds token t
    h = torch._grouped_mm(xs, p["we_up"], offs=ends)
    gate, up = h.chunk(2, dim=-1)
    y = torch._grouped_mm(F.silu(gate) * up, p["we_down"], offs=ends)
    ys = torch.empty_like(y)
    ys[order] = y
    return ys


class Seats(NamedTuple):
    """Every (k-slot, token) pair's seat, k-major (index ``k * T + t``)."""

    flat_e: torch.Tensor  # [K*T] its expert
    pos: torch.Tensor  # [K*T] its place in that expert's queue
    keep: torch.Tensor  # [K*T] pos < capacity
    slot: torch.Tensor  # [K*T] e * C + pos; E * C where dropped
    f_e: torch.Tensor  # [E] each expert's share of the kept seats
    dropped: torch.Tensor  # the dropped share of all seats


def _gates(xt: torch.Tensor, router: torch.Tensor, top_k: int,
           renormalize: bool = True):
    """(probs [T, E], gate weights [T, K] (renormalised over the k where
    ``renormalize``), gate experts [T, K])."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    if renormalize:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    return probs, gate_vals, gate_idx


def _seats(gate_idx: torch.Tensor, n_experts: int, capacity: int,
           shift: torch.Tensor | None = None, psum=None,
           blocks: int = 1) -> Seats:
    """Each (k-slot, token)'s seat in its expert's queue, k-major: a
    stable sort groups the seats by expert, and a seat's place is its
    distance from its group's start.

    For a block of the global tokens (one data rank's), ``shift`` [K, E]
    moves each (k, expert) group of the block to its global place, and
    ``psum`` sums a small tensor over the ``blocks`` blocks, so that the
    seats, ``f_e`` and ``dropped`` are the whole tokens' exactly."""
    top_k = gate_idx.shape[1]
    flat_e = gate_idx.T.reshape(-1)  # [K*T], slot-major
    tk = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    arange = torch.arange(tk, device=dev)
    is_start = torch.ones(tk, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, arange, 0), dim=0)[0]
    pos = torch.empty_like(arange)
    pos[order] = arange - group_start
    if shift is not None:
        k_of = torch.div(arange, tk // top_k, rounding_mode="floor")
        pos = pos + shift.reshape(-1)[k_of * n_experts + flat_e]
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, n_experts * capacity)
    kept = torch.zeros(n_experts, dtype=torch.float32,
                       device=dev).scatter_add_(0, flat_e, keep.float())
    if psum is None:
        f_e = kept / keep.sum().clamp_min(1)
        dropped = 1.0 - keep.float().mean()
    else:  # whole counts: integers, exact in f32
        kept = psum(kept)
        n_kept = kept.sum()
        f_e = kept / n_kept.clamp_min(1)
        dropped = 1.0 - n_kept / float(tk * blocks)
    return Seats(flat_e, pos, keep, slot, f_e, dropped)


def _gate_weights(seats: Seats, gate_vals: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """[K*T] each seat's combine weight in the activations' type; 0 where
    dropped."""
    return torch.where(seats.keep, gate_vals.T.reshape(-1), 0.0).to(dtype)


def _shared_experts(p: dict, xt: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """``out`` plus the shared experts' output (always on), if any."""
    if "ws_up" not in p:
        return out
    with trace.span("moe.shared"):
        if is_dtensor(p["ws_up"]):
            gs, us = (xt @ w for w in column_halves(p["ws_up"]))
        else:
            gs, us = (xt @ p["ws_up"]).chunk(2, dim=-1)
        return out + (F.silu(gs) * us) @ p["ws_down"]


def _sharded_moe(p: dict, x, *, top_k: int, capacity: int,
                 ep_sharding: bool, renormalize: bool = True):
    """:func:`moe_apply` over a ``DTensor`` ``x``: expert parallelism.

    The tokens stay where the batch rule put them (rows on the data axes,
    replicated over "model"); no rank gathers them, the router output or
    the expert output. Each data rank routes its own tokens, a contiguous
    block of the global ``t = b * S + s``, and seats them where the whole
    tokens' stable k-major sort would: a seat's place is the counts of
    earlier k-slots on every rank, plus those of its k-slot on earlier
    ranks, plus its place in its own (k, rank, expert) group (one
    all-gather of the [K, E] counts). Each device writes its tokens' seats
    into a buffer that the data ranks sum (each seat is written once, so
    the sum is exact), and the experts run where one of two layouts puts
    them, whichever moves fewer bytes:

    - many seats (prefill, training): the expert weights are resharded to
      whole experts on "model"; a device writes the seats of the experts
      it owns into its [E/M, C, D] buffer, and the sum is scattered over
      the data axes on the capacity, so every device runs E/M experts on
      C/R of their seats (``ep_sharding`` gathers the capacity over
      "data", as the reference's constraint does). The combine gathers the
      capacity back, picks each token's rows from the experts a device
      owns (zeros elsewhere) and sums them over "model";
    - few seats (decode: C < 3 F): the weights stay where the rule put
      them (their last dim on "model"); the sum is scattered over the data
      axes on the experts, every device runs E/R experts on the columns it
      holds, and the combine gathers the expert outputs whole.

    Either way the k-slots accumulate one at a time in the reference's
    order, so ``out`` keeps its rounding."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.dist.sharding import model_split, shard_placements

    b, s, d = x.shape
    wu, wd = p["we_up"], p["we_down"]
    e, f = wd.shape[0], wd.shape[1]
    t = b * s
    mesh = x.device_mesh
    nd = mesh.ndim
    tok = shard_placements(mesh, b)  # rows on the data axes
    data = [i for i, pl in enumerate(tok) if pl.is_shard()]
    m, split, e0, e_l = model_split(mesh, e)
    coord = mesh.get_coordinate()
    rank = 0  # this data rank's block of the global tokens
    for i in data:
        rank = rank * mesh.size(i) + coord[i]
    blocks = math.prod(mesh.size(i) for i in data)

    def pl(on_data, on_model) -> list:
        return [on_data if i in data else on_model if i == m and split
                else Replicate() for i in range(nd)]

    def dp(on_data) -> list:  # on the data axes, replicated elsewhere
        return [on_data if i in data else Replicate() for i in range(nd)]

    def psum(v: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(v, mesh, dp(Partial())).full_tensor()

    wu, wd = (w if is_dtensor(w) else DTensor.from_local(
        w, mesh, [Replicate()] * nd) for w in (wu, wd))
    in_place = (not ep_sharding and e % blocks == 0 and capacity < 3 * f
                and all(q.is_replicate() or (i == m and q.is_shard(2))
                        for w in (wu, wd) for i, q in enumerate(w.placements)))
    # the buffer's capacity padded to split evenly over the data ranks
    # (the padded rows are never written nor read)
    cap = capacity if in_place else -(-capacity // blocks) * blocks

    x = x.redistribute(mesh, tok)
    xt = x.reshape(t, d)
    xl = xt.to_local()  # routing: every "model" rank alike
    t_l = xl.shape[0]
    ep = ("model", None, None)

    with trace.span("moe.dispatch"):
        router = p["router"]
        if is_dtensor(router):  # a rank's gradient: its own tokens'
            router = router.full_tensor(grad_placements=dp(Partial()))
        probs, gate_vals, gate_idx = _gates(xl, router, top_k, renormalize)
        kslot = torch.arange(top_k, device=xl.device)[:, None]
        counts = torch.zeros(top_k * e, dtype=torch.int64,
                             device=xl.device).index_add_(
            0, (kslot * e + gate_idx.T).reshape(-1),
            torch.ones(top_k * t_l, dtype=torch.int64,
                       device=xl.device)).reshape(top_k, e)
        every = DTensor.from_local(counts[None], mesh, dp(Shard(0))
                                   ).full_tensor()  # [R, K, E]
        total = every.sum(0)
        shift = (total.cumsum(0) - total + every[:rank].sum(0)
                 - (counts.cumsum(0) - counts))
        seats = _seats(gate_idx, e, capacity, shift, psum, blocks)
        if in_place:  # every seat, into the whole [E, C, D] buffer
            owned = seats.keep
            lslot = seats.slot.reshape(top_k, t_l)
            xd, n_e, on_model, to = xl, e, Replicate(), Shard(0)
        else:  # the seats of this "model" rank's experts
            owned = seats.keep & (seats.flat_e >= e0) & (
                seats.flat_e < e0 + e_l)
            lslot = torch.where(owned, (seats.flat_e - e0) * cap + seats.pos,
                                e_l * cap).reshape(top_k, t_l)
            # a "model" rank's dispatch gradient holds its experts' seats
            xd = xt.to_local(grad_placements=pl(Shard(0), Partial()))
            n_e, on_model, to = e_l, Shard(0), Shard(1)
        buf = torch.zeros((n_e * cap + 1, d), dtype=x.dtype,
                          device=xl.device)
        for k in range(top_k):
            buf[lslot[k]] = xd
        xe = DTensor.from_local(buf[:-1].reshape(n_e, cap, d), mesh,
                                pl(Partial(), on_model)).redistribute(
            mesh, pl(to, on_model))
        if ep_sharding:
            xe = _shard_experts(xe, ep)

    with trace.span("moe.experts"):
        if in_place:  # this data rank's experts, the columns it holds
            e_r = e // blocks

            def mine(w):  # a data rank's gradient: its own experts'
                return w.to_local(grad_placements=[
                    Partial() if i in data else q
                    for i, q in enumerate(w.placements)])[
                    rank * e_r:(rank + 1) * e_r]

            def part(w):  # the gradient of what each column shard reads
                return [Shard(0) if i in data else Partial()
                        if w.placements[i].is_shard() else Replicate()
                        for i in range(nd)]

            h = DTensor.from_local(
                torch.bmm(xe.to_local(grad_placements=part(wu)), mine(wu)),
                mesh, [Shard(0) if i in data else q
                       for i, q in enumerate(wu.placements)])
            # gate and up columns side by side on every "model" rank
            gate, up = h.redistribute(mesh, dp(Shard(0))).to_local(
                grad_placements=part(wd)).chunk(2, dim=-1)
            ye = DTensor.from_local(
                torch.bmm(F.silu(gate) * up, mine(wd)), mesh,
                [Shard(0) if i in data else q
                 for i, q in enumerate(wd.placements)])
        else:  # this device's experts and seats, whole experts
            w_pl = pl(Replicate(), Shard(0))
            # a device's weight gradient: its own seats' (a partial sum
            # over the dims that split the capacity)
            w_grad = [Partial() if q.is_shard(1) else w_pl[i]
                      for i, q in enumerate(xe.placements)]

            def whole(w):
                return w.redistribute(mesh, w_pl).to_local(
                    grad_placements=w_grad)

            h = DTensor.from_local(torch.bmm(xe.to_local(), whole(wu)),
                                   mesh, xe.placements)
            if ep_sharding:
                h = _shard_experts(h, ep)
            gate, up = h.to_local().chunk(2, dim=-1)
            ye = DTensor.from_local(torch.bmm(F.silu(gate) * up, whole(wd)),
                                    mesh, h.placements)
            if ep_sharding:
                ye = _shard_experts(ye, ep)

    with trace.span("moe.combine"):
        # the expert outputs gathered (whole, or this "model" rank's
        # experts); a data rank's gradient: its own tokens' rows
        keep_on = Replicate() if in_place else Shard(0)
        yflat = ye.redistribute(mesh, pl(Replicate(), keep_on)).to_local(
            grad_placements=pl(Partial(), keep_on)).reshape(n_e * cap, d)
        w_k = _gate_weights(seats, gate_vals, x.dtype).reshape(top_k, t_l)
        out = DTensor.from_local(torch.zeros((t_l, d), dtype=x.dtype,
                                             device=xl.device), mesh, tok)
        for k in range(top_k):
            rows = yflat[lslot[k].clamp_max(n_e * cap - 1)]
            if in_place:
                got = DTensor.from_local(rows, mesh, tok)
            else:  # zeros where another "model" rank owns the expert
                got = DTensor.from_local(torch.where(
                    owned.reshape(top_k, t_l)[k][:, None], rows, 0), mesh,
                    pl(Shard(0), Partial())).redistribute(mesh, tok)
            if ep_sharding:  # token-major again
                got = _shard_experts(got, ("data", None))
            out = out + got * DTensor.from_local(w_k[k][:, None], mesh, tok)

    out = _shared_experts(p, xt, out)
    p_e = psum(probs.sum(0)) / t
    aux = DTensor.from_local(e * torch.sum(seats.f_e * p_e), mesh,
                             [Replicate()] * nd)
    return out.reshape(b, s, d), MoEMetrics(aux, seats.dropped)
