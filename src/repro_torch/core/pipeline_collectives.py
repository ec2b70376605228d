"""Blocks-mode collectives: chunked, compute-overlapped rings.

The chip<->chip incarnation of the paper's BLOCKS + DOUBLE-buffer idea.
A monolithic all-gather ('Unique mode') serialises: all communication,
then all compute. Decomposing it into a point-to-point ring of N-1 chunk
steps ('Blocks mode') lets the matmul on chunk k overlap the transfer of
chunk k+1. Same structure for reduce-scatter (the RX direction).

The reference runs these inside ``shard_map`` over a mesh axis, each hop a
``lax.ppermute``. Here every rank calls them with its own shard and a
``group`` (a ``ProcessGroup``, for example ``mesh.get_group("model")``):
the axis index is the rank in the group, and each hop is one
``dist.batch_isend_irecv`` pair, to rank ``(r + 1) % n`` and from rank
``(r - 1) % n`` of the group. Each rank makes n - 1 hops. In the two
``overlapped_*`` functions the hop of one step is issued before the dot
of that step and waited on after it, so the next chunk's transfer runs
while this chunk's matmul does (NCCL's copy kernels beside the GEMM on the
card). The dots are ``torch.matmul`` in ``torch.result_type(x, w)``, as
the reference leaves its dots to XLA outside any kernel.

All functions compute what the unchunked collective computes: the
all-gather bitwise, the sums in the reference's ring order
(``tests/test_torch_collectives.py`` holds them against the reference on
4 ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _ring(group) -> tuple[int, int, int, int]:
    """(n, r, next, prev): the group's size, this rank's index in it, and
    the global ranks of its ring neighbours."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    return (n, r, dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def _hop(send: torch.Tensor, nxt: int, prv: int, group
         ) -> tuple[torch.Tensor, list]:
    """Issue one ring hop: ``send`` to ``nxt``, a tensor of its shape from
    ``prv``. Returns the receive buffer and the requests to wait on."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    return recv, reqs


def _wait(reqs: list) -> None:
    for req in reqs:
        req.wait()


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.result_type(a, b)
    return torch.matmul(a.to(dt), b.to(dt))


def ring_all_gather(x: torch.Tensor, group, *, axis: int = 0) -> torch.Tensor:
    """All-gather via an N-1 step ring (blocks mode).

    Equivalent to ``dist.all_gather_into_tensor`` of the shards
    concatenated along ``axis`` in rank order."""
    n, idx, nxt, prv = _ring(group)
    if n == 1:
        return x
    blocks = [None] * n
    blocks[idx] = x
    block = x
    for j in range(n - 1):
        block, reqs = _hop(block, nxt, prv, group)
        _wait(reqs)
        blocks[(idx - 1 - j) % n] = block  # the shard of rank idx-1-j
    return _merge_leading(torch.stack(blocks), axis)


def ring_reduce_scatter(x: torch.Tensor, group, *,
                        axis: int = 0) -> torch.Tensor:
    """Reduce-scatter (sum) via an N-1 step ring.

    Equivalent to ``dist.reduce_scatter_tensor`` of ``x`` split along
    ``axis``: rank i keeps the sum of every rank's chunk i."""
    n, idx, nxt, prv = _ring(group)
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} ({x.shape[axis]}) not divisible by {n}")
    chunks = _split_dim(x, axis, n)  # [n, ...] leading chunk index

    # Ring reduce-scatter: at step s, rank i sends its running partial for
    # chunk (i - s - 1) mod n to rank i+1 (the partial created at rank i at
    # s=0 is destined for chunk (i-1), i.e. rank i-1, which it reaches after
    # the n-1 hops). Each hop adds the local contribution for the chunk the
    # partial is destined for; after the last hop rank i holds the full sum
    # of chunk i minus its own contribution, added at the end.
    acc = torch.zeros_like(chunks[0])
    for s in range(n - 1):
        acc, reqs = _hop(acc + chunks[(idx - s - 1) % n], nxt, prv, group)
        _wait(reqs)
    return acc + chunks[idx]


def overlapped_matmul_ag(x: torch.Tensor, w: torch.Tensor, group, *,
                         contract_sharded: bool = False) -> torch.Tensor:
    """y = all_gather(x) @ w, with the gather chunked and overlapped.

    x: [m_local, k] shard (gather along rows); w: [k, n] local weights.
    Each ring step matmuls the chunk that just arrived while the next chunk
    is in flight. Unique-mode reference: the all-gather of ``x`` along
    rows, then ``@ w``. (``contract_sharded`` is the reference's, unused
    there too.)"""
    n, idx, nxt, prv = _ring(group)
    if n == 1:
        return _dot(x, w)
    m_local = x.shape[0]
    out = torch.zeros((n * m_local, w.shape[-1]),
                      dtype=torch.result_type(x, w), device=x.device)
    block = x
    for s in range(n):
        src = (idx - s) % n  # rank whose shard we currently hold
        if s < n - 1:
            nblock, reqs = _hop(block, nxt, prv, group)  # comm for step s+1
        out[src * m_local:(src + 1) * m_local] = _dot(block, w)  # overlaps
        if s < n - 1:
            _wait(reqs)
            block = nblock
    return out


def overlapped_matmul_rs(x: torch.Tensor, w: torch.Tensor,
                         group) -> torch.Tensor:
    """y = reduce_scatter(x @ w) with the scatter chunked and overlapped.

    x: [m, k_local]; w: [k_local, n]. Each rank computes its partial product
    in row-chunks; partials ride the ring accumulating, so the hop of chunk
    j overlaps the dot producing chunk j+1. Result: rows m/n per rank,
    summed over the group. Unique-mode reference: the reduce-scatter of
    ``x @ w`` along rows."""
    n, idx, nxt, prv = _ring(group)
    if n == 1:
        return _dot(x, w)
    m = x.shape[0]
    if m % n:
        raise ValueError(f"rows {m} not divisible by axis size {n}")
    mc = m // n

    def chunk_dot(s: int) -> torch.Tensor:
        # the chunk the partial traveling at step s is destined for; step
        # n-1's is this rank's own
        c = (idx - s - 1) % n
        return _dot(x[c * mc:(c + 1) * mc], w)

    # the reference's ring schedule, each partial computed just in time:
    # the dot for step s+1 runs while step s's partial is in flight
    acc = torch.zeros((mc, w.shape[-1]), dtype=torch.result_type(x, w),
                      device=x.device) + chunk_dot(0)
    for s in range(n - 1):
        recv, reqs = _hop(acc, nxt, prv, group)
        part = chunk_dot(s + 1)
        _wait(reqs)
        acc = recv + part
    return acc


def _split_dim(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    shape = tuple(x.shape)
    new = shape[:axis] + (n, shape[axis] // n) + shape[axis + 1:]
    return torch.movedim(x.reshape(new), axis, 0)


def _merge_leading(x: torch.Tensor, axis: int) -> torch.Tensor:
    # x: [n, ...]; concatenate leading dim into `axis` of the remainder.
    x = torch.movedim(x, 0, axis)
    shape = tuple(x.shape)
    return x.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],)
                     + shape[axis + 2:])
