"""Public wrapper: the full SSD, the intra-chunk kernel, the inter-chunk
recurrence (the state-pass kernel) and the off-diagonal term in torch ops,
as the reference leaves it in jnp. Semantics match
``repro_torch.models.layers.ssm.ssd_chunked`` (which rounds at other
points in bf16).

Device rule: a CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel or raises. ``use_kernel=False`` is the only way
to the plain version on the card (the tests and ``chip_smoke.py`` use it to
hold the kernel against it)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import (
    ssd_intra_chunk_call, ssd_state_pass_call)
from repro_torch.kernels.ssd_scan.ref import (
    ssd_intra_chunk_ref, ssd_state_pass_ref)


def ssd_intra_chunk(x, dt, a, b, c, *, chunk: int, use_kernel: bool = True):
    if use_kernel and x.device.type != "cpu":
        return ssd_intra_chunk_call(x, dt, a, b, c, chunk=chunk)
    return ssd_intra_chunk_ref(x, dt, a, b, c, chunk=chunk)


def ssd_state_pass(states, chunk_decay, initial_state=None, *,
                   use_kernel: bool = True):
    """(prev [B,nc,H,P,N], final [B,H,P,N]): the state entering each chunk
    and the last one, f32."""
    if use_kernel and states.device.type != "cpu":
        return ssd_state_pass_call(states, chunk_decay, initial_state)
    return ssd_state_pass_ref(states, chunk_decay, initial_state)


def ssd_full(x, dt, a, b, c, *, chunk: int, use_kernel: bool = True,
             initial_state: torch.Tensor | None = None):
    """x: [B,S,H,P]; dt: [B,S,H]; a: [H]; b, c: [B,S,G,N]; S a multiple of
    ``chunk``. Returns (y [B,S,H,P] in x's type, final state [B,H,P,N]
    f32)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y_diag, states, chunk_decay = ssd_intra_chunk(
        x, dt, a, b, c, chunk=chunk, use_kernel=use_kernel)  # checks S % Q
    nc = s // chunk
    rep = h // g

    # the recurrence across chunks (the reference's lax.scan): prev holds
    # the state entering each chunk
    prev, state = ssd_state_pass(states, chunk_decay, initial_state,
                                 use_kernel=use_kernel)

    # off-diagonal: y_off[q] = C_q . prev_state * exp(da_cs[q]), per group
    # (the heads of a group share C: no repeat over heads)
    dtc = dt.reshape(bs, nc, chunk, h).float()
    da_cs = torch.cumsum(dtc * a.float()[None, None, None, :], dim=2)
    y_off = torch.einsum("bzqgn,bzgrpn->bzqgrp",
                         c.reshape(bs, nc, chunk, g, n).float(),
                         prev.reshape(bs, nc, g, rep, p, n))
    y_off = y_off.reshape(bs, nc, chunk, h, p) * torch.exp(da_cs)[..., None]
    y = y_diag + y_off.reshape(bs, s, h, p)
    return y.to(x.dtype), state
