"""Public wrapper: the full SSD, the intra-chunk kernel, the inter-chunk
recurrence (the state-pass kernel) and the off-diagonal term in torch ops,
as the reference leaves it in jnp. Semantics match
``repro_torch.models.layers.ssm.ssd_chunked`` (which rounds at other
points in bf16).

Device rule: a CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel or raises. ``use_kernel=False`` is the only way
to the plain version on the card (the tests and ``chip_smoke.py`` use it to
hold the kernel against it); :func:`plain_ssd` passes it to every
``ssd_full`` call made within it, for a model that calls ``ssd_full``
itself (the dry run's "plain SSD" route on the card,
``launch/dryrun.py:on_device``).

Gradients: the kernels write into fresh buffers, which carry no
``grad_fn``. Where autograd needs a gradient, ``ssd_full`` runs as
``_SSDFull``, an ``autograd.Function`` whose forward launches the kernels
and whose backward recomputes the plain version (the same rounding points)
from the saved inputs and returns its vector-Jacobian product. The
reference has no backward kernel either: it trains through XLA's autodiff
of plain code. ``use_kernel=False`` is plain code, which autograd
differentiates as it is."""

from __future__ import annotations

import contextlib
import threading

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


_PLAIN = threading.local()


@contextlib.contextmanager
def plain_ssd():
    """``use_kernel=False`` for every :func:`ssd_full` call made within, in
    this thread."""
    before = getattr(_PLAIN, "on", False)
    _PLAIN.on = True
    try:
        yield
    finally:
        _PLAIN.on = before


def ssd_full(x, dt, a, b, c, *, chunk: int, use_kernel: bool = True,
             initial_state: torch.Tensor | None = None):
    """x: [B,S,H,P]; dt: [B,S,H]; a: [H]; b, c: [B,S,G,N]; S a multiple of
    ``chunk``. Returns (y [B,S,H,P] in x's type, final state [B,H,P,N]
    f32)."""
    use_kernel = use_kernel and not getattr(_PLAIN, "on", False)
    inputs = (x, dt, a, b, c, initial_state)
    if use_kernel and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _SSDFull.apply(*inputs, chunk)
    return _ssd_full(x, dt, a, b, c, chunk=chunk, use_kernel=use_kernel,
                     initial_state=initial_state)


class _SSDFull(torch.autograd.Function):
    """``ssd_full`` through the kernels, differentiated by the plain
    version: the backward reruns ``_ssd_full(..., use_kernel=False)`` on
    the saved inputs under grad and returns its VJP. An input that needs no
    gradient gets None, and the final state's cotangent is left out when
    nothing used the state."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c, initial_state)
        return _ssd_full(x, dt, a, b, c, chunk=chunk,
                         initial_state=initial_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            y, state = _ssd_full(*leaves[:5], chunk=ctx.chunk,
                                 use_kernel=False, initial_state=leaves[5])
            outs = [(o, g) for o, g in ((y, gy), (state, gstate))
                    if g is not None]
            want = [t for t, n in zip(leaves, needs) if n]
            got = (torch.autograd.grad([o for o, _ in outs],
                                       want, [g for _, g in outs],
                                       allow_unused=True)
                   if outs and want else [None] * len(want))
        got = iter(got)
        return (*(next(got) if n else None for n in needs), None)


def _ssd_full(x, dt, a, b, c, *, chunk: int, use_kernel: bool = True,
              initial_state: torch.Tensor | None = None):
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
