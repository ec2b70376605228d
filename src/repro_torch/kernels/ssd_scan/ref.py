"""Plain PyTorch versions of the SSD kernels of ``csrc/ssd_scan.cu``: the
intra-chunk function with the reference's rounding points, and the
recurrence across chunks; the wrappers' path for CPU tensors. On the card
they are held against the kernels with
``torch.backends.cuda.matmul.allow_tf32 = False``."""

from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, *, chunk: int):
    """x: [B,S,H,P]; dt: [B,S,H]; a: [H]; b, c: [B,S,G,N] (head h reads
    group h // (H/G)). Returns (y_diag [B,S,H,P], states [B,nc,H,P,N],
    chunk_decay [B,nc,H]), all f32.

    Rounding points, as the reference kernel's: xdt = x * dt in x's type;
    C.B accumulated in f32; (C.B * L) rounded to x's type before the PV
    product; the state decay and B * decay in x's type; f32 sums."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g

    xc = x.reshape(bs, nc, chunk, h, p)
    dtc = dt.reshape(bs, nc, chunk, h).float()
    bc = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtc * a.float()[None, None, None, :]  # [B,nc,Q,H]
    da_cs = torch.cumsum(da, dim=2)

    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # [B,nc,Q,Q,H]
    q_idx = torch.arange(chunk, device=x.device)
    tri = (q_idx[None, :] <= q_idx[:, None])[None, None, :, :, None]
    # the masked differences are positive: never exponentiated
    l_mat = torch.exp(diff.masked_fill(~tri, float("-inf")))

    xdt = xc * dtc[..., None].to(xc.dtype)
    cb = torch.einsum("bzqhn,bzkhn->bzqkh", cc.float(), bc.float())
    att = (cb * l_mat).to(x.dtype)
    y = torch.einsum("bzqkh,bzkhp->bzqhp", att.float(), xdt.float())

    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs).to(x.dtype)
    st = torch.einsum("bzkhn,bzkhp->bzhpn",
                      (bc * decay_states[..., None]).float(), xdt.float())
    dec = torch.exp(da_cs[:, :, -1, :])
    return y.reshape(bs, s, h, p), st, dec


def ssd_state_pass_ref(states: torch.Tensor, chunk_decay: torch.Tensor,
                       initial_state: torch.Tensor | None = None):
    """The recurrence across chunks (the reference's ``lax.scan`` in
    ``ssd_full``): prev[z] = state; state = state * decay[z] + states[z],
    each product and sum rounded to f32 on its own. states [B,nc,H,P,N],
    chunk_decay [B,nc,H]; initial_state [B,H,P,N] or None (zeros). Returns
    (prev [B,nc,H,P,N], final [B,H,P,N]), f32."""
    bs, nc, h, p, n = states.shape
    state = (torch.zeros((bs, h, p, n), dtype=torch.float32,
                         device=states.device)
             if initial_state is None else initial_state.float())
    prev = torch.empty_like(states)
    for z in range(nc):
        prev[:, z] = state
        state = state * chunk_decay[:, z, :, None, None] + states[:, z]
    return prev, state
