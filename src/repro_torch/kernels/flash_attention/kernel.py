"""Binding of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py``
(``_flash_kernel`` / ``flash_attention_bhsd``) together with the transposes
of its ``ops.py`` wrapper: the kernels read [B, S, H, D] tensors by stride,
so there is one entry, ``flash_attention_bshd``. Two kernels serve it, one
per dtype, each under a C symbol of its own so that a run's launch counts
show which served a forward:

- bf16 goes to ``flash_attention_fwd_tc``: both products on the tensor
  cores (``wgmma``), p kept in registers, K/V tiles brought by TMA through
  a two-stage ring;
- f32 stays on ``flash_attention_fwd``, the CUDA-core kernel, with f32 FMAs:
  on the tensor cores a float32 product would be TF32, which the f32
  route's limits (2e-4 against the plain version, the LM's f32 logits at
  1e-3) do not allow.

The source's header says what bounds each on an H100 and how the design
answers that. A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel of its dtype or raises ``ValueError``.

Beyond the reference: any ``Sq`` and ``Skv`` are accepted (the kernels
mask the ragged edge; the reference asserts divisibility by its block
sizes), so the TPU version's ``block_q`` / ``block_kv`` have no
counterpart here."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, L, P, CudaLibrary, refuse_dtensor, refuse_grad)

_ARGS = [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, I, I, P]
_ARGS_DKV = [P, P, P, P, I, I, I, I, I, I, I, *[L] * 12, I, I, P]
FLASH = CudaLibrary(
    "flash_attention", Path(__file__).with_name("csrc") / "flash_attention.cu",
    {"flash_attention_fwd": _ARGS, "flash_attention_fwd_tc": _ARGS,
     "flash_attention_fwd_tc_dkv": _ARGS_DKV})

# head dims the kernels are compiled for: smoke 64, danube 80, qwen 128,
# stablelm 160
HEAD_DIMS = (64, 80, 128, 160)

# (q / k head dim, v / o head dim) pairs the two-width entry is compiled
# for: MLA's decompressed prefill (DeepSeek-V2: 128 + 64, 128)
DKV_DIMS = ((192, 128),)

# the C symbol that serves each dtype
SYMBOL = {torch.float32: "flash_attention_fwd",
          torch.bfloat16: "flash_attention_fwd_tc"}

# the tensor-core kernel's tiles: 128 query rows a block (two warpgroups of
# 64, each skipping the K/V tiles none of its rows sees), 64 keys a K/V tile
TC_BLOCK_Q, TC_WARPGROUP_Q, TC_BLOCK_KV = 128, 64, 64


def visible_kv_tiles(q0: int, bq: int, bkv: int, sq: int, skv: int,
                     causal: bool, window: int) -> tuple[int, int]:
    """[t_lo, t_hi): the ``bkv``-key tiles that some query row in
    [q0, min(q0 + bq, sq)) can see; the kernels skip every other tile
    (``visible_kv_tiles`` in ``csrc/flash_attention.cu`` is the same
    function). The rows' visible keys form one interval, so every tile in
    the range holds a visible (q, k) pair."""
    if q0 >= sq or skv <= 0:
        return 0, 0
    q_last = min(q0 + bq, sq) - 1
    k_lo, k_hi = 0, skv
    if causal:
        k_hi = min(k_hi, q_last + 1)
    if window > 0:
        k_lo = max(0, q0 - window + 1)
    if k_hi <= k_lo:
        return 0, 0
    return k_lo // bkv, -(-k_hi // bkv)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != k.dim() or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"needs CUDA tensors on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SYMBOL:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head dim {q.shape[-1]} (k {k.shape[-1]}): the "
                         f"kernels are built for {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        # the tensor-core kernel's TMA maps need 16-byte aligned tensors
        raise ValueError("bf16 q, k and v must start on 16 bytes")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (Hkv divides H), read where
    they lie: no transposes. CUDA tensors only (``ops.flash_attention``
    takes the plain version for CPU tensors). Raises
    ``NotImplementedError`` where autograd would need its gradient: the
    kernel has no backward, as the reference's has none."""
    refuse_dtensor("the flash attention kernel", q, k, v)
    refuse_grad("the flash attention kernel", q, k, v)
    _check(q, k, v, window)
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not [B, S, H, D]")
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    o = torch.empty_like(q)
    if o.numel():
        FLASH.launch(SYMBOL[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), b, h, hkv, sq, skv, d,
                     sq * h * d, h * d, d, skv * hkv * d, hkv * d, d,
                     int(causal), int(window), device=q.device)
    return o


def flash_attention_dkv_bshd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_offset: int = 0
                             ) -> torch.Tensor:
    """Causal attention with two head widths: q [B, Sq, H, Dk], k [B, Skv,
    Hkv, Dk], v [B, Skv, Hkv, Dv] -> [B, Sq, H, Dv], query row i at key
    position ``q_offset + i``, scores scaled by 1/sqrt(Dk). bf16 CUDA
    tensors whose last dim is contiguous, read by stride (v may be a view
    into a wider tensor), at a (Dk, Dv) of ``DKV_DIMS``; anything else
    raises ``ValueError``. The tensor-core kernel, entry
    ``flash_attention_fwd_tc_dkv``."""
    refuse_dtensor("the flash attention kernel", q, k, v)
    refuse_grad("the flash attention kernel", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [B, S, H, D]")
    b, sq, h, dk = q.shape
    _, skv, hkv, dv = v.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[-1] != dk
            or h % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if (dk, dv) not in DKV_DIMS:
        raise ValueError(f"head dims ({dk}, {dv}): the two-width kernel is "
                         f"built for {DKV_DIMS}")
    if any(t.device.type != "cuda" or t.device != q.device
           or t.dtype != torch.bfloat16 for t in (k, v)) or (
            q.device.type != "cuda" or q.dtype != torch.bfloat16):
        raise ValueError("needs bf16 CUDA tensors on one device")
    for t in (q, k, v):
        # the TMA maps: 16-byte aligned, last dim contiguous, other strides
        # whole multiples of 16 bytes
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError("q, k and v need a contiguous last dim, 16-byte "
                             "alignment and strides a multiple of 8")
    if not 0 <= q_offset <= skv - sq:
        raise ValueError(f"q_offset {q_offset}: {sq} queries after it must "
                         f"lie within the {skv} keys")
    o = q.new_empty((b, sq, h, dv))
    if o.numel():
        FLASH.launch("flash_attention_fwd_tc_dkv", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), b, h, hkv, sq, skv, dk, dv,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *o.stride()[:3], int(q_offset), 1, device=q.device)
    return o
