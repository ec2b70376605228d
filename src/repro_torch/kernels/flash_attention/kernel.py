"""Binding of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py``
(``_flash_kernel`` / ``flash_attention_bhsd``) together with the transposes
of its ``ops.py`` wrapper: the kernel reads [B, S, H, D] tensors by stride,
so there is one entry, ``flash_attention_bshd``. The source's header says
what bounds it on an H100 and how the design answers that. A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the kernel or
raises.

Beyond the reference: any ``Sq`` and ``Skv`` are accepted (the kernel masks
the ragged edge; the reference asserts divisibility by its block sizes), so
the TPU version's ``block_q`` / ``block_kv`` have no counterpart here."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import I, L, P, CudaLibrary

FLASH = CudaLibrary(
    "flash_attention", Path(__file__).with_name("csrc") / "flash_attention.cu",
    {"flash_attention_fwd": [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L,
                             I, I, I, P]})

# head dims the kernel is compiled for: smoke 64, danube 80, qwen 128,
# stablelm 160
HEAD_DIMS = (64, 80, 128, 160)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != k.dim() or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"needs CUDA tensors on one device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head dim {q.shape[-1]} (k {k.shape[-1]}): the "
                         f"kernel is built for {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (Hkv divides H), read where
    they lie: no transposes. CUDA tensors only (``ops.flash_attention``
    takes the plain version for CPU tensors)."""
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
        with torch.cuda.device(q.device):
            FLASH.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), o.data_ptr(), b, h, hkv, sq, skv, d,
                         sq * h * d, h * d, d, skv * hkv * d, hkv * d, d,
                         int(causal), int(window), _DTYPE_CODE[q.dtype])
    return o
