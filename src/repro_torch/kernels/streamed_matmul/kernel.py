"""Binding of the hand-written CUDA streamed-matmul kernels
(``csrc/matmul.cu``).

Replaces ``src/repro/kernels/streamed_matmul/kernel.py``: ``matmul_blocks``
(``_matmul_kernel``) and ``matmul_unique`` (``_matmul_unique_kernel``). The
source's header says what bounds each on an H100 and how the design answers
that. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import I, P, CudaLibrary
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

MATMUL = CudaLibrary(
    "matmul", Path(__file__).with_name("csrc") / "matmul.cu",
    {"matmul_blocks": [P, P, P, I, I, I, I, I, P],
     "matmul_unique": [P, P, P, I, I, I, I, P]})

# The (bm, bn, bk) tiles the BLOCKS kernel is compiled for: a 16x16 thread
# grid, each thread (bm/16)x(bn/16) accumulators; the K step's operand
# tiles, held as f32, take 2, 8 and 32 KB of shared memory.
TILES = ((32, 32, 16), (64, 64, 32), (128, 128, 32))

# UNIQUE accepts exactly the operands the reference accepts: its budget
# (src/repro/kernels/streamed_matmul/ops.py, VMEM_BUDGET) is 96 MiB over
# (m*k + k*n + m*n) * itemsize, and above it the same ValueError is raised.
# On the card, operands within one block's shared memory (SMEM_BUDGET, the
# 232,448 bytes an H100 block may opt in to) run as one block holding both;
# larger ones run as a grid of output tiles, each walking the whole K
# extent from device memory (csrc/matmul.cu says why both stay).
UNIQUE_BUDGET = 96 * 2**20
SMEM_BUDGET = 232_448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad operands {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"needs CUDA tensors on one device, got {x.device} "
                         f"and {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return x.shape[0], x.shape[1], w.shape[1]


def unique_fits(m: int, k: int, n: int, itemsize: int) -> bool:
    return (m * k + k * n + m * n) * itemsize <= UNIQUE_BUDGET


def matmul_blocks(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 128,
                  block_n: int = 128, block_k: int = 32) -> torch.Tensor:
    """BLOCKS-mode matmul: [M, K] @ [K, N], (bm, bn) output tiles, K
    streamed through shared memory bk at a time. Ragged edges are masked."""
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    m, k, n = _check(x, w)
    tile = (block_m, block_n, block_k)
    if tile not in TILES:
        raise ValueError(f"no BLOCKS kernel for tile {tile}; built: {TILES}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.zero_()
    with torch.cuda.device(x.device):
        MATMUL.launch("matmul_blocks", x.data_ptr(), w.data_ptr(),
                      y.data_ptr(), m, n, k, block_m, _DTYPE_CODE[x.dtype])
    return y


def matmul_unique(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """UNIQUE-mode matmul: one dot over the whole operands, no K-streamed
    partition. Raises ``ValueError`` over ``UNIQUE_BUDGET``, as the
    reference does."""
    m, k, n = x.shape[0], x.shape[-1], w.shape[-1]
    if not unique_fits(m, k, n, x.element_size()):
        raise ValueError(
            f"UNIQUE-mode matmul ({m}x{k})@({k}x{n}) exceeds the VMEM budget "
            f"({UNIQUE_BUDGET >> 20} MiB) — the paper's 8MB AXI-limit "
            f"analogue. Use BLOCKS partitioning.")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    m, k, n = _check(x, w)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.zero_()
    with torch.cuda.device(x.device):
        MATMUL.launch("matmul_unique", x.data_ptr(), w.data_ptr(),
                      y.data_ptr(), m, n, k, _DTYPE_CODE[x.dtype])
    return y
