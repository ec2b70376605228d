"""Binding of the hand-written CUDA streamed-matmul kernels
(``csrc/matmul.cu``).

Replaces ``src/repro/kernels/streamed_matmul/kernel.py``: ``matmul_blocks``
(``_matmul_kernel``) and ``matmul_unique`` (``_matmul_unique_kernel``). The
source's header says what bounds each on an H100 and how the design answers
that. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

BLOCKS fills the card by splitting K (``split_k_plan``, the split-K scheme
of ``repro_torch.kernels._split``, shared with conv2d) when its output
tiles are fewer than the SMs, and takes a skinny kernel (``skinny``) when
the matrix is narrower than the tile. UNIQUE's single block spreads the
product over all its threads (``unique_plan``). Every plan is a pure
function of the shapes and the card's SM count. ``ref.matmul_blocks_split_ref``
and ``ref.matmul_unique_order_ref`` are the plain versions in the kernels'
orders (held against the reference and, on the card, against the
kernels); the CPU path takes the plain ``ref.matmul_ref``."""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels._build import (
    I, P, CudaLibrary, refuse_dtensor, refuse_grad)
from repro_torch.kernels._split import (  # noqa: F401 (re-exported)
    SPLIT_WORKSPACE,
    SplitWorkspace,
    cdiv,
    sm_count,
    split_plan,
    split_ranges as split_k_ranges,
)
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

MATMUL = CudaLibrary(
    "matmul", Path(__file__).with_name("csrc") / "matmul.cu",
    {"matmul_blocks": [P, P, P, P, P, I, I, I, I, I, I, I, I],
     "matmul_unique": [P, P, P, I, I, I, I, I, I, P]})

# The (bm, bn, bk) tiles the BLOCKS kernel is compiled for: a 16x16 thread
# grid, each thread (bm/16)x(bn/16) accumulators; the K step's operand
# tiles, held as f32, take 2, 8 and 32 KB of shared memory.
TILES = ((32, 32, 16), (64, 64, 32), (128, 128, 32))

# UNIQUE accepts exactly the operands the reference accepts: its budget
# (src/repro/kernels/streamed_matmul/ops.py, VMEM_BUDGET) is 96 MiB over
# (m*k + k*n + m*n) * itemsize, and above it the same ValueError is raised.
# On the card, operands within one block's shared memory (SMEM_BUDGET, the
# 232,448 bytes an H100 block may opt in to, less the block's barrier and
# alignment: 16 + x's bytes rounded up to 16 + w's bytes) run as one block
# holding both; larger ones run as a grid of output tiles, each walking
# the whole K extent from device memory (csrc/matmul.cu says why both
# stay).
UNIQUE_BUDGET = 96 * 2**20
SMEM_BUDGET = 232_448
UNIQUE_THREADS = 256  # the single block's threads (csrc/matmul.cu)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

THREADS = 256  # a BLOCKS block's threads
SKINNY_UNITS = 4  # output units (a row, 4 columns) a lane group holds


def split_k_plan(m: int, n: int, k: int, tile: tuple[int, int, int],
                 sms: int) -> tuple[int, int]:
    """(splits, bk steps a split) for BLOCKS at (m, n, k) under ``tile`` on
    a card of ``sms`` SMs. Where the output-tile grid is smaller, K is cut
    into contiguous ranges of whole bk steps, one block each, so that
    tiles x splits fills the card (at most one split a step, none empty);
    a grid that fills the card keeps one split, a single pass."""
    bm, bn, bk = tile
    return split_plan(cdiv(m, bm) * cdiv(n, bn), cdiv(k, bk), sms)


def skinny(m: int, n: int, tile: tuple[int, int, int]) -> bool:
    """Whether BLOCKS takes its skinny kernel: the matrix is narrower than
    the tile (bm > m or bn > n) and the tile's valid part, in units of a
    row and 4 columns, fits the block's lane groups (256 / bk groups of bk
    lanes, ``SKINNY_UNITS`` units each)."""
    bm, bn, bk = tile
    if bm <= m and bn <= n:
        return False
    units = min(m, bm) * cdiv(min(n, bn), 4)
    return units <= THREADS // bk * SKINNY_UNITS


def blocks_plan(m: int, n: int, k: int, tile: tuple[int, int, int],
                sms: int) -> tuple[int, int, bool]:
    """(splits, bk steps a split, skinny): ``split_k_plan`` and ``skinny``
    together."""
    return (*split_k_plan(m, n, k, tile, sms), skinny(m, n, tile))




def _check(x: torch.Tensor, w: torch.Tensor,
           dev: torch.device) -> tuple[int, int, int]:
    # each attribute read once (``dev`` is x's device): at the classifier
    # head's size the host's time is most of the call
    xs, ws = x.shape, w.shape
    if len(xs) != 2 or len(ws) != 2 or xs[1] != ws[0]:
        raise ValueError(f"bad operands {tuple(xs)} @ {tuple(ws)}")
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"needs CUDA tensors on one device, got {dev} "
                         f"and {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return xs[0], xs[1], ws[1]


def unique_fits(m: int, k: int, n: int, itemsize: int) -> bool:
    return (m * k + k * n + m * n) * itemsize <= UNIQUE_BUDGET


def unique_one_block(m: int, k: int, n: int, itemsize: int) -> bool:
    """Whether UNIQUE runs as the single block holding both operands in
    shared memory (csrc/matmul.cu ``unique_smem_bytes``), not as the grid."""
    return 16 + cdiv(m * k * itemsize, 16) * 16 + k * n * itemsize \
        <= SMEM_BUDGET


def unique_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(rows, splits) of UNIQUE's single block: each thread holds a
    micro-tile of ``rows`` x 4 outputs (4 x 4, or 1 x 4 when M < 4), and
    ``splits`` threads share each micro-tile's K, thread s taking k = s,
    s + splits, ... — the largest power of two with micro-tiles x splits
    within the block's ``UNIQUE_THREADS`` and splits <= K. With more
    micro-tiles than threads a thread takes several, one split each."""
    rows = 4 if m >= 4 else 1
    cap = min(UNIQUE_THREADS // (cdiv(m, rows) * cdiv(n, 4)), k)
    return rows, 1 << (cap.bit_length() - 1) if cap >= 1 else 1


def matmul_blocks(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 128,
                  block_n: int = 128, block_k: int = 32) -> torch.Tensor:
    """BLOCKS-mode matmul: [M, K] @ [K, N], (bm, bn) output tiles, K
    streamed through shared memory bk at a time, split over blocks by
    ``split_k_plan`` and summed in slice order. Ragged edges are masked."""
    refuse_dtensor("the BLOCKS matmul kernel", x, w)
    dev = x.device
    if dev.type == "cpu":
        return matmul_ref(x, w)
    refuse_grad("the BLOCKS matmul kernel", x, w)
    m, k, n = _check(x, w, dev)
    tile = (block_m, block_n, block_k)
    if tile not in TILES:
        raise ValueError(f"no BLOCKS kernel for tile {tile}; built: {TILES}")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if not (m and n and k):
        return y.zero_()
    idx = dev.index  # a tensor's device always has its index
    splits, per, thin = blocks_plan(m, n, k, tile, sm_count(idx))
    part_ptr = cnt_ptr = None
    if splits > 1:
        # held until the launch is enqueued (SplitWorkspace)
        part, cnt = SPLIT_WORKSPACE.scratch(
            dev, torch._C._cuda_getCurrentRawStream(idx), splits * m * n,
            cdiv(m, block_m) * cdiv(n, block_n))
        part_ptr, cnt_ptr = part.data_ptr(), cnt.data_ptr()
    MATMUL.launch("matmul_blocks", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                  part_ptr, cnt_ptr, m, n, k, block_m, splits, per,
                  int(thin), _DTYPE_CODE[x.dtype], device=dev)
    return y


def matmul_unique(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """UNIQUE-mode matmul: one dot over the whole operands, no K-streamed
    partition. Raises ``ValueError`` over ``UNIQUE_BUDGET``, as the
    reference does."""
    refuse_dtensor("the UNIQUE matmul kernel", x, w)
    m, k, n = x.shape[0], x.shape[-1], w.shape[-1]
    if not unique_fits(m, k, n, x.element_size()):
        raise ValueError(
            f"UNIQUE-mode matmul ({m}x{k})@({k}x{n}) exceeds the VMEM budget "
            f"({UNIQUE_BUDGET >> 20} MiB) — the paper's 8MB AXI-limit "
            f"analogue. Use BLOCKS partitioning.")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    refuse_grad("the UNIQUE matmul kernel", x, w)
    m, k, n = _check(x, w, x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y.zero_()
    rows, splits = unique_plan(m, n, k)
    MATMUL.launch("matmul_unique", x.data_ptr(), w.data_ptr(),
                  y.data_ptr(), m, n, k, rows, splits, _DTYPE_CODE[x.dtype],
                  device=x.device)
    return y
