"""Public wrapper: policy-aware streamed matmul.

Selects UNIQUE vs BLOCKS from the TransferPolicy (the same object that
drives host staging), enforcing the shared-memory residency budget for
UNIQUE (``matmul_unique`` raises ``ValueError`` over it) and deriving
BLOCKS tiles from ``policy.block_bytes``.
"""

from __future__ import annotations

import torch

from repro_torch.core.transfer import Partitioning, TransferPolicy
from repro_torch.kernels.streamed_matmul.kernel import (
    TILES,
    matmul_blocks,
    matmul_unique,
)


def block_dims_for(policy: TransferPolicy, m: int, k: int, n: int,
                   itemsize: int) -> tuple[int, int, int]:
    """Derive (bm, bn, bk) from the policy's block_bytes: the largest built
    tile whose K-step working set (bm*bk + bk*bn elements) fits in
    block_bytes, shrunk while half the tile still covers both M and N (no
    128-wide tiles over a 4-wide output). Every tile's working set fits in
    shared memory (at most 32 KB of the 227 KB a block may hold)."""
    fits = [t for t in TILES
            if (t[0] * t[2] + t[2] * t[1]) * itemsize <= policy.block_bytes]
    i = TILES.index(fits[-1]) if fits else 0
    while i > 0 and TILES[i - 1][0] >= max(m, n):
        i -= 1
    return TILES[i]


def streamed_matmul(x: torch.Tensor, w: torch.Tensor,
                    policy: TransferPolicy | None = None) -> torch.Tensor:
    """[M, K] @ [K, N] under the transfer policy's partitioning mode."""
    policy = policy or TransferPolicy()
    if policy.partitioning is Partitioning.UNIQUE:
        return matmul_unique(x, w)
    m, k = x.shape
    _, n = w.shape
    bm, bn, bk = block_dims_for(policy, m, k, n, x.element_size())
    return matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
