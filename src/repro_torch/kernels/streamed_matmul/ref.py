"""Plain PyTorch versions of the streamed matmul: [M, K] @ [K, N] with an
f32 accumulator, result in the input dtype; BLOCKS's in the kernel's
slices (one f32 partial per K range, summed in slice order) and UNIQUE's
in its single block's order. On the card the comparison runs
with ``torch.backends.cuda.matmul.allow_tf32 = False``, so float32 stays
float32."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)


def matmul_blocks_split_ref(x: torch.Tensor, w: torch.Tensor,
                            ranges: list[tuple[int, int]]) -> torch.Tensor:
    """BLOCKS as the kernel slices it: an f32 partial over each [k0, k1) of
    ``ranges`` (``kernel.split_k_ranges``), summed in slice order."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for z, (k0, k1) in enumerate(ranges):
        part = xf[:, k0:k1] @ wf[k0:k1]
        acc = part if z == 0 else acc + part
    return acc.to(x.dtype)


def matmul_unique_order_ref(x: torch.Tensor, w: torch.Tensor,
                            splits: int) -> torch.Tensor:
    """UNIQUE's single block in its order (``kernel.unique_plan``): thread
    s of the ``splits`` (a power of two) that share each output sums k = s,
    s + splits, ... in k order; the threads' partials are then added in
    xor-shuffle pairs inside a warp (halves of min(splits, 32) lanes, the
    wider half first) and the warps' sums in warp order."""
    xf, wf = x.float(), w.float()
    m, k = xf.shape
    n = wf.shape[1]
    steps = -(-k // splits)
    pad = steps * splits - k
    xs = torch.nn.functional.pad(xf, (0, pad)).reshape(m, steps, splits)
    ws = torch.nn.functional.pad(wf, (0, 0, 0, pad)).reshape(steps, splits, n)
    part = torch.zeros((splits, m, n), dtype=torch.float32, device=x.device)
    for j in range(steps):
        part = part + xs[:, j, :].T[:, :, None] * ws[j][:, None, :]
    lanes = min(splits, 32)
    part = part.reshape(splits // lanes, lanes, m, n)
    while part.shape[1] > 1:
        half = part.shape[1] // 2
        part = part[:, :half] + part[:, half:]
    acc = part[0, 0]
    for warp in range(1, part.shape[0]):
        acc = acc + part[warp, 0]
    return acc.to(x.dtype)
