"""Plain PyTorch versions of the streamed matmul: [M, K] @ [K, N] with an
f32 accumulator, result in the input dtype; BLOCKS's in the kernel's
slices (one f32 partial per K range, summed in slice order). On the card the comparison runs
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
