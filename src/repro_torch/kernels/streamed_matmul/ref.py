"""Plain PyTorch version of the streamed matmul: [M, K] @ [K, N] with an f32
accumulator, result in the input dtype. On the card the comparison runs
with ``torch.backends.cuda.matmul.allow_tf32 = False``, so float32 stays
float32."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(x.dtype)
