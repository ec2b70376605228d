"""Public wrapper: SAME-padded conv2d (+bias, +relu), with the 2x2 max pool
and the count of nonzeros optionally taken in its epilogue."""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d.kernel import conv2d_igemm
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref


def conv2d_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = True, pool: bool = False,
                counts: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout] (SAME, stride 1). ``pool``:
    then the 2x2 / stride-2 VALID max pool. ``counts``: a one-element int32
    tensor on x's device, to which the output's nonzero values are added.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    implicit-GEMM CUDA kernel once (split-K where its tiles do not fill the
    card; the pool and the count in its epilogue) or raises."""
    if x.device.type == "cpu":
        return conv2d_relu_ref(x, w, b, relu=relu, pool=pool, counts=counts)
    return conv2d_igemm(x, w, b, relu=relu, pool=pool, counts=counts)
