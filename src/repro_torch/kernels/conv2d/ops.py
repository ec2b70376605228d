"""Public wrapper: SAME-padded conv2d (+bias, +relu)."""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d.kernel import conv2d_igemm
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref


def conv2d_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = True) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout] (SAME, stride 1).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    implicit-GEMM CUDA kernel (split-K where its tiles do not fill the
    card) or raises."""
    if x.device.type == "cpu":
        return conv2d_relu_ref(x, w, b, relu=relu)
    return conv2d_igemm(x, w, b, relu=relu)
