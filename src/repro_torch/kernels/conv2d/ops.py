"""Public wrapper: SAME-padded streamed conv2d (+bias, +relu)."""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d.kernel import conv2d_rows
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref


def conv2d_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = True) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [KH, KW, Cin, Cout] (SAME, stride 1).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    row-streamed CUDA kernel or raises."""
    if x.device.type == "cpu":
        return conv2d_relu_ref(x, w, b, relu=relu)
    return conv2d_rows(x, w, b, relu=relu)
