"""Plain reference of the RoShamBo CNN, in float32 with TF32 off.

Written from the published description (five 3x3 convs with SAME padding,
bias, ReLU, a 2x2 max pool after every layer but the last, a linear head
over the flattened features), on ``torch.nn.functional`` alone. It reads
the harness's weights (HWIO kernels, NHWC frames) and lays them out for
itself; it imports nothing of the program.

``precision="tf32"`` is the control: every product's operands rounded to
TF32's 10-bit mantissa, the step below the configuration's float32 (on
the CPU too); ``"tf32_cores"`` lets the card's TF32 tensor cores run the
products, as a program with TF32 on would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa
    bits, ties away from zero), as the tensor cores read their operands."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def logits(cfg: dict, params: dict, frames: torch.Tensor, *,
           precision: str = "f32") -> torch.Tensor:
    """frames [B, H, W, 1] float32 -> logits [B, classes] float32."""
    if precision not in ("f32", "tf32", "tf32_cores"):
        raise ValueError(f"unknown precision {precision!r}")
    q = round_tf32 if precision == "tf32" else (lambda t: t)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    cores = precision == "tf32_cores"
    torch.backends.cuda.matmul.allow_tf32 = cores
    torch.backends.cudnn.allow_tf32 = cores
    try:
        x = frames.float().permute(0, 3, 1, 2)  # NCHW
        for L in cfg["layers"]:
            w = params[L["name"]]["w"].float().permute(3, 2, 0, 1)  # OIHW
            b = params[L["name"]]["b"].float()
            x = F.conv2d(q(x), q(w), b, padding=cfg["kernel"] // 2)
            x = F.relu(x)
            if L["pool"]:
                x = F.max_pool2d(x, 2)
        feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # HWC order
        return (q(feats) @ q(params["fc"]["w"].float())
                + params["fc"]["b"].float())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
