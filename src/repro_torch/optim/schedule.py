"""LR schedules (pure functions of the step counter). The step may be a
Python number or a tensor on the device (the optimizer's ``step``); the
scale comes back as an f32 tensor on the step's device, with no host
sync."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup then cosine decay to min_frac. Returns a scale in (0,1]."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant_schedule(step, **_):
    return torch.ones_like(torch.as_tensor(step).to(torch.float32))
