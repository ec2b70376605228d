"""The port's device rule, shared by every entry point (the transfer
engine, the model, the launcher)."""

from __future__ import annotations

import torch


def default_device(device: "torch.device | str | None") -> torch.device:
    """The device of a port entry point: the caller's, else the current
    CUDA card. With no card and no explicit device this raises — the port
    never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the host")
    return torch.device("cuda", torch.cuda.current_device())
