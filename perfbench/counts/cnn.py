"""The RoShamBo CNN's launches and model FLOPs, from its configuration
(``configs/roshambo-nullhop.json``'s sizes)."""

from __future__ import annotations

from perfbench.counts import conv2d


def conv_shapes(cfg: dict, batch: int) -> list[tuple[int, int, int, int, int]]:
    """(B, H, W, Cin, Cout) of each conv layer, in order."""
    hw = cfg["input_hw"]
    out = []
    for layer in cfg["layers"]:
        out.append((batch, hw, hw, layer["c_in"], layer["c_out"]))
        if layer["pool"]:
            hw //= 2
    return out


def feature_size(cfg: dict) -> int:
    hw = cfg["input_hw"]
    for layer in cfg["layers"]:
        if layer["pool"]:
            hw //= 2
    return hw * hw * cfg["layers"][-1]["c_out"]


def frame_flops(cfg: dict) -> int:
    """One frame's model FLOPs: the convs' multiply-adds (2 a MAC) and the
    classifier head's."""
    k = cfg["kernel"]
    convs = sum(2 * h * w * ci * co * k * k
                for _, h, w, ci, co in conv_shapes(cfg, 1))
    return convs + 2 * feature_size(cfg) * cfg["n_classes"]


def launch_counts(cfg: dict, batch: int) -> list[tuple[int, int]]:
    """(FLOPs, bytes) of each conv launch of one call, in order."""
    k = cfg["kernel"]
    return [(conv2d.flops(*s, k=k), conv2d.nbytes(*s, k=k))
            for s in conv_shapes(cfg, batch)]
