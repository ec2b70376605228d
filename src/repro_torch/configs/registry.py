"""Registry mapping --arch ids to ModelConfig builders.

The reference's arch ids, all of them. The dense, ssm and hybrid families
and the paper's RoShamBo CNN are ported; every other arch raises
``NotImplementedError`` naming the ROADMAP item that brings it, never a
bare ``KeyError``."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "roshambo-nullhop": "repro_torch.configs.roshambo",
}

# arch id -> the ROADMAP (Queue 1) item that ports its family
_NOT_PORTED = {
    "seamless-m4t-medium": "slice 4, item 14 (models/encdec.py)",
    "pixtral-12b": "slice 4, item 15 (the vlm prefix-token config)",
    "deepseek-moe-16b": "slice 4, item 13 (models/layers/moe.py)",
    "granite-moe-1b-a400m": "slice 4, item 13 (models/layers/moe.py)",
}

# the reference's order of arch ids
ARCHS = ("seamless-m4t-medium", "stablelm-12b", "qwen2.5-3b",
         "internlm2-20b", "h2o-danube-1.8b", "pixtral-12b",
         "deepseek-moe-16b", "granite-moe-1b-a400m", "mamba2-780m",
         "zamba2-1.2b")


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP Queue 1, "
            f"{_NOT_PORTED[name]}")
    if name not in _ARCH_MODULES:
        known = sorted([*_ARCH_MODULES, *_NOT_PORTED])
        raise KeyError(f"unknown arch {name!r}; known: {known}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).config()
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> tuple[str, ...]:
    return ARCHS


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke_config()
