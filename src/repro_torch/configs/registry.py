"""Registry mapping --arch ids to ModelConfig builders: the reference's
arch ids, all of them (``ARCHS``), the paper's RoShamBo CNN,
granite-4.0-h-small (the hybrid_moe family), DeepSeek-V2-Lite (the mla
family) and Kimi-Linear-48B-A3B (the linear_mla family), which the
reference lacks."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "roshambo-nullhop": "repro_torch.configs.roshambo",
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
    "kimi-linear-48b-a3b-instruct": "repro_torch.configs.kimi_linear_48b_a3b",
}

# the port's own: the paper's CNN, and families the reference lacks
PORT_ONLY = ("roshambo-nullhop", "granite-4.0-h-small", "deepseek-v2-lite",
             "kimi-linear-48b-a3b-instruct")
ARCHS = tuple(k for k in _ARCH_MODULES if k not in PORT_ONLY)


def _module(name: str):
    if name not in _ARCH_MODULES:
        known = sorted(_ARCH_MODULES)
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
