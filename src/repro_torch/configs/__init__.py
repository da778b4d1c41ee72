"""Assigned-architecture registry: ``--arch <id>`` resolves here (a copy
of the JAX package's ``configs``, the same ten configurations)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = {
    "internvl2-76b": "internvl2_76b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "dbrx-132b": "dbrx_132b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-67b": "deepseek_67b",
    "yi-6b": "yi_6b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-medium": "whisper_medium",
    "mamba2-130m": "mamba2_130m",
}


def get(name: str) -> ModelConfig:
    """The ``ModelConfig`` of architecture ``name``."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.config()


def list_archs() -> list[str]:
    """Every architecture id, in the registry's order."""
    return list(ARCHS)
