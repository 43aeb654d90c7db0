"""Architecture registry: one module per assigned architecture.

``get_config(name)`` accepts either the assignment id ("qwen3-14b") or the
module name ("qwen3_14b").
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, TrainConfig

ARCHS = [
    "xlstm_350m",
    "pixtral_12b",
    "zamba2_7b",
    "codeqwen1_5_7b",
    "command_r_plus_104b",
    "qwen3_14b",
    "yi_9b",
    "seamless_m4t_large_v2",
    "deepseek_v2_236b",
    "mixtral_8x22b",
]


def canonical(name: str) -> str:
    mod = name.replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return mod


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "TrainConfig",
           "get_config", "all_configs", "canonical"]
