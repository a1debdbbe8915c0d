"""Assigned architecture registry: ``get_config(arch_id)``."""

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "stablelm-3b": "stablelm_3b",
    "qwen3-32b": "qwen3_32b",
    "chatglm3-6b": "chatglm3_6b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_configs",
    "get_config",
    "shape_applicable",
]
