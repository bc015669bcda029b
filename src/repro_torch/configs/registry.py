"""Architecture registry: the 10 assigned configs + reduced smoke configs.

Full configs transcribed from the assignment (public-literature sources in
each module docstring); SMOKE configs keep the same family/block pattern
with tiny dims for CPU one-step tests.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .common import ModelConfig

ARCH_IDS = [
    "llama4-maverick-400b-a17b", "olmoe-1b-7b", "paligemma-3b",
    "qwen1.5-0.5b", "gemma2-9b", "stablelm-3b", "qwen2-0.5b",
    "xlstm-1.3b", "zamba2-7b", "whisper-small",
]

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "olmoe-1b-7b": "olmoe",
    "paligemma-3b": "paligemma",
    "qwen1.5-0.5b": "qwen1_5",
    "gemma2-9b": "gemma2",
    "stablelm-3b": "stablelm",
    "qwen2-0.5b": "qwen2",
    "xlstm-1.3b": "xlstm_1b",
    "zamba2-7b": "zamba2",
    "whisper-small": "whisper_small",
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
