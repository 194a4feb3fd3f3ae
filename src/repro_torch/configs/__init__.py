"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

One module per assigned architecture; each exposes ``CONFIG`` (the exact
assigned full-size configuration) and ``smoke()`` (a reduced same-family
config for CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCHS: List[str] = [
    "qwen2-moe-a2.7b",
    "kimi-k2-1t-a32b",
    "whisper-tiny",
    "recurrentgemma-9b",
    "mamba2-780m",
    "qwen3-1.7b",
    "nemotron-4-15b",
    "qwen2-7b",
    "gemma3-1b",
    "qwen2-vl-2b",
]

_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-1.7b": "qwen3_1_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2-7b": "qwen2_7b",
    "gemma3-1b": "gemma3_1b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke()
