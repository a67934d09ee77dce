"""Config registry for the port: one module per architecture, copied
from the reference package (all ten: the dense archs with gemma2, the MoE
archs arctic and llama4, the llama-3.2-vision vlm, whisper, rwkv6 and
recurrentgemma), plus the reference's input-shape table."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, LONG_CONTEXT_OK, InputShape,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1b6",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch]).CONFIG
    cfg.validate()
    return cfg


def get_tiny_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch]).tiny()
    cfg.validate()
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
