"""Config registry for the port: one module per architecture, copied
from the reference package (all ten: the dense archs with gemma2, the MoE
archs arctic and llama4, the llama-3.2-vision vlm, whisper, rwkv6 and
recurrentgemma; ``ARCH_IDS``), the architectures the port serves beyond
the reference (``PORT_ARCH_IDS``: deepseek-moe-16b), plus the
reference's input-shape table."""
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

#: the reference package's architectures, each compared with it
ARCH_IDS = tuple(_MODULES)

#: architectures the port alone serves (no counterpart to compare with)
_PORT_MODULES = {
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}
PORT_ARCH_IDS = tuple(_PORT_MODULES)


def _module(arch: str):
    name = _MODULES.get(arch) or _PORT_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCH_IDS + PORT_ARCH_IDS)}")
    return importlib.import_module(name)


def get_config(arch: str) -> ModelConfig:
    cfg = _module(arch).CONFIG
    cfg.validate()
    return cfg


def get_tiny_config(arch: str) -> ModelConfig:
    cfg = _module(arch).tiny()
    cfg.validate()
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
