"""``--arch <id>`` registry: all 10 assigned architectures."""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable  # noqa: F401

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma3-12b": "gemma3_12b",
    "yi-6b": "yi_6b",
    "granite-8b": "granite_8b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.smoke_config()
