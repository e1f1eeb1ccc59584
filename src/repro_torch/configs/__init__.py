"""Config registry: ``get_config("<arch-id>")`` for every assigned arch."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      reduced, shape_applicable)

ARCH_IDS = [
    "zamba2-2.7b",
    "qwen2-0.5b",
    "codeqwen1.5-7b",
    "llama3.2-3b",
    "gemma3-1b",
    "qwen2-moe-a2.7b",
    "granite-moe-1b-a400m",
    "chameleon-34b",
    "whisper-large-v3",
    "xlstm-1.3b",
]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS and arch_id != "qlmio":
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS + ['qlmio']}")
    mod = importlib.import_module(_module_name(arch_id))
    return mod.CONFIG


__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "SHAPES",
    "ShapeConfig",
    "get_config",
    "reduced",
    "shape_applicable",
]
