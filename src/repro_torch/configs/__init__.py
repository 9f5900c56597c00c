"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Only the architectures the port serves are registered (llama3-8b,
zamba2-7b, rwkv6-1.6b); the others join with the slices that port their
families (see ROADMAP.md, queue 1).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke

# arch-id -> module name
_REGISTRY = {
    "llama3-8b": "llama3_8b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}

ALL_ARCHS = list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return smoke(get_config(name))


__all__ = ["ModelConfig", "get_config", "get_smoke_config", "smoke", "ALL_ARCHS"]
