"""The port's own copy of ``repro.configs``.

Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Ten assigned architectures + the five models from Lagom's own Table 2.
Every one is registered, so the tuner can extract its workload; a family
the port cannot run yet still raises ``NotImplementedError`` when its
model is built (``models/layers.py``, ``models/dense.py``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, shape_applicable

# arch-id -> module name
_REGISTRY = {
    # assigned pool (10)
    "rwkv6-1.6b":           "rwkv6_1p6b",
    "zamba2-7b":            "zamba2_7b",
    "h2o-danube-1.8b":      "h2o_danube_1p8b",
    "qwen2-moe-a2.7b":      "qwen2_moe_a2p7b",
    "stablelm-3b":          "stablelm_3b",
    "whisper-small":        "whisper_small",
    "phi4-mini-3.8b":       "phi4_mini_3p8b",
    "qwen2-vl-72b":         "qwen2_vl_72b",
    "yi-34b":               "yi_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    # Lagom Table 2 workloads (5)
    "phi2-2b":              "phi2_2b",
    "llama3-8b":            "llama3_8b",
    "mpt-7b":               "mpt_7b",
    "deepseek-moe-16b":     "deepseek_moe_16b",
    "olmoe-1b-7b":          "olmoe_1b_7b",
}

ASSIGNED_ARCHS = list(_REGISTRY)[:10]
PAPER_ARCHS = list(_REGISTRY)[10:]
ALL_ARCHS = list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return smoke(get_config(name))


__all__ = [
    "ModelConfig", "InputShape", "INPUT_SHAPES", "shape_applicable",
    "get_config", "get_smoke_config", "smoke",
    "ASSIGNED_ARCHS", "PAPER_ARCHS", "ALL_ARCHS",
]
