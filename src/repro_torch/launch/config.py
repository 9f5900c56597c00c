"""JSON run-config loader for the launchers (the port's copy of
``repro.launch.config``).

    python -m repro_torch.launch.train --config runs/smoke.json

A run config is a flat JSON object whose keys mirror the launcher flags
(``arch``, ``steps``, ``seq``, ``batch``, ``lr``, ``grad_accum``, ``mesh``,
``smoke``, ``ckpt``, ``log_every``) plus optional ``overrides`` applied to
the ModelConfig (e.g. {"num_layers": 2}).  CLI flags win over file values;
``overrides`` compose via ModelConfig.replace.
"""
from __future__ import annotations

import json
from typing import Any, Dict

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig

_LAUNCH_KEYS = ("arch", "steps", "seq", "batch", "lr", "grad_accum",
                "mesh", "smoke", "ckpt", "log_every")


def load_run_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        raw = json.load(f)
    unknown = set(raw) - set(_LAUNCH_KEYS) - {"overrides"}
    if unknown:
        raise ValueError(f"unknown run-config keys: {sorted(unknown)}")
    return raw


def resolve_model(run_cfg: Dict[str, Any]) -> ModelConfig:
    arch = run_cfg["arch"]
    cfg = get_smoke_config(arch) if run_cfg.get("smoke") else get_config(arch)
    overrides = run_cfg.get("overrides") or {}
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def merge_cli(run_cfg: Dict[str, Any], args, *, defaults: Dict[str, Any]):
    """File value unless the CLI flag was explicitly set (differs from its
    argparse default)."""
    out = dict(run_cfg)
    for k, dflt in defaults.items():
        v = getattr(args, k, None)
        if v is not None and v != dflt:
            out[k] = v
        out.setdefault(k, dflt)
    return out
