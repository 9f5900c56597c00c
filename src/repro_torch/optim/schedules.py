"""Learning-rate schedules (pure functions of the step counter), the port
of ``repro.optim.schedules``.  They take a Python number or a tensor and
return an fp32 tensor (on the step's device), as the reference returns a
jnp fp32 scalar."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = torch.clamp(step / max(1, warmup), max=1.0)
    frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(_step(step))
