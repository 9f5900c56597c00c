"""Training metrics: analytic step FLOPs and MFU accounting, the port of
``repro.train.metrics``.

MFU = model FLOPs (6·N_active·tokens, no remat credit) / wall / peak, the
MaxText/PaLM convention.  The default peak is the port's target, one
H100 SXM's dense bf16 tensor rate (``core.hardware.H100_SXM.peak_flops``,
989.4e12), where the reference defaults to a TPU v5e.  This slice trains in
fp32 on the CUDA cores, whose peak is ``H100_FP32_PEAK`` (67e12, the data
sheet's): pass it as ``peak=`` for the MFU of an fp32 step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.hardware import H100_SXM

H100_BF16_PEAK = H100_SXM.peak_flops
H100_FP32_PEAK = 67e12


@dataclass
class StepFlops:
    model: float        # 6·N_active·tokens (the MFU numerator)
    executed: float     # incl. remat recompute (8·N_active·tokens)


def train_step_flops(cfg, tokens: int, *, remat: bool = True) -> StepFlops:
    n = cfg.param_count(active_only=True)
    return StepFlops(model=6.0 * n * tokens,
                     executed=(8.0 if remat else 6.0) * n * tokens)


def mfu(cfg, tokens: int, step_seconds: float, *, chips: int = 1,
        peak: float = H100_BF16_PEAK) -> float:
    f = train_step_flops(cfg, tokens)
    return f.model / max(step_seconds, 1e-12) / (chips * peak)


class Tracker:
    """Rolling window over step metrics; used by the train loop."""

    def __init__(self, cfg, tokens_per_step: int, *, chips: int = 1,
                 peak: float = H100_BF16_PEAK, window: int = 20):
        self.cfg = cfg
        self.tokens = tokens_per_step
        self.chips = chips
        self.peak = peak
        self.window = window
        self.times: list = []

    def update(self, step_seconds: float) -> Dict[str, float]:
        self.times.append(step_seconds)
        recent = self.times[-self.window:]
        avg = sum(recent) / len(recent)
        return {
            "step_s": step_seconds,
            "tokens_per_s": self.tokens / avg,
            "mfu": mfu(self.cfg, self.tokens, avg, chips=self.chips,
                       peak=self.peak),
        }
