"""Serving front door of the port.

  types      — the shared Request dataclass
  engine     — fixed-batch lockstep Engine (+ make_serve_step)
  continuous — ContinuousEngine (per-slot positions, admit-time plan re-resolve)
  plans      — PlanBinding: scoped plan application + hot-swap digests
  health     — HealthMonitor drift detection + predicted site costs
  telemetry  — SiteTelemetry ring buffer (the re-tune loop's evidence)

``make_engine`` is the one constructor: pick an engine by ``mode`` and
hand both the same plan surface (``plan=`` pinned TunedPlan, ``repo=``
tolerance-band PlanRepository).  New engines register with
``register_engine``.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, make_serve_step
from repro_torch.serving.plans import DEFAULT_BAND, PlanBinding
from repro_torch.serving.telemetry import SiteTelemetry
from repro_torch.serving.types import Request

__all__ = [
    "ContinuousEngine",
    "DEFAULT_BAND",
    "Engine",
    "PlanBinding",
    "Request",
    "SiteTelemetry",
    "available_engines",
    "make_engine",
    "make_serve_step",
    "register_engine",
]

_ENGINES: Dict[str, Callable] = {}


def register_engine(name: str, *, overwrite: bool = False):
    """Decorator registering an engine constructor under ``mode`` name."""

    def deco(ctor):
        if name in _ENGINES and not overwrite:
            raise ValueError(f"engine mode {name!r} already registered")
        _ENGINES[name] = ctor
        return ctor

    return deco


def available_engines():
    return sorted(_ENGINES)


@register_engine("fixed")
def _fixed(cfg, params, **kw):
    return Engine(cfg, params, **kw)


@register_engine("continuous")
def _continuous(cfg, params, **kw):
    return ContinuousEngine(cfg, params, **kw)


def make_engine(cfg, params, *, mode: str = "fixed", **kw):
    """Build a serving engine.

    ``mode`` — "fixed" (lockstep Engine; needs ``batch_size=``) or
    "continuous" (ContinuousEngine; needs ``slots=``).  Both take
    ``max_seq=``, ``backend=`` ("ref" or "cuda" kernels; by default the
    tensors' device decides) and the plan surface: ``plan=`` / ``repo=`` /
    ``plan_hardware=`` (default ``"h100-sxm"``) / ``plan_parallel=`` /
    ``plan_band=`` / ``mesh=``, the fault-aware lifecycle
    (``fault_schedule=`` / ``health_window=`` / ``health_tolerance=``) and
    the online re-tune loop (``retune=`` — ``True``, a dict of
    ``core.retune.RetuneService`` kwargs, or a pre-built service).
    """
    try:
        ctor = _ENGINES[mode]
    except KeyError:
        avail = available_engines()
        raise KeyError(f"unknown engine mode {mode!r}; available: {avail}") from None
    return ctor(cfg, params, **kw)
