"""Serving front door of the port.

  types  — the shared Request dataclass
  engine — fixed-batch lockstep Engine (+ make_serve_step)

``make_engine`` is the one constructor: pick an engine by ``mode``.  Only
``"fixed"`` is registered; the continuous-batching engine arrives with the
port's tensor-parallel serving slice.  New engines register with
``register_engine``.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.serving.engine import Engine, make_serve_step
from repro_torch.serving.types import Request

__all__ = [
    "Engine",
    "Request",
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


def make_engine(cfg, params, *, mode: str = "fixed", **kw):
    """Build a serving engine.  ``mode`` "fixed" (lockstep Engine; needs
    ``batch_size=`` and ``max_seq=``; ``backend=`` picks "ref" or "cuda"
    kernels, by default the tensors' device decides)."""
    try:
        ctor = _ENGINES[mode]
    except KeyError:
        avail = available_engines()
        raise KeyError(f"unknown engine mode {mode!r}; available: {avail}") from None
    return ctor(cfg, params, **kw)
