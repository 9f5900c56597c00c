"""Kernel dispatch for the port, with a launch counter per kernel.

``backend``:
  * ``"ref"``  — the plain PyTorch version (``kernels.ref``), on any device;
  * ``"cuda"`` — the hand-written CUDA kernel; needs CUDA tensors.
  * ``None``   — ``"cuda"`` for CUDA tensors, ``"ref"`` for CPU tensors.

There is no fallback: ``"cuda"`` on a CPU tensor raises, and a build or
launch error on the card propagates.  ``LAUNCHES`` counts the launches of
each kernel, one per call that takes the ``"cuda"`` route, so a run can
show that it went through the kernels (``chip_smoke.py`` reads it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

BACKENDS = ("ref", "cuda")
LAUNCHES = {"rmsnorm": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _backend(x: torch.Tensor, backend: Optional[str]) -> str:
    if backend is None:
        return "cuda" if x.is_cuda else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"backend 'cuda' needs a CUDA tensor, got one on {x.device}")
    return backend


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, backend: Optional[str] = None,
            eps: float = 1e-5) -> torch.Tensor:
    if _backend(x, backend) == "ref":
        return _ref.rmsnorm_ref(x, scale, eps)
    y = rmsnorm_cuda(x, scale, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: Optional[str] = None) -> torch.Tensor:
    """q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) -> (B,Sq,Hq,h)."""
    if _backend(q, backend) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    o = flash_attention_cuda(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return o
