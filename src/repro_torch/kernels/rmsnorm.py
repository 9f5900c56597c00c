"""CUDA RMSNorm: the port of ``repro.kernels.rmsnorm.rmsnorm_pallas``.

The kernels are ``csrc/rmsnorm.cu`` (the forward, and a backward the TPU
kernel does not have); the plain version is ``ref.rmsnorm_ref`` (its
backward is autograd through it).  Callers go through
``kernels.ops.rmsnorm``, which picks between the two by the tensor's
device, wraps the kernels in ``ops.RMSNormFn`` where a gradient is needed,
and counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors, got {x.device} and {scale.device}")
    if x.dtype not in _build.DTYPES or scale.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rmsnorm_cuda takes x in fp32/bf16/fp16 and scale in fp32 "
                        f"or x's dtype, got {x.dtype} and {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and scale")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """y = x · rsqrt(mean(x²) + eps) · scale over the last dim, on the card.
    x (..., D) in fp32, bf16 or fp16; scale (D,) in fp32 or x's dtype.
    Forward only: with grad enabled, an input that needs a gradient is
    refused (``ops.RMSNormFn`` is the route then)."""
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError("rmsnorm_cuda is forward-only; ops.RMSNormFn takes inputs "
                           "that need a gradient")
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    lib = _build.library()
    rc = lib.rt_rmsnorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, D, eps,
                        _build.DTYPES[x.dtype], _build.DTYPES[scale.dtype],
                        _build.stream_of(x))
    _build.check(lib, rc, "rmsnorm kernel")
    return y


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-5):
    """The gradients (dx, dscale) of ``rmsnorm_cuda`` at (x, scale) for the
    output's gradient ``dy``, on the card: dx in x's dtype, dscale in
    scale's.  rstd is recomputed from x; dscale is summed over the rows in
    a fixed order (per-block partials, then a second pass), so it is the
    same on every run."""
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not (dy.is_cuda and dy.is_contiguous()):
        raise ValueError(f"dy must be a contiguous CUDA tensor like x {tuple(x.shape)} "
                         f"{x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    lib = _build.library()
    blocks = lib.rt_rmsnorm_bwd_blocks(rows)
    partial = torch.empty((blocks, D), dtype=torch.float32, device=x.device)
    rc = lib.rt_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                            dscale.data_ptr(), partial.data_ptr(), rows, D, blocks, eps,
                            _build.DTYPES[x.dtype], _build.DTYPES[scale.dtype],
                            _build.stream_of(x))
    _build.check(lib, rc, "rmsnorm backward kernel")
    return dx, dscale
