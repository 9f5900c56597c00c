"""CUDA RMSNorm: the port of ``repro.kernels.rmsnorm.rmsnorm_pallas``.

The kernel is ``csrc/rmsnorm.cu``; its plain version is
``ref.rmsnorm_ref``.  Callers go through ``kernels.ops.rmsnorm``, which
picks between the two by the tensor's device and counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """y = x · rsqrt(mean(x²) + eps) · scale over the last dim, on the card.
    x (..., D) in fp32, bf16 or fp16; scale (D,) in fp32 or x's dtype."""
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
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("rmsnorm_cuda is forward-only; it has no backward")
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
