"""CUDA flash attention: the port of ``repro.kernels.flash.flash_attention``.

The kernel is ``csrc/flash.cu`` (forward, causal or full, GQA, both products
on the tensor cores in the fp32-exact 3xTF32 split); its plain version is
``ref.flash_attention_ref``.  Callers go through
``kernels.ops.flash_attention``, which picks between the two by the
tensor's device and counts launches.  Unlike the TPU kernel it needs no
block-multiple lengths: the kernel masks rows and keys past Sq and Sk.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 112, 128)   # instantiated in csrc/flash.cu


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) with Hq % Hkv == 0; on the card.
    Returns (B,Sq,Hq,h) in q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _build.DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention_cuda takes one of fp32/bf16/fp16 for q, k "
                        f"and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, h = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != h or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not form GQA")
    if h not in HEAD_DIMS:
        raise ValueError(f"head dim {h} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k and v")
    if q.dtype == torch.float32 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs fp32 q, k and v 16-byte aligned "
                         "(the kernel copies fp32 rows in 16-byte pieces)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_cuda is forward-only; it has no backward")
    o = torch.empty_like(q)
    lib = _build.library()
    rc = lib.rt_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                B, Sq, Sk, Hq, Hkv, h, int(causal), 1.0 / math.sqrt(h),
                                _build.DTYPES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash attention kernel")
    return o
