"""CUDA flash attention: the port of ``repro.kernels.flash.flash_attention``.

The forward kernel is ``csrc/flash.cu`` (causal or full, GQA, an optional
sliding window, optional ALiBi slopes, both products on the tensor cores
in the fp32-exact 3xTF32 split); the backward kernels,
which the TPU kernel does not have, are ``csrc/flash_bwd.cu`` (the same
3xTF32 tensor-core products).  The plain version is
``ref.flash_attention_ref`` (its backward is autograd through it).  Callers
go through ``kernels.ops.flash_attention``, which picks between the two by
the tensor's device, wraps the kernels in ``ops.FlashAttentionFn`` where a
gradient is needed, and counts launches.
Unlike the TPU kernel it needs no block-multiple lengths: the kernels mask
rows and keys past Sq and Sk.  The TPU kernel has neither windows nor ALiBi
(the reference computes them in jnp, ``repro.models.layers.attention``);
both directions take them and every head dim of ``HEAD_DIMS``: a window
at any dtype, ALiBi in fp32 (its instantiations are built for fp32 only,
forward with and without lse, and the backward).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 112, 128)   # instantiated in csrc/flash.cu and flash_bwd.cu


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} needs CUDA tensors")
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, with_lse: bool = False, window: int = 0,
                         alibi_slopes: Optional[torch.Tensor] = None):
    """q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) with Hq % Hkv == 0; on the card.
    Returns o (B,Sq,Hq,h) in q's dtype, and with ``with_lse`` also each
    row's log-sum-exp of its scaled (and biased) scores, lse (B,Hq,Sq)
    fp32, which the backward takes.  ``window`` > 0 masks key kpos from
    row qpos where qpos − kpos >= window; ``alibi_slopes`` (Hq,) fp32 adds
    slope·(kpos − qpos) to each query head's scores (fp32 q only).
    Forward only: with grad enabled, an input that needs a gradient is
    refused (``ops.FlashAttentionFn`` is the route then)."""
    _check(q, k, v, "flash_attention_cuda")
    check_window_alibi(q, window, alibi_slopes)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_cuda is forward-only; ops.FlashAttentionFn "
                           "takes inputs that need a gradient")
    B, Sq, Hq, h = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library()
    rc = lib.rt_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                None if lse is None else lse.data_ptr(),
                                None if alibi_slopes is None else alibi_slopes.data_ptr(),
                                B, Sq, Sk, Hq, Hkv, h, int(causal), int(window),
                                1.0 / math.sqrt(h), _build.DTYPES[q.dtype],
                                _build.stream_of(q))
    _build.check(lib, rc, "flash attention kernel")
    return (o, lse) if with_lse else o


def check_window_alibi(q: torch.Tensor, window: int,
                       alibi_slopes: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` for a window or slopes the kernels do not take:
    a negative window; slopes other than (Hq,) contiguous fp32 on q's
    device, or with a q that is not fp32 (the ALiBi instantiations are
    built for fp32 only)."""
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if alibi_slopes is None:
        return
    if q.dtype != torch.float32:
        raise ValueError(f"the ALiBi kernels are built for fp32 q, k, v only, got {q.dtype}")
    if (alibi_slopes.shape != (q.shape[2],) or alibi_slopes.dtype != torch.float32
            or alibi_slopes.device != q.device or not alibi_slopes.is_contiguous()):
        raise ValueError(f"alibi_slopes must be ({q.shape[2]},) contiguous fp32 on "
                         f"{q.device}, got {tuple(alibi_slopes.shape)} "
                         f"{alibi_slopes.dtype} on {alibi_slopes.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             alibi_slopes: Optional[torch.Tensor] = None):
    """The gradients (dq, dk, dv) of flash attention, in the inputs' dtype,
    from the forward's inputs, its output ``o`` and ``lse``
    (``flash_attention_cuda(..., with_lse=True)`` with the same ``causal``,
    ``window`` and ``alibi_slopes``) and the output's gradient ``do``; on
    the card.  dk and dv are summed over the query heads of each KV head."""
    _check(q, k, v, "flash_attention_bwd_cuda")
    check_window_alibi(q, window, alibi_slopes)
    B, Sq, Hq, h = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {Hq}, {Sq}) fp32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if not all(t.is_cuda and t.is_contiguous() for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd_cuda needs contiguous CUDA o, do and lse")
    if q.dtype == torch.float32 and any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("flash_attention_bwd_cuda needs fp32 o and do 16-byte aligned "
                         "(the kernels copy fp32 rows in 16-byte pieces)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    rc = lib.rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if alibi_slopes is None else alibi_slopes.data_ptr(),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, Hq, Hkv, h,
        int(causal), int(window), 1.0 / math.sqrt(h), _build.DTYPES[q.dtype],
        _build.stream_of(q))
    _build.check(lib, rc, "flash attention backward kernels")
    return dq, dk, dv
