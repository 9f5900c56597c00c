"""Plain PyTorch versions of the port's kernels.

They are the CPU execution path that ``kernels.ops`` takes for CPU tensors
and the oracle each CUDA kernel is held against on the card
(``chip_smoke.py``).  They compute in float32 and return the input dtype,
as ``repro.kernels.ref`` does; the masking constants are the TPU kernel's.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30          # masked score, as in repro/kernels/flash.py
DENOM_FLOOR = 1e-20      # softmax denominator clamp, as in the TPU kernel


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x · rsqrt(mean(x²) + eps) · scale over the last dim, fp32 math."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Dense GQA softmax attention.  q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) with
    Hq % Hkv == 0; query head i reads KV head i // G.  Any Sq, Sk.  The
    causal mask counts both query and key positions from 0, as the TPU
    kernel does.  Returns (B,Sq,Hq,h) in q's dtype."""
    B, Sq, Hq, h = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, h)
    s = torch.einsum("bqngh,bsnh->bngqs", qf, k.float()) * (1.0 / math.sqrt(h))
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngqs,bsnh->bngqh", p, v.float()) / l.clamp_min(DENOM_FLOOR)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, h).to(q.dtype)
