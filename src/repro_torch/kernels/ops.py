"""Kernel dispatch for the port, with a launch counter per kernel.

``backend``:
  * ``"ref"``     — the plain PyTorch version (``kernels.ref``), on any
                    device; for the scans, the step-by-step oracle;
  * ``"chunked"`` — the scans only: the chunked plain version, on any device,
                    padded to a chunk multiple as the reference pads;
  * ``"cuda"``    — the hand-written CUDA kernel; needs CUDA tensors.
  * ``None``      — ``"cuda"`` for CUDA tensors; for CPU tensors ``"ref"``,
                    and for the scans at S > 1 ``"chunked"``, as the
                    reference's default backend does.

On the card a scan takes its kernel at every S, decode's S = 1 included:
the reference's S == 1 route to the step oracle applies to CPU tensors
only, and the kernels take any S (rows past S count as absent), so
nothing is padded.

Training: with grad enabled and an input that needs a gradient, RMSNorm,
flash attention and the SSD scan on CUDA tensors go through
``RMSNormFn``, ``FlashAttentionFn`` and ``SSDFn``, whose backward launches
the backward kernels (``rmsnorm_bwd``, ``flash_attention_bwd`` and
``ssd_bwd``); the plain versions are differentiated by autograd, the
chunked SSD on CPU tensors included.  ``SSDFn`` takes no ``out_state``
(a state written in place breaks autograd) and, as its backward kernel,
fp32 and the (P, N) that ``kernels.ssd.BWD_DIMS`` lists, raising before
any launch otherwise.  WKV6 is still forward-only on the card: its kernels
refuse inputs that need a gradient.

Fake tensors (``torch._subclasses.fake_tensor.FakeTensor``, the dry run's,
``launch.dryrun``) take a route of their own, keyed on that type alone and
whatever their device: each kernel's call returns empty outputs of the
kernel's shapes and dtypes (lse and the scans' states included), with no
launch and no build, and adds the call's operations (``kernels.work``) to
``FAKE_FLOPS``.  Under grad the route runs through ``RMSNormFn``,
``FlashAttentionFn`` and ``SSDFn`` as the card's does, so the dry run saves
for the backward what the card saves.  It is not a fallback: a real CUDA tensor
launches the kernel, and a CPU tensor takes the plain version.

There is no fallback: ``"cuda"`` on a CPU tensor raises, and a build or
launch error on the card propagates.  ``LAUNCHES`` counts the launches of
each kernel, one per call that takes the ``"cuda"`` route (a remat
recompute is a call), and one per backward pass, so a run can show that it
went through the kernels (``chip_smoke.py`` reads it).
``LAUNCHES_BY_SHAPE`` counts the launches of RMSNorm and flash attention,
forward and backward, again by shape class (``shape_class``), so a run can
say which of a kernel's shapes its launches were.
"""
from __future__ import annotations

import collections
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref, work as _work
from repro_torch.kernels.flash import (check_window_alibi, flash_attention_bwd_cuda,
                                      flash_attention_cuda)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd import check_bwd as check_ssd_bwd, n_chunks, ssd_bwd_cuda, ssd_cuda
from repro_torch.kernels.wkv6 import wkv6_cuda

BACKENDS = ("ref", "cuda")
SCAN_BACKENDS = ("ref", "chunked", "cuda")
LAUNCHES = {"rmsnorm": 0, "flash_attention": 0, "ssd": 0, "wkv6": 0, "rmsnorm_bwd": 0,
            "flash_attention_bwd": 0, "ssd_bwd": 0}


LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()


FAKE_FLOPS = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_SHAPE.clear()


def shape_class(name: str, x: torch.Tensor, k: Optional[torch.Tensor] = None,
                causal: bool = True) -> str:
    """The key under which ``LAUNCHES_BY_SHAPE`` counts a launch of kernel
    ``name`` (forward or backward) on ``x`` (RMSNorm: its last dim D) or on
    q = ``x`` and ``k`` (flash: the head width, causal or full, a single
    query or not, and whether the keys are as many as the queries)."""
    if k is None:
        return f"{name} D={x.shape[-1]}"
    Sq, Sk = x.shape[1], k.shape[1]
    return (f"{name} h={x.shape[-1]} {'causal' if causal else 'full'} "
            f"{'Sq=1' if Sq == 1 else 'Sq>1'} {'Sk=Sq' if Sk == Sq else 'Sk!=Sq'}")


def _launched(name: str, x: torch.Tensor, k: Optional[torch.Tensor] = None,
              causal: bool = True) -> None:
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[shape_class(name, x, k, causal)] += 1


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``FakeTensor`` (never true before the fake tensor
    module is imported, which ``import repro_torch`` does not do)."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and isinstance(x, mod.FakeTensor)


def _backend(x: torch.Tensor, backend: Optional[str], known=BACKENDS) -> str:
    if is_fake(x):
        return "fake"
    if backend is None:
        return "cuda" if x.is_cuda else "ref"
    if backend not in known:
        raise ValueError(f"unknown backend {backend!r}; known: {known}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"backend 'cuda' needs a CUDA tensor, got one on {x.device}")
    return backend


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm through the CUDA kernels: ``rt_rmsnorm`` forward,
    ``rt_rmsnorm_bwd`` backward (rstd recomputed from the saved x)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y = _rmsnorm_kernel(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if is_fake(x):
            FAKE_FLOPS["rmsnorm_bwd"] += _work.rmsnorm_bwd_flops(x.numel() // x.shape[-1],
                                                                 x.shape[-1])
            return torch.empty_like(x), torch.empty_like(scale), None
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, eps=ctx.eps)
        _launched("rmsnorm_bwd", x)
        return dx, dscale, None


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention through the CUDA kernels: the forward writes each
    row's log-sum-exp beside o; the backward recomputes P from q, k, lse,
    the window and the ALiBi slopes and launches ``csrc/flash_bwd.cu``.
    What the kernels do not take (ALiBi in bf16 or fp16) raises
    ``ValueError`` before any launch (never a quiet route to the plain
    version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0, alibi_slopes=None):
        check_window_alibi(q, window, alibi_slopes)
        o, lse = _flash_kernel(q, k, v, causal, window, alibi_slopes, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.alibi_slopes = causal, window, alibi_slopes
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if is_fake(q):
            B, Sq, Hq, h = q.shape
            FAKE_FLOPS["flash_attention_bwd"] += _work.flash_bwd_flops(
                B, Sq, k.shape[1], Hq, h, causal=ctx.causal, window=ctx.window)
            return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None, None, None
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=ctx.causal,
                                              window=ctx.window,
                                              alibi_slopes=ctx.alibi_slopes)
        _launched("flash_attention_bwd", q, k, ctx.causal)
        return dq, dk, dv, None, None, None


class SSDFn(torch.autograd.Function):
    """The SSD scan through the CUDA kernels: ``rt_ssd`` forward, which also
    writes each chunk's start state, and ``rt_ssd_bwd`` backward from those
    states (``csrc/ssd_bwd.cu``).  The initial state's gradient and the
    final state's are the two ends of the backward's reverse walk over dh,
    so both come at no cost.  Returns (y, final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, state, chunk):
        check_ssd_bwd(x, Bm)                  # what the backward refuses, before any launch
        y, st, hc = _ssd_kernel(x, dt, A, Bm, Cm, D, state, chunk=chunk, save_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, hc)
        ctx.has_state, ctx.chunk = state is not None, chunk
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, D, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if is_fake(x):
            B, S, H, P = x.shape
            FAKE_FLOPS["ssd_bwd"] += _work.ssd_bwd_flops(B, S, H, P, Bm.shape[-1])
            ds0 = hc.new_empty((B, H, P, Bm.shape[-1])) if ctx.has_state else None
            return (*(torch.empty_like(t) for t in (x, dt, A, Bm, Cm, D)), ds0, None)
        dx, ddt, dA, dB, dC, dD, ds0 = ssd_bwd_cuda(x, dt, A, Bm, Cm, D, hc, dy.contiguous(),
                                                    dstate, chunk=ctx.chunk)
        LAUNCHES["ssd_bwd"] += 1
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, dD.to(D.dtype),
                ds0 if ctx.has_state else None, None)


def _ssd_kernel(x, dt, A, Bm, Cm, D, state, *, chunk, out_state=None, save_states=False):
    """The forward kernel's call (y and the final state, and with
    ``save_states`` the chunks' start states), or on a fake tensor empty
    outputs of those shapes."""
    if is_fake(x):
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        FAKE_FLOPS["ssd"] += _work.ssd_flops(B, S, H, P, N)
        st = out_state if out_state is not None else torch.empty(
            (B, H, P, N), dtype=torch.float32, device=x.device)
        y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
        if not save_states:
            return y, st
        return y, st, torch.empty((B, H, n_chunks(S), P, N), dtype=torch.float32,
                                  device=x.device)
    out = ssd_cuda(x, dt, A, Bm, Cm, D, state, out_state=out_state, chunk=chunk,
                   save_states=save_states)
    LAUNCHES["ssd"] += 1
    return out


def _rmsnorm_kernel(x, scale, eps):
    """The forward kernel's call, or on a fake tensor its empty output."""
    if is_fake(x):
        FAKE_FLOPS["rmsnorm"] += _work.rmsnorm_flops(x.numel() // x.shape[-1], x.shape[-1])
        return torch.empty_like(x)
    y = rmsnorm_cuda(x, scale, eps=eps)
    _launched("rmsnorm", x)
    return y


def _flash_kernel(q, k, v, causal, window, alibi_slopes, *, with_lse=False):
    """The forward kernel's call (o, and lse (B, Hq, Sq) fp32 with
    ``with_lse``), or on a fake tensor empty outputs of those shapes."""
    if is_fake(q):
        check_window_alibi(q, window, alibi_slopes)     # what the card refuses
        B, Sq, Hq, h = q.shape
        FAKE_FLOPS["flash_attention"] += _work.flash_flops(B, Sq, k.shape[1], Hq, h,
                                                           causal=causal, window=window)
        o = torch.empty_like(q)
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        return (o, lse) if with_lse else o
    out = flash_attention_cuda(q, k, v, causal=causal, with_lse=with_lse, window=window,
                               alibi_slopes=alibi_slopes)
    _launched("flash_attention", q, k, causal)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, backend: Optional[str] = None,
            eps: float = 1e-5) -> torch.Tensor:
    if _backend(x, backend) == "ref":
        return _ref.rmsnorm_ref(x, scale, eps)
    if _needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _rmsnorm_kernel(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: Optional[str] = None, window: int = 0,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) -> (B,Sq,Hq,h).  ``window`` > 0 and
    ``alibi_slopes`` (Hq,) fp32 as in ``ref.flash_attention_ref``."""
    if _backend(q, backend) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        alibi_slopes=alibi_slopes)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, alibi_slopes)
    return _flash_kernel(q, k, v, causal, window, alibi_slopes)


def _scan_backend(x: torch.Tensor, backend: Optional[str]) -> str:
    b = _backend(x, backend, SCAN_BACKENDS)
    if b in ("cuda", "fake"):
        return b
    if x.shape[1] == 1:            # the plain route decodes with the step oracle
        return "ref"
    return "chunked" if backend is None else b


def _pad_seq(a: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad axis 1 up to a multiple of ``mult`` (the reference's _pad_seq)."""
    pad = (-a.shape[1]) % mult
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) if pad else a


def wkv6(r, k, v, w_log, u, state=None, *, backend: Optional[str] = None, chunk: int = 32,
         out_state: Optional[torch.Tensor] = None):
    """RWKV6 WKV.  r, k, w_log (B,S,H,K), v (B,S,H,V); u (H,K); state
    (B,H,K,V) fp32 or None -> y (B,S,H,V), final state (B,H,K,V) fp32.
    w_log ≤ 0.  With ``out_state`` the final state is written there, which
    may be ``state`` itself, and returned."""
    b = _scan_backend(r, backend)
    if b == "fake":
        B, S, H, K = r.shape
        FAKE_FLOPS["wkv6"] += _work.wkv6_flops(B, S, H, K, v.shape[-1])
        st = out_state if out_state is not None else torch.empty(
            (B, H, K, v.shape[-1]), dtype=torch.float32, device=r.device)
        return torch.empty_like(v), st
    if b == "cuda":
        y, st = wkv6_cuda(r, k, v, w_log, u, state, out_state=out_state, chunk=chunk)
        LAUNCHES["wkv6"] += 1
        return y, st
    if b == "ref":
        y, st = _ref.wkv6_ref(r, k, v, w_log, u, state)
    else:
        S = r.shape[1]
        y, st = _ref.wkv6_chunked_ref(*(_pad_seq(a, chunk) for a in (r, k, v, w_log)), u,
                                      state, chunk=chunk)
        y = y[:, :S]
    if out_state is not None:
        st = out_state.copy_(st)
    return y, st


def ssd(x, dt, A, Bm, Cm, D, state=None, *, backend: Optional[str] = None, chunk: int = 64,
        out_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD.  x (B,S,H,P); dt (B,S,H); A, D (H,); Bm, Cm (B,S,G,N) with
    G dividing H (head h reads group h // (H // G); G = H is the reference's
    head-expanded layout); state (B,H,P,N) fp32 or None -> y (B,S,H,P),
    final state (B,H,P,N) fp32.  x, Bm and Cm may be strided views (the
    kernel reads them in place).  With ``out_state`` the final state is
    written there, which may be ``state`` itself, and returned.  Under grad
    (an input that needs a gradient) CUDA tensors take ``SSDFn``, which
    takes no ``out_state``."""
    b = _scan_backend(x, backend)
    if b in ("cuda", "fake"):
        if _needs_grad(*(t for t in (x, dt, A, Bm, Cm, D, state) if t is not None)):
            if out_state is not None:
                raise ValueError("ops.ssd under grad takes no out_state: a state written in "
                                 "place breaks autograd")
            return SSDFn.apply(x, dt, A, Bm, Cm, D, state, chunk)
        return _ssd_kernel(x, dt, A, Bm, Cm, D, state, chunk=chunk, out_state=out_state)
    H, G = x.shape[2], Bm.shape[2]
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    if G != H:                     # the plain versions take head-expanded B and C
        Bm, Cm = (a.repeat_interleave(H // G, dim=2) for a in (Bm, Cm))
    if b == "ref":
        y, st = _ref.ssd_ref(x, dt, A, Bm, Cm, D, state)
    else:
        S = x.shape[1]
        xp, dtp, Bp, Cp = (_pad_seq(a, chunk) for a in (x, dt, Bm, Cm))
        y, st = _ref.ssd_chunked_ref(xp, dtp, A, Bp, Cp, D, state, chunk=chunk)
        y = y[:, :S]
    if out_state is not None:
        st = out_state.copy_(st)
    return y, st
