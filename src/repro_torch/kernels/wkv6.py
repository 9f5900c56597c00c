"""CUDA RWKV6 WKV scan: the port of ``repro.kernels.wkv6.wkv6_pallas``.

Two kernels: ``csrc/wkv6.cu``, chunked, for S > 1, and ``csrc/wkv6_step.cu``,
a streaming decode step, for S == 1.  Their plain versions are
``ref.wkv6_ref`` (the step-by-step oracle), ``ref.wkv6_chunked_ref`` (the
TPU kernel's chunked algorithm) and ``ref.wkv6_subchunked_ref`` (the chunked
CUDA kernel's sub-chunk-factored algorithm).  Callers go through
``kernels.ops.wkv6``, which picks by the tensor's device and counts
launches.  Unlike the TPU kernel it takes any S: rows past S count as
absent (decay 1, k = 0), which leaves the state as the reference's zero
padding leaves it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 32                          # rows per chunk, fixed in csrc/wkv6.cu
DTYPES = (torch.float32, torch.bfloat16)    # instantiated
DIMS = (16, 32, 64, 128)            # key dim K and value dim V instantiated


def wkv6_cuda(r, k, v, w_log, u, state=None, *, out_state=None, chunk: int = CHUNK):
    """r, k (B,S,H,K) and v (B,S,H,V) in fp32 or bf16, contiguous; w_log
    (B,S,H,K) ≤ 0, u (H,K) and state (B,H,K,V) in any float type (read as
    fp32); on the card.  The kernels take w_log ≤ 0 (a decay of at most 1,
    as the model's −exp(·) gives): every exponential they take is then of a
    number ≤ 0.  The final state is written to ``out_state`` (B,H,K,V) fp32
    contiguous, which may be ``state`` itself, or to a new tensor.  Returns
    y (B,S,H,V) in v's dtype and the final state.  S == 1 runs the decode
    step, S > 1 the chunked kernel."""
    if chunk != CHUNK:
        raise ValueError(f"wkv6_cuda runs chunks of {CHUNK} rows, not {chunk}")
    if not all(t.is_cuda for t in (r, k, v, w_log, u)):
        raise ValueError("wkv6_cuda needs CUDA tensors")
    if r.dtype not in DTYPES or not (r.dtype == k.dtype == v.dtype):
        raise TypeError(f"wkv6_cuda takes fp32 or bf16 for r, k and v, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B,S,H,K), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    V = v.shape[-1]
    if (k.shape != r.shape or w_log.shape != r.shape or v.shape != (B, S, H, V)
            or u.shape != (H, K)):
        raise ValueError(f"bad shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} w_log {tuple(w_log.shape)} u {tuple(u.shape)}")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"wkv6_cuda takes key dim K and value dim V in {DIMS}, "
                         f"got K={K}, V={V}")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("wkv6_cuda needs contiguous r, k and v")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                         for t in (r, k, v, w_log, u, state)):
        raise RuntimeError("wkv6_cuda is forward-only; it has no backward")
    shape = (B, H, K, V)
    s0 = None
    if state is not None:
        if state.shape != shape or not state.is_cuda:
            raise ValueError(f"state must be a CUDA tensor of shape {shape}")
        s0 = state.float().contiguous()
    if out_state is None:
        out_state = torch.empty(shape, dtype=torch.float32, device=r.device)
    elif (out_state.shape != shape or out_state.dtype != torch.float32
          or not out_state.is_cuda or not out_state.is_contiguous()):
        raise ValueError(f"out_state must be a contiguous fp32 CUDA tensor of shape {shape}")
    wf, uf = w_log.float().contiguous(), u.float().contiguous()
    if any(t is not None and t.data_ptr() % 16 for t in (r, k, v, wf, s0, out_state)):
        raise ValueError("wkv6_cuda needs r, k, v, w_log, state and out_state 16-byte "
                         "aligned (the kernels move rows in 16-byte pieces)")
    y = torch.empty_like(v)
    lib = _build.library()
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), wf.data_ptr(), uf.data_ptr(),
            0 if s0 is None else s0.data_ptr(), y.data_ptr(), out_state.data_ptr())
    if S == 1:
        rc = lib.rt_wkv6_step(*args, B, H, K, V, _build.DTYPES[r.dtype], _build.stream_of(r))
        _build.check(lib, rc, "wkv6 step kernel")
    else:
        rc = lib.rt_wkv6(*args, B, S, H, K, V, _build.DTYPES[r.dtype], _build.stream_of(r))
        _build.check(lib, rc, "wkv6 kernel")
    return y, out_state
