"""CUDA RWKV6 WKV scan: the port of ``repro.kernels.wkv6.wkv6_pallas``.

The kernel is ``csrc/wkv6.cu``; its plain versions are ``ref.wkv6_ref``
(the step-by-step oracle) and ``ref.wkv6_chunked_ref`` (the chunked
algorithm the kernel computes).  Callers go through ``kernels.ops.wkv6``,
which picks by the tensor's device and counts launches.  Unlike the TPU
kernel it takes any S: rows past S count as absent (decay 1, k = 0), which
leaves the state as the reference's zero padding leaves it, so decode's
S = 1 runs the kernel too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 32                          # rows per chunk, fixed in csrc/wkv6.cu
DTYPES = (torch.float32, torch.bfloat16)    # instantiated
DIMS = (16, 32, 64, 128)            # key dim K and value dim V instantiated


def wkv6_cuda(r, k, v, w_log, u, state=None, *, chunk: int = CHUNK):
    """r, k (B,S,H,K) and v (B,S,H,V) in fp32 or bf16; w_log
    (B,S,H,K), u (H,K) and state (B,H,K,V) in any float type (read as fp32);
    on the card.  Returns y (B,S,H,V) in v's dtype and the final state
    (B,H,K,V) in fp32."""
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
    if state is not None and (state.shape != (B, H, K, V) or not state.is_cuda):
        raise ValueError(f"state must be a CUDA tensor of shape {(B, H, K, V)}")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"wkv6_cuda takes key dim K and value dim V in {DIMS}, "
                         f"got K={K}, V={V}")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("wkv6_cuda needs contiguous r, k and v")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w_log)):
        raise RuntimeError("wkv6_cuda is forward-only; it has no backward")
    wf, uf = w_log.float().contiguous(), u.float().contiguous()
    s0 = None if state is None else state.float().contiguous()
    y = torch.empty_like(v)
    sf = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _build.library()
    rc = lib.rt_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), wf.data_ptr(), uf.data_ptr(),
                     0 if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
                     B, S, H, K, V, _build.DTYPES[r.dtype], _build.stream_of(r))
    _build.check(lib, rc, "wkv6 kernel")
    return y, sf
