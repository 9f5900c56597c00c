"""CUDA Mamba-2 SSD scan: the port of ``repro.kernels.ssd.ssd_pallas``.

The kernel is ``csrc/ssd.cu``; its plain versions are ``ref.ssd_ref`` (the
step-by-step oracle) and ``ref.ssd_chunked_ref`` (the chunked algorithm
the kernel computes).  Callers go through ``kernels.ops.ssd``, which picks
by the tensor's device and counts launches.  Unlike the TPU kernel it takes
any S: rows past S count as absent (dt = 0), which leaves the state as the
reference's zero padding leaves it, so decode's S = 1 runs the kernel too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 64                          # rows per chunk, fixed in csrc/ssd.cu
DTYPES = (torch.float32, torch.bfloat16)    # instantiated
DIMS = (16, 32, 64, 128)            # head dim P and state dim N instantiated


def ssd_cuda(x, dt, A, Bm, Cm, D, state=None, *, chunk: int = CHUNK):
    """x (B,S,H,P) and Bm, Cm (B,S,H,N) in fp32 or bf16; dt (B,S,H),
    A, D (H,) and state (B,H,P,N) in any float type (read as fp32); on the
    card.  Returns y (B,S,H,P) in x's dtype and the final state (B,H,P,N)
    in fp32."""
    if chunk != CHUNK:
        raise ValueError(f"ssd_cuda runs chunks of {CHUNK} rows, not {chunk}")
    if not all(t.is_cuda for t in (x, dt, A, Bm, Cm, D)):
        raise ValueError("ssd_cuda needs CUDA tensors")
    if x.dtype not in DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_cuda takes fp32 or bf16 for x, Bm and Cm, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (Bm.shape != (B, S, H, N) or Cm.shape != Bm.shape or dt.shape != (B, S, H)
            or A.shape != (H,) or D.shape != (H,)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
                         f"D {tuple(D.shape)}")
    if state is not None and (state.shape != (B, H, P, N) or not state.is_cuda):
        raise ValueError(f"state must be a CUDA tensor of shape {(B, H, P, N)}")
    if P not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_cuda takes head dim P and state dim N in {DIMS}, "
                         f"got P={P}, N={N}")
    if not (x.is_contiguous() and Bm.is_contiguous() and Cm.is_contiguous()):
        raise ValueError("ssd_cuda needs contiguous x, Bm and Cm")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, Bm, Cm)):
        raise RuntimeError("ssd_cuda is forward-only; it has no backward")
    f32 = [t.float().contiguous() for t in (dt, A, D)]
    s0 = None if state is None else state.float().contiguous()
    y = torch.empty_like(x)
    sf = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    rc = lib.rt_ssd(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), f32[2].data_ptr(), 0 if s0 is None else s0.data_ptr(),
                    y.data_ptr(), sf.data_ptr(), B, S, H, P, N,
                    _build.DTYPES[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "ssd kernel")
    return y, sf
