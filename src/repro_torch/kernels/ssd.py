"""CUDA Mamba-2 SSD scan: the port of ``repro.kernels.ssd.ssd_pallas``.

The kernels are in ``csrc/ssd.cu``: a chunked one on the tensor cores for
S > 1 and a streaming decode step for S == 1.  Their plain versions are
``ref.ssd_ref`` (the step-by-step oracle) and ``ref.ssd_chunked_ref`` (the
chunked algorithm).  Callers go through ``kernels.ops.ssd``, which picks by
the tensor's device and counts launches.  Unlike the TPU kernel it takes any
S (rows past S count as absent, dt = 0), B and C per group rather than
expanded to the heads, and x, B and C as strided views, so the Mamba2 block
passes slices of its conv output with no copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 64                          # rows per chunk, fixed in csrc/ssd.cu
DTYPES = (torch.float32, torch.bfloat16)    # instantiated
DIMS = (16, 32, 64, 128)            # head dim P and state dim N instantiated


def _view_strides(t: torch.Tensor, name: str):
    """The batch and position strides of t (B, S, heads, d), which the
    kernels read from a base pointer with these two strides: the last dim
    contiguous, the heads packed, and, for fp32, base and strides in whole
    16-byte pieces (cp.async)."""
    B, S, heads, d = t.shape
    sb, ss, sh, sd = t.stride()
    if (d > 1 and sd != 1) or (heads > 1 and sh != d):
        raise ValueError(f"ssd_cuda needs {name} with a contiguous last dim and packed "
                         f"heads, got shape {tuple(t.shape)} strides {t.stride()}")
    if t.dtype == torch.float32 and (t.data_ptr() % 16 or (B > 1 and sb % 4)
                                     or (S > 1 and ss % 4)):
        raise ValueError(f"ssd_cuda needs fp32 {name} 16-byte aligned, with batch and "
                         f"position strides in multiples of 4 elements (the kernel "
                         f"copies rows in 16-byte pieces); got strides {t.stride()}")
    return sb, ss


def ssd_cuda(x, dt, A, Bm, Cm, D, state=None, *, out_state=None, chunk: int = CHUNK):
    """x (B,S,H,P) and Bm, Cm (B,S,G,N), G dividing H (head h reads group
    h // (H // G)), in fp32 or bf16, each a view with a contiguous last dim
    and packed heads; dt (B,S,H), A, D (H,) and state (B,H,P,N) in any float
    type (read as fp32); on the card.  The final state is written to
    ``out_state`` (B,H,P,N) fp32 contiguous, which may be ``state`` itself,
    or to a new tensor.  Returns y (B,S,H,P) in x's dtype and the final
    state."""
    if chunk != CHUNK:
        raise ValueError(f"ssd_cuda runs chunks of {CHUNK} rows, not {chunk}")
    if not all(t.is_cuda for t in (x, dt, A, Bm, Cm, D)):
        raise ValueError("ssd_cuda needs CUDA tensors")
    if x.dtype not in DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd_cuda takes fp32 or bf16 for x, Bm and Cm, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P) and Bm (B,S,G,N), got {tuple(x.shape)} "
                         f"and {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    if (Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape or H % G or dt.shape != (B, S, H)
            or A.shape != (H,) or D.shape != (H,)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} Cm {tuple(Cm.shape)} "
                         f"D {tuple(D.shape)}")
    if P not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_cuda takes head dim P and state dim N in {DIMS}, "
                         f"got P={P}, N={N}")
    strides = (*_view_strides(x, "x"), *_view_strides(Bm, "Bm"), *_view_strides(Cm, "Cm"))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                         for t in (x, dt, A, Bm, Cm, D, state)):
        raise RuntimeError("ssd_cuda is forward-only; it has no backward")
    shape = (B, H, P, N)
    s0 = None
    if state is not None:
        if state.shape != shape or not state.is_cuda:
            raise ValueError(f"state must be a CUDA tensor of shape {shape}")
        s0 = state.float().contiguous()
    if out_state is None:
        out_state = torch.empty(shape, dtype=torch.float32, device=x.device)
    elif (out_state.shape != shape or out_state.dtype != torch.float32
          or not out_state.is_cuda or not out_state.is_contiguous()):
        raise ValueError(f"out_state must be a contiguous fp32 CUDA tensor of shape {shape}")
    if (s0 is not None and s0.data_ptr() % 16) or out_state.data_ptr() % 16:
        raise ValueError("ssd_cuda needs state and out_state 16-byte aligned "
                         "(the kernels move state rows in 16-byte pieces)")
    f32 = [t.float().contiguous() for t in (dt, A, D)]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    lib = _build.library()
    rc = lib.rt_ssd(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), f32[2].data_ptr(), 0 if s0 is None else s0.data_ptr(),
                    y.data_ptr(), out_state.data_ptr(), B, S, H, G, P, N, *strides,
                    _build.DTYPES[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "ssd kernel")
    return y, out_state
