"""CUDA Mamba-2 SSD scan: the port of ``repro.kernels.ssd.ssd_pallas``, and
its backward.

The forward kernels are in ``csrc/ssd.cu``: a chunked one on the tensor
cores for S > 1 and a streaming decode step for S == 1.  Their plain
versions are ``ref.ssd_ref`` (the step-by-step oracle) and
``ref.ssd_chunked_ref`` (the chunked algorithm).  Callers go through
``kernels.ops.ssd``, which picks by the tensor's device and counts
launches.  Unlike the TPU kernel it takes any S (rows past S count as
absent, dt = 0), B and C per group rather than expanded to the heads, and
x, B and C as strided views, so the Mamba2 block passes slices of its conv
output with no copy.

The backward (``ssd_bwd_cuda``, ``csrc/ssd_bwd.cu``; the TPU side has none:
the reference trains through ``jax.grad`` of its jnp scans) reads the
chunks' start states that ``ssd_cuda(..., save_states=True)`` writes; its
plain version is ``ref.ssd_chunked_bwd_ref``.  It is fp32 only and built
for the (P, N) of zamba2-7b and of its smoke config (``BWD_DIMS``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

CHUNK = 64                          # rows per chunk, fixed in csrc/ssd.cu
DTYPES = (torch.float32, torch.bfloat16)    # instantiated
DIMS = (16, 32, 64, 128)            # head dim P and state dim N instantiated
BWD_DIMS = ((64, 64), (128, 16))    # (P, N) of the backward: zamba2-7b, its smoke config


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


def _check_inputs(x, dt, A, Bm, Cm, D, chunk: int):
    """The checks both directions make of the forward's inputs; returns
    (B, S, H, P, G, N) and the views' strides."""
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
    return (B, S, H, P, G, N), strides


def check_bwd(x, Bm) -> None:
    """What the backward kernel takes beyond the forward: fp32, and (P, N)
    in ``BWD_DIMS``.  Raises before any launch."""
    if x.dtype != torch.float32 or Bm.dtype != torch.float32:
        raise TypeError(f"the SSD backward kernel is fp32 only, got {x.dtype} (other "
                        f"dtypes: ROADMAP.md queue 2 item 3)")
    P, N = x.shape[-1], Bm.shape[-1]
    if (P, N) not in BWD_DIMS:
        raise ValueError(f"the SSD backward kernel takes (P, N) in {BWD_DIMS}, got "
                         f"({P}, {N})")


def n_chunks(S: int) -> int:
    return -(-S // CHUNK)


def ssd_cuda(x, dt, A, Bm, Cm, D, state=None, *, out_state=None, chunk: int = CHUNK,
             save_states: bool = False):
    """x (B,S,H,P) and Bm, Cm (B,S,G,N), G dividing H (head h reads group
    h // (H // G)), in fp32 or bf16, each a view with a contiguous last dim
    and packed heads; dt (B,S,H), A, D (H,) and state (B,H,P,N) in any float
    type (read as fp32); on the card.  The final state is written to
    ``out_state`` (B,H,P,N) fp32 contiguous, which may be ``state`` itself,
    or to a new tensor.  Returns y (B,S,H,P) in x's dtype and the final
    state; with ``save_states`` also each chunk's start state (B, H,
    ceil(S/64), P, N) fp32, what ``ssd_bwd_cuda`` reads."""
    (B, S, H, P, G, N), strides = _check_inputs(x, dt, A, Bm, Cm, D, chunk)
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
    hc = None
    if save_states:
        hc = torch.empty((B, H, n_chunks(S), P, N), dtype=torch.float32, device=x.device)
        if S == 1:              # the decode kernel writes none: the one chunk starts at s0
            hc.copy_(s0.unsqueeze(2) if s0 is not None else torch.zeros_like(hc))
    lib = _build.library()
    rc = lib.rt_ssd(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), f32[2].data_ptr(), 0 if s0 is None else s0.data_ptr(),
                    y.data_ptr(), out_state.data_ptr(),
                    0 if hc is None or S == 1 else hc.data_ptr(), B, S, H, G, P, N,
                    *strides, _build.DTYPES[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "ssd kernel")
    return (y, out_state, hc) if save_states else (y, out_state)


def ssd_bwd_cuda(x, dt, A, Bm, Cm, D, states, dy, dstate_end=None, *, chunk: int = CHUNK):
    """The backward of ``ssd_cuda``: x, dt, A, Bm, Cm, D as the forward took
    them (fp32; the same views, checked as the forward checks them);
    ``states`` the chunks' start states that ``ssd_cuda(...,
    save_states=True)`` returned; dy (B,S,H,P) the gradient of y; dstate_end
    (B,H,P,N) that of the final state, or None (zeros).  Returns (dx, ddt,
    dA, dBm, dCm, dD, dstate0): dx (B,S,H,P), ddt (B,S,H), dA, dD (H,), dBm,
    dCm (B,S,G,N), dstate0 (B,H,P,N), all fp32 and contiguous.  dB and dC
    come from per-head partials summed over each group's heads in order,
    dA and dD from (B, H) partials summed over the batch."""
    (B, S, H, P, G, N), strides = _check_inputs(x, dt, A, Bm, Cm, D, chunk)
    check_bwd(x, Bm)
    shape = (B, H, P, N)
    if (states.shape != (B, H, n_chunks(S), P, N) or states.dtype != torch.float32
            or not states.is_cuda or not states.is_contiguous()):
        raise ValueError(f"states must be the forward's contiguous fp32 chunk states of "
                         f"shape {(B, H, n_chunks(S), P, N)}, got {tuple(states.shape)}")
    if dy.shape != (B, S, H, P) or not dy.is_cuda:
        raise ValueError(f"dy must be a CUDA tensor of shape {(B, S, H, P)}")
    dse = None
    if dstate_end is not None:
        if dstate_end.shape != shape or not dstate_end.is_cuda:
            raise ValueError(f"dstate_end must be a CUDA tensor of shape {shape}")
        dse = dstate_end.float().contiguous()
    f32 = [t.float().contiguous() for t in (dt, A, D, dy)]
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((B, S, G, N), dtype=torch.float32, device=dev) for _ in range(2))
    parts = [torch.empty((B, S, H, N), dtype=torch.float32, device=dev) if G != H else None
             for _ in range(2)]
    dAp, dDp = (torch.empty((B, H), dtype=torch.float32, device=dev) for _ in range(2))
    ds0 = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _build.library()
    rc = lib.rt_ssd_bwd(x.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), Bm.data_ptr(),
                        Cm.data_ptr(), f32[2].data_ptr(), states.data_ptr(),
                        f32[3].data_ptr(), 0 if dse is None else dse.data_ptr(),
                        dx.data_ptr(), ddt.data_ptr(),
                        *(0 if t is None else t.data_ptr() for t in parts),
                        dB.data_ptr(), dC.data_ptr(), dAp.data_ptr(), dDp.data_ptr(),
                        ds0.data_ptr(), B, S, H, G, P, N, *strides,
                        _build.DTYPES[x.dtype], _build.stream_of(x))
    _build.check(lib, rc, "ssd backward kernel")
    return dx, ddt, dAp.sum(0), dB, dC, dDp.sum(0), ds0
