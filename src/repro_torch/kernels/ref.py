"""Plain PyTorch versions of the port's kernels.

They are the CPU execution path that ``kernels.ops`` takes for CPU tensors
and the oracle each CUDA kernel is held against on the card
(``chip_smoke.py``).  They compute in float32 and return the input dtype,
as ``repro.kernels.ref`` does; the masking constants are the TPU kernel's.
The scans have two each: the step-by-step oracle (``*_ref``, a Python
loop over S, in fp64 for fp64 inputs) and the chunked algorithm of the TPU
kernel (``*_chunked_ref``), which CPU tensors take for S > 1; both give
the state in fp32 for fp32 inputs.  WKV6 has a third, the sub-chunked
algorithm of its CUDA kernel (``wkv6_subchunked_ref``), which only the
tests run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30          # masked score, as in repro/kernels/flash.py
DENOM_FLOOR = 1e-20      # softmax denominator clamp, as in the TPU kernel


def _acc(x: torch.Tensor) -> torch.dtype:
    """fp32 math, or fp64 for fp64 inputs (the oracle the fp32 kernels'
    gradients are held against on the card)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """y = x · rsqrt(mean(x²) + eps) · scale over the last dim, fp32 math
    (fp64 for fp64 x)."""
    xf = x.to(_acc(x))
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(xf.dtype)).to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense GQA softmax attention.  q (B,Sq,Hq,h); k,v (B,Sk,Hkv,h) with
    Hq % Hkv == 0; query head i reads KV head i // G.  Any Sq, Sk.  The
    causal mask counts both query and key positions from 0, as the TPU
    kernel does.  ``window`` > 0 also masks key kpos from row qpos where
    qpos − kpos >= window; ``alibi_slopes`` (Hq,) adds slope·(kpos − qpos)
    to query head i's scaled scores with slope i (the reference's
    ``bias_fn``, repro/models/layers.py).  Computes in fp32 (fp64 for fp64
    q).  Returns (B,Sq,Hq,h) in q's dtype."""
    B, Sq, Hq, h = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    acc = _acc(q)
    qf = q.to(acc).reshape(B, Sq, Hkv, G, h)
    s = torch.einsum("bqngh,bsnh->bngqs", qf, k.to(acc)) * (1.0 / math.sqrt(h))
    dist = (torch.arange(Sk, device=q.device)[None, :]
            - torch.arange(Sq, device=q.device)[:, None])          # kpos − qpos
    if alibi_slopes is not None:
        s = s + alibi_slopes.to(acc).view(Hkv, G, 1, 1) * dist.to(acc)
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= dist <= 0
    if window:
        keep &= -dist < window
    if causal or window:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bngqs,bsnh->bngqh", p, v.to(acc)) / l.clamp_min(DENOM_FLOOR)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, h).to(q.dtype)


# ---------------------------------------------------------------------------
# RWKV6 "Finch" WKV: data-dependent per-channel decay
#   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
#   y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
# ---------------------------------------------------------------------------

def _state(state, shape, device, dtype=torch.float32) -> torch.Tensor:
    if state is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return state.to(dtype)


def wkv6_ref(r, k, v, w_log, u, state=None):
    """The step-by-step oracle.  r, k, w_log (B,S,H,K), v (B,S,H,V); u (H,K);
    state (B,H,K,V) or None (zeros).  w_log is the log-decay (≤ 0).  Returns
    y (B,S,H,V) in v's dtype and the final state (B,H,K,V) in the dtype it
    computes in: fp32, or fp64 when v is fp64 (a yardstick for the fp32
    kernels' accuracy)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    acc = torch.float64 if v.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf, uf = (a.to(acc) for a in (r, k, v, w_log, u))
    st = _state(state, (B, H, K, V), r.device, acc)
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]              # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf[None, :, :, None] * kv))
        st = torch.exp(wf[:, t])[..., None] * st + kv
    return torch.stack(ys, dim=1).to(v.dtype), st


def wkv6_chunked_ref(r, k, v, w_log, u, state=None, *, chunk: int = 64):
    """Chunked (matmul-form) WKV, the algorithm of the TPU kernel; S must be
    a multiple of ``chunk``.  Same arguments and results as ``wkv6_ref``."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    Q = chunk
    uf = u.float()
    st = _state(state, (B, H, K, V), r.device)
    # strictly lower-triangular: s < t
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device), -1)
    mask = mask[None, :, :, None, None]
    ys = []
    for c0 in range(0, S, Q):
        rq, kq, vq, wq = (a[:, c0:c0 + Q].float() for a in (r, k, v, w_log))
        cw = torch.cumsum(wq, dim=1) - wq                 # exclusive: Σ_{τ<t} w
        cw_end = wq.sum(dim=1)                            # (B,H,K)
        # inter-chunk: y_t += (r_t ⊙ e^{cw_t}) · S0   (cw_t ≤ 0)
        y = torch.einsum("bqhk,bhkv->bqhv", rq * torch.exp(cw), st)
        # intra-chunk: A[t,s] = Σ_K r_t e^{cw_t − cw_s − w_s} k_s (s < t), and
        # A[t,t] = Σ_K r_t u k_t.  The exponent is masked before exp: for
        # s > t it is positive and exp may overflow.
        dmat = cw[:, :, None] - cw[:, None] - wq[:, None]             # (B,Q,Q,H,K)
        P = torch.where(mask, torch.exp(torch.where(mask, dmat, 0.0)), 0.0)
        A = torch.einsum("bqhk,bshk,bqshk->bhqs", rq, kq, P)
        A_diag = torch.einsum("bqhk,hk,bqhk->bqh", rq, uf, kq)
        y = y + torch.einsum("bhqs,bshv->bqhv", A, vq) + A_diag[..., None] * vq
        # state: S = diag(e^{cw_end}) S0 + Σ_s e^{cw_end − cw_s − w_s} k_s v_sᵀ
        carry_k = kq * torch.exp(cw_end[:, None] - cw - wq)
        st = torch.exp(cw_end)[..., None] * st + torch.einsum("bshk,bshv->bhkv", carry_k, vq)
        ys.append(y)
    return torch.cat(ys, dim=1).to(v.dtype), st


def wkv6_subchunked_ref(r, k, v, w_log, u, state=None, *, chunk: int = 32, sub: int = 8):
    """The algorithm of ``csrc/wkv6.cu``'s chunked kernel: chunks of ``chunk``
    rows cut into sub-chunks of ``sub`` rows, every decay a power of 2 of a
    number ≤ 0 (w_log ≤ 0), so no factor overflows at any decay.  S must be
    a multiple of ``chunk``.  Same arguments and results as ``wkv6_ref``.

    Per channel, with w2 = w_log · log2(e): a row t of sub-chunk i keeps
    q_t = r_t 2^(w2 summed over the rows of i before t), a row s of
    sub-chunk j keeps kk_s = k_s 2^(w2 summed over the rows of j after s),
    and P[a][m] = 2^(the sums of w2 over sub-chunks m .. a−1) (m < a;
    P[a][a] = 1).  Then
      y_t      = (q_t ⊙ P[i][0]) · S0 + Σ_(s ≤ t) A[t][s] v_s
      A[t][s]  = Σ_K q_t P[i][j+1] kk_s                        (j < i)
      A[t][s]  = Σ_K r_t k_s Π_(s < τ < t) 2^(w2_τ)            (s < t, same sub-chunk)
      A[t][t]  = Σ_K r_t u k_t
      S_end    = P[n][0] ⊙ S0 + Σ_s (kk_s ⊙ P[n][j+1]) v_sᵀ    (n = chunk / sub)
    Every exponent is a sum over the rows it spans, never the difference of
    two running sums: after a step of strong decay (w_log of −1000) such a
    difference would keep only its absolute rounding, about 1e-4, which a
    decay of order 1 turns into a relative error of 1e-4.  A factor that
    underflows to 0 stands for a true product below 2^-126."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk or chunk % sub:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}, "
                         f"or the chunk is not a multiple of the sub-chunk {sub}")
    Q, L, n = chunk, sub, chunk // sub
    acc = torch.float64 if v.dtype == torch.float64 else torch.float32
    uf = u.to(acc)
    st = _state(state, (B, H, K, V), r.device, acc)
    idx = torch.arange(L, device=r.device)
    lower = idx[:, None] > idx[None, :]                              # s < t
    between = ((idx[None, None, :] < idx[:, None, None])             # [t, s, τ]: s < τ < t
               & (idx[None, None, :] > idx[None, :, None])).to(acc)
    before = (idx[None, :] < idx[:, None]).to(acc)                   # [t, τ]: τ < t
    after = (idx[None, :] > idx[:, None]).to(acc)                    # [s, τ]: τ > s
    ys = []
    for c0 in range(0, S, Q):
        rq, kq, vq, wq = (a[:, c0:c0 + Q].to(acc) for a in (r, k, v, w_log))
        w2 = (wq * (1.0 / math.log(2.0))).unflatten(1, (n, L))      # (B,n,L,H,K)
        q = rq * torch.exp2(torch.einsum("tu,bxuhk->bxthk", before, w2)).flatten(1, 2)
        kk = kq * torch.exp2(torch.einsum("su,bxuhk->bxshk", after, w2)).flatten(1, 2)
        tot = w2.sum(dim=2)                                          # (B,n,H,K)

        def P(a, m):                                                 # (B,H,K)
            return torch.exp2(tot[:, m:a].sum(dim=1))

        sub_of = torch.arange(Q, device=r.device) // L
        E = torch.stack([P(i, 0) for i in range(n)], dim=1)[:, sub_of]
        y = torch.einsum("bqhk,bhkv->bqhv", q * E, st)
        A = q.new_zeros((B, H, Q, Q))
        for i in range(n):
            ti = slice(i * L, (i + 1) * L)
            seg = torch.einsum("tsu,buhk->btshk", between, w2[:, i])
            D = torch.where(lower[None, :, :, None, None], torch.exp2(seg), 0.0)
            A[:, :, ti, ti] = torch.einsum("bthk,bshk,btshk->bhts", rq[:, ti], kq[:, ti], D)
            for j in range(i):
                sj = slice(j * L, (j + 1) * L)
                A[:, :, ti, sj] = torch.einsum("bthk,bhk,bshk->bhts", q[:, ti], P(i, j + 1),
                                               kk[:, sj])
        A = A + torch.diag_embed(torch.einsum("bqhk,hk,bqhk->bhq", rq, uf, kq))
        y = y + torch.einsum("bhts,bshv->bthv", A, vq)
        carry = kk * torch.stack([P(n, j + 1) for j in range(n)], dim=1)[:, sub_of]
        st = P(n, 0)[..., None] * st + torch.einsum("bshk,bshv->bhkv", carry, vq)
        ys.append(y)
    return torch.cat(ys, dim=1).to(v.dtype), st


# ---------------------------------------------------------------------------
# Mamba2 SSD: scalar-identity state space
#   h_t = exp(dt_t·A) h_{t-1} + (dt_t x_t) ⊗ B_t ;  y_t = h_t · C_t + D x_t
# ---------------------------------------------------------------------------

def ssd_ref(x, dt, A, Bm, Cm, D, state=None):
    """The step-by-step oracle.  x (B,S,H,P); dt (B,S,H) (after softplus,
    > 0); A (H,) (< 0); Bm, Cm (B,S,H,N), expanded from groups to heads;
    D (H,); state (B,H,P,N) or None (zeros).  Returns y (B,S,H,P) in x's
    dtype and the final state (B,H,P,N) in the dtype it computes in: fp32,
    or fp64 when x is fp64 (a yardstick for the fp32 kernels' accuracy)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, Bf, Cf, Af, Df = (a.to(acc) for a in (x, dt, Bm, Cm, A, D))
    h = _state(state, (B, H, P, N), x.device, acc)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                             # (B,H)
        h = decay[..., None, None] * h \
            + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]) + Df[None, :, None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, state=None, *, chunk: int = 64):
    """Chunked SSD (the Mamba-2 paper's block decomposition), the algorithm
    of the TPU kernel; S must be a multiple of ``chunk``.  Same arguments
    and results as ``ssd_ref``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    Q = chunk
    Af, Df = A.float(), D.float()
    h = _state(state, (B, H, P, N), x.device)
    # lower-triangular with the diagonal: s ≤ t
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, :, :, None]
    ys = []
    for c0 in range(0, S, Q):
        xq, dtq, Bq, Cq = (a[:, c0:c0 + Q].float() for a in (x, dt, Bm, Cm))
        cum = torch.cumsum(dtq * Af, dim=1)               # inclusive log decay (B,Q,H)
        # inter-chunk: y_t += C_t · (e^{cum_t} h0)
        y = torch.einsum("bqhn,bhpn->bqhp", Cq * torch.exp(cum)[..., None], h)
        # intra-chunk: L[t,s] = e^{cum_t − cum_s} (s ≤ t), exponent masked
        # before exp as in wkv6_chunked_ref
        Ldiff = cum[:, :, None] - cum[:, None]           # (B,Q,Q,H)
        Lmat = torch.where(mask, torch.exp(torch.where(mask, Ldiff, 0.0)), 0.0)
        G = torch.einsum("bqhn,bshn->bqsh", Cq, Bq) * Lmat
        y = y + torch.einsum("bqsh,bsh,bshp->bqhp", G, dtq, xq) + Df[None, None, :, None] * xq
        # state: h = e^{cum_end} h0 + Σ_s e^{cum_end − cum_s} (dt_s x_s) ⊗ B_s
        cum_end = cum[:, -1]                              # (B,H)
        w = torch.exp(cum_end[:, None] - cum) * dtq       # (B,Q,H)
        h = torch.exp(cum_end)[..., None, None] * h + torch.einsum("bqh,bqhp,bqhn->bhpn", w, xq, Bq)
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, state, dy, dstate_end, *, chunk: int = 64):
    """The backward of the SSD scan, by the algorithm of ``csrc/ssd_bwd.cu``:
    the chunks' start states from a forward walk, then chunk by chunk in
    reverse with dh, the gradient of the chunk's end state, carried from
    ``dstate_end`` (or zeros) back to the first chunk.  x, dy (B,S,H,P);
    dt (B,S,H); A, D (H,); Bm, Cm (B,S,G,N) per group, G dividing H; state,
    dstate_end (B,H,P,N) or None; any S (padded to a chunk multiple with
    dt = 0 rows, which change nothing).  Computes in fp32, or fp64 for fp64
    x.  Returns (dx, ddt, dA, dBm, dCm, dD, dstate0), each in its input's
    dtype (dstate0 in the computing dtype).

    Per (b, h) and chunk, with a_t = dt_t A, cum its inclusive cumsum,
    u_s = dt_s x_s, L[t,s] = e^{cum_t − cum_s} (s ≤ t), h0 the chunk's start
    state and dh the gradient of its end state:
      dh0   = Σ_t e^{cum_t} dy_t ⊗ C_t + e^{cum_end} dh        (the next dh)
      dC_t  = e^{cum_t} h0ᵀ dy_t + Σ_{s≤t} L[t,s] (dy_t·u_s) B_s
      dB_s  = Σ_{t≥s} L[t,s] (dy_t·u_s) C_t + e^{cum_end − cum_s} dhᵀ u_s
      du_s  = Σ_{t≥s} L[t,s] (C_t·B_s) dy_t + e^{cum_end − cum_s} dh B_s
      dx_s  = dt_s du_s + D dy_s;   ddt_s = x_s·du_s + A da_s
      dD    = Σ dy·x;   dA = Σ dt da
    where da is the reverse in-chunk cumsum of dcum, which collects the
    derivative of every e^{…} above: + at t and − at s for L[t,s]; + at
    cum_end and − at s for e^{cum_end − cum_s}; + at t for e^{cum_t}; + at
    cum_end for e^{cum_end}.  dB and dC are summed over each group's heads.

    cum is summed in fp64, as the CUDA kernels sum it, and each exponent is
    a difference taken in fp64 before it is rounded: in fp32 a difference
    of two running sums keeps only their absolute rounding, and at
    zamba2-7b's decays (A down to −16, cum down to about −700 in a chunk)
    e^{cum_t − cum_s} of neighbouring rows erred by up to 4e-5.  dcum, da,
    dA and dD are summed in fp64 too, as the kernel sums them: their terms
    cancel, and in fp32 dA erred by 7.5e-6 of max|dA| at those decays."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    Q, acc = chunk, _acc(x)
    pad = (-S) % Q

    def prep(a, expand=False):
        a = a.to(acc)
        if expand:
            a = a.repeat_interleave(H // G, dim=2)
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) if pad else a

    xf, dtf, dyf = prep(x), prep(dt), prep(dy)
    Bf, Cf = prep(Bm, True), prep(Cm, True)
    Af, Df = A.to(acc), D.to(acc)
    nC = xf.shape[1] // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, :, :, None]

    def chunk_of(c):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum((dtq * Af).double(), dim=1)                 # (B,Q,H), fp64
        return sl, xq, dtq, Bq, Cq, cum, cum[:, -1]

    def exp(a):                          # e^a of an fp64 exponent, in the computing dtype
        return torch.exp(a.to(acc))

    h = _state(state, (Bsz, H, P, N), x.device, acc)
    starts = []
    for c in range(nC):                   # the forward walk: each chunk's start state
        starts.append(h)
        _, xq, dtq, Bq, _, cum, cum_end = chunk_of(c)
        w = exp(cum_end[:, None] - cum) * dtq
        h = exp(cum_end)[..., None, None] * h + torch.einsum("bqh,bqhp,bqhn->bhpn", w, xq, Bq)

    dh = _state(dstate_end, (Bsz, H, P, N), x.device, acc)
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af, dtype=torch.float64)
    for c in reversed(range(nC)):
        sl, xq, dtq, Bq, Cq, cum, cum_end = chunk_of(c)
        dyq, h0 = dyf[:, sl], starts[c]
        uq = dtq[..., None] * xq
        Lm = torch.where(mask, exp(torch.where(mask, cum[:, :, None] - cum[:, None], 0.0)),
                         0.0)                                          # (B,Q(t),Q(s),H)
        CB = torch.einsum("bthn,bshn->btsh", Cq, Bq)
        M1 = Lm * torch.einsum("bthp,bshp->btsh", dyq, uq)             # L (dy_t·u_s)
        M2 = Lm * CB                                                   # L (C_t·B_s)
        ec = exp(cum)                                                  # e^{cum_t}
        ee = exp(cum_end[:, None] - cum)                               # e^{cum_end − cum_s}
        dC_inter = ec[..., None] * torch.einsum("bthp,bhpn->bthn", dyq, h0)
        dC[:, sl] = dC_inter + torch.einsum("btsh,bshn->bthn", M1, Bq)
        dB[:, sl] = (torch.einsum("btsh,bthn->bshn", M1, Cq)
                     + ee[..., None] * torch.einsum("bshp,bhpn->bshn", uq, dh))
        du_state = ee[..., None] * torch.einsum("bshn,bhpn->bshp", Bq, dh)
        du = torch.einsum("btsh,bthp->bshp", M2, dyq) + du_state
        dx[:, sl] = dtq[..., None] * du + Df[None, None, :, None] * dyq
        v = (M1 * CB).double()                                         # dcum's terms in fp64
        w_state = torch.einsum("bshp,bshp->bsh", uq.double(), du_state.double())
        dcum = (v.sum(2) - v.sum(1)
                + torch.einsum("bthn,bthn->bth", Cq.double(), dC_inter.double()) - w_state)
        dcum[:, -1] += (exp(cum_end).double()
                        * torch.einsum("bhpn,bhpn->bh", dh.double(), h0.double())
                        + w_state.sum(1))
        da = dcum.flip(1).cumsum(1).flip(1)                            # Σ_{t ≥ s} dcum_t
        ddt[:, sl] = (torch.einsum("bshp,bshp->bsh", xq, du) + Af * da).to(acc)
        dA = dA + torch.einsum("bsh,bsh->h", dtq.double(), da)
        dh = exp(cum_end)[..., None, None] * dh + torch.einsum("bth,bthp,bthn->bhpn", ec, dyq, Cq)
    dD = torch.einsum("bshp,bshp->h", dyf.double(), xf.double())

    def grouped(a):
        return a[:, :S].unflatten(2, (G, H // G)).sum(3)

    return (dx[:, :S].to(x.dtype), ddt[:, :S].to(dt.dtype), dA.to(A.dtype),
            grouped(dB).to(Bm.dtype), grouped(dC).to(Cm.dtype), dD.to(D.dtype), dh)
