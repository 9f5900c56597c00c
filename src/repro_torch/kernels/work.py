"""The work of each kernel call: the floating-point operations it does on
its inputs, counted as ``chip_smoke.py`` counts them for each kernel's
bound (``PERF.md``, the table of the TPU kernels).  The dry run
(``launch.dryrun``) adds these to ``FlopCounterMode``'s count, which sees
no kernel: under fake tensors a kernel's call returns empty outputs
(``kernels.ops``)."""
from __future__ import annotations


def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a causal mask keeps, positions counted from 0."""
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(0, Sq - Sk) * Sk


def masked_pairs(Sq: int, Sk: int, window: int, causal: bool = True) -> int:
    """Pairs the mask keeps: causal, and with ``window`` > 0 only keys less
    than ``window`` positions back."""
    if not causal:
        return Sq * Sk
    if window <= 0:
        return causal_pairs(Sq, Sk)
    return causal_pairs(Sq, Sk) - causal_pairs(max(0, Sq - window), max(0, Sk - window))


def rmsnorm_flops(rows: int, D: int) -> int:
    return 4 * rows * D


def rmsnorm_bwd_flops(rows: int, D: int) -> int:
    return 8 * rows * D


def flash_flops(B: int, Sq: int, Sk: int, Hq: int, h: int, *, causal: bool = True,
                window: int = 0) -> int:
    return 4 * h * B * Hq * masked_pairs(Sq, Sk, window, causal)


def flash_bwd_flops(B: int, Sq: int, Sk: int, Hq: int, h: int, *, causal: bool = True,
                    window: int = 0) -> int:
    return 5 * 2 * h * B * Hq * masked_pairs(Sq, Sk, window, causal)


def _chunk_rows(S: int, Q: int):
    return [min(Q, S - c0) for c0 in range(0, S, Q)]


def ssd_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """The four chunk products of one SSD call over the causal pairs s <= t
    its rows have (the kernel computes nothing above the diagonal or past
    S), plus the decays and the D x skip."""
    flops = 0
    for q in _chunk_rows(S, 64):
        pairs = q * (q + 1) // 2
        flops += 2 * pairs * N + 3 * pairs      # G = C Bᵀ, decay and dt on it
        flops += 2 * pairs * P                  # G x
        flops += 2 * q * P * N + 3 * q * P      # (C h0ᵀ) e^{cum}, D x
        flops += 2 * q * P * N + 2 * P * N      # state update
    return B * H * flops


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """One SSD backward call (``csrc/ssd_bwd.cu``) over the causal pairs
    s <= t its rows have: C Bᵀ and dy xᵀ, L and M1, M2 on them (an exp, a
    subtraction and six multiplies or adds a pair), the three products
    with M1 and M2 (dC, dB and du, intra-chunk), the four with the states
    (dC's e^{cum} dy h0, dB's and du's with dh, the next dh), their row
    scalings and dot products, dx, ddt, dD and the scan of dcum."""
    flops = 0
    for q in _chunk_rows(S, 64):
        pairs = q * (q + 1) // 2
        flops += 2 * pairs * (N + P) + 8 * pairs      # C Bᵀ, dy xᵀ; L, M1, M2, dcum
        flops += 2 * pairs * (2 * N + P)              # M1 B, M1ᵀ C, M2ᵀ dy
        flops += 8 * q * P * N + 4 * P * N            # the four state products; dh's decay, dh·h0
        flops += q * (4 * N + 11 * P + 10)            # scalings, dots, dx, dD, ddt, the scan
    return B * H * flops


def ssd_bwd_bytes(B: int, S: int, H: int, P: int, N: int, G: int, *,
                  dstate_end: bool = False) -> int:
    """The bytes one SSD backward call must move, each input read once and
    each output written once, in fp32: x, dy, dx (B,S,H,P); B, C, dB, dC at
    their G groups; dt, ddt; A, D, dA, dD; the chunks' start states the
    forward saved; dstate_end where given, and dstate0."""
    chunks = len(_chunk_rows(S, 64))
    return 4 * (3 * B * S * H * P + 4 * B * S * G * N + 2 * B * S * H + 4 * H
                + B * H * chunks * P * N + B * H * P * N * (2 if dstate_end else 1))


def wkv6_flops(B: int, S: int, H: int, K: int, V: int) -> int:
    """One WKV6 call: the off-diagonal A[t][s] over s < t (a subtraction, an
    exp, two multiplies and an add per channel), its diagonal, the decays
    folded into r and k, and the three products."""
    flops = 0
    for q in _chunk_rows(S, 32):
        flops += 5 * K * q * (q - 1) // 2 + 3 * K * q     # A, off-diagonal and diagonal
        flops += 5 * q * K                                 # r e^{cw}, k e^{cw_end - ci}
        flops += 2 * q * K * V + q * (q + 1) * V           # y: inter and intra
        flops += 2 * q * K * V + 2 * K * V                 # state update
    return B * H * flops
