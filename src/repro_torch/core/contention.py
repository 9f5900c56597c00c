"""The port's own copy of ``repro.core.contention``.

Contention model — the paper's Eqs. (4)–(6) plus the communication-time
model that AutoCCL learns online.

Two contention dimensions (Sec. 3.2):
  * SM competition: NC channels occupy NC slots; computation waves become
      g_ij = ceil(μ_i / ((λ − NC_j) · TB_i))                      (Eq. 5)
  * Global-resource competition: communication draws V(NC, C) of the memory
    bandwidth; per-wave latency becomes
      f_ij = θ_ij + (λ − NC_j) · TB_i · D_i / (B̄ − V(NC_j, C_j)) (Eq. 6)
  and y_i = Σ_j f_ij · g_ij                                       (Eq. 4)
  (in the event-driven simulator the Σ over j emerges from time slicing).

NT (threads) is negligible by construction — multi-constraint occupancy and
coalesced transactions (Sec. 3.2); we give it a <0.5%% latency effect so the
tuner can verify the paper's negative result rather than assume it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core.comm_params import CommConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.workload import CommOp, CompOp

_PROTO = {
    # (bandwidth efficiency ceiling, per-chunk overhead multiplier)
    "latency": (0.70, 0.4),
    "mixed":   (0.92, 1.0),
    "bulk":    (1.00, 1.8),
}
_TRANSPORT = {"p2p": 1.0, "shm": 0.93, "net": 0.85}


def chunk_efficiency(chunk_kb: float, hw: Hardware, protocol: str) -> float:
    """Channel efficiency vs chunk size: small chunks pay per-chunk latency
    (diminishing returns curve of Fig. 3c)."""
    ceiling, _ = _PROTO[protocol]
    return ceiling * chunk_kb / (chunk_kb + hw.chunk_half_kb)


_NC_HALF = 3.0     # channels at which the bus reaches 50% of saturation


def wire_bandwidth(cfg: CommConfig, hw: Hardware) -> float:
    """Achieved bus bandwidth: rises with NC with diminishing returns and
    never quite saturates — the shape that makes a communication-only tuner
    (AutoCCL) keep over-allocating channels (paper Fig. 8: NC=61) while the
    marginal gain is tiny."""
    nc_curve = cfg.nc / (cfg.nc + _NC_HALF)
    bw = hw.link_bw * nc_curve * chunk_efficiency(cfg.chunk_kb, hw, cfg.protocol) \
        * _TRANSPORT[cfg.transport]
    return min(bw, hw.chan_bw * cfg.nc)      # few channels can't fill the bus


def comm_bandwidth_draw(cfg: CommConfig, hw: Hardware) -> float:
    """V(NC, C): global memory bandwidth consumed by the communication.
    HBM traffic ≈ 2× wire (read + write staging), plus per-channel staging
    pressure, capped below B̄."""
    wire = wire_bandwidth(cfg, hw)
    return min(2.0 * wire * (1.0 + 0.01 * cfg.nc), 0.85 * hw.hbm_bw)


def wire_bytes(op: CommOp, algo: str) -> float:
    """Per-chip wire traffic for the collective."""
    n = max(2, op.group_size)
    if op.kind == "allreduce":
        f = 2.0 * (n - 1) / n if algo != "tree" else 2.0 * math.log2(n) / n + 1.0
    elif op.kind in ("allgather", "reducescatter", "alltoall"):
        f = (n - 1) / n
    else:  # permute
        f = 1.0
    return op.bytes * f


def comm_time(op: CommOp, cfg: CommConfig, hw: Hardware, *,
              compute_active: bool = False) -> float:
    """x_j^{s_j} in seconds.  ``compute_active`` applies the reciprocal
    contention (computation stealing bandwidth from communication)."""
    bw = wire_bandwidth(cfg, hw)
    if compute_active:
        bw *= (1.0 - hw.comm_comp_beta)
    wb = wire_bytes(op, cfg.algorithm)
    n_chunks = max(1, math.ceil(op.bytes / (cfg.chunk_kb * 1024)))
    _, chunk_mult = _PROTO[cfg.protocol]
    nt_adj = 1.0 - 0.004 * (cfg.nt - 64) / 576.0          # negligible, by design
    n_steps = max(2, op.group_size) - 1 if cfg.algorithm == "ring" else \
        max(1, int(math.log2(max(2, op.group_size))))
    # per-step cost: the fixed 1µs algorithm-step overhead plus the fabric's
    # hop latency (0 pod-local; cross-pod RTT on core.topology inter tiers)
    latency = (hw.launch_us + 0.5 * cfg.nc                 # per-channel setup
               + n_chunks * hw.chunk_us * chunk_mult * nt_adj
               + n_steps * (1.0 + hw.hop_us)) * 1e-6
    return latency + wb / bw


def comp_time(op: CompOp, cfg: Optional[CommConfig], hw: Hardware) -> float:
    """y_i under an active communication with config ``cfg`` (None = alone).
    Implements Eqs. (4)–(6) for a single overlapped communication; the
    simulator time-slices across successive communications."""
    lam = hw.num_slots
    nc = min(cfg.nc, int(lam * 0.75)) if cfg is not None else 0
    V = comm_bandwidth_draw(cfg, hw) if cfg is not None else 0.0

    W = max(1, (lam - nc) * op.tb_per_slot)               # blocks per wave
    g = math.ceil(op.threadblocks / W)                    # Eq. 5
    # θ: pure-compute time per wave (a slot runs TB blocks concurrently),
    # inflated by staging-footprint interference: NC·C bytes of comm staging
    # evict the compute working set from L2/VMEM (the reason the paper's
    # Fig. 8 gains exceed the pure SM-wave effect).
    per_block_flops = op.flops / op.threadblocks
    theta = per_block_flops * op.tb_per_slot * lam / hw.achieved_flops
    if cfg is not None:
        footprint = cfg.nc * cfg.chunk_kb / hw.cache_kb
        theta *= 1.0 + hw.interference_gamma * min(1.0, footprint)
    mem = W * op.bytes_per_tb / max(hw.hbm_bw - V, 0.05 * hw.hbm_bw)  # Eq. 6
    return g * (theta + mem)


def comp_time_alone(op: CompOp, hw: Hardware) -> float:
    return comp_time(op, None, hw)


# ---------------------------------------------------------------------------
# Vectorized (batched) variants — the profiling engine's math kernel.
#
# These reproduce the scalar functions above BIT-FOR-BIT: every expression
# keeps the identical operator order/associativity on float64, so a batched
# profile equals the sequential event loop exactly (tests/test_profiling.py
# asserts `==`, not approx).  Array arguments broadcast; scalars come from
# the same Hardware dataclass.  Algorithm-dependent integer constants
# (wire-bytes factor, ring/tree step counts) are precomputed per-op with the
# scalar helpers and passed in, so no transcendental function is re-derived
# here.
# ---------------------------------------------------------------------------

PROTO_PARAMS = _PROTO            # public aliases for the batched engine
TRANSPORT_MULT = _TRANSPORT
NC_HALF = _NC_HALF


def comm_steps(op: CommOp, algorithm: str) -> int:
    """Step count of ``comm_time``'s latency term, factored out so the
    batched engine can precompute it with the identical expression."""
    if algorithm == "ring":
        return max(2, op.group_size) - 1
    return max(1, int(math.log2(max(2, op.group_size))))


def wire_bandwidth_v(nc, chunk_kb, proto_ceiling, transport_mult, hw: Hardware):
    """Vectorized ``wire_bandwidth`` (proto/transport constants pre-gathered)."""
    nc_curve = nc / (nc + _NC_HALF)
    eff = proto_ceiling * chunk_kb / (chunk_kb + hw.chunk_half_kb)
    bw = hw.link_bw * nc_curve * eff * transport_mult
    return np.minimum(bw, hw.chan_bw * nc)


def comm_bandwidth_draw_v(nc, chunk_kb, proto_ceiling, transport_mult,
                          hw: Hardware):
    """Vectorized ``comm_bandwidth_draw``; nc == 0 yields exactly 0.0 (the
    scalar ``cfg is None`` branch), which lets the engine pad a no-comm
    column instead of special-casing it."""
    wire = wire_bandwidth_v(nc, chunk_kb, proto_ceiling, transport_mult, hw)
    return np.minimum(2.0 * wire * (1.0 + 0.01 * nc), 0.85 * hw.hbm_bw)


def comm_time_v(op_bytes, wb, n_steps, nc, nt, chunk_kb, proto_ceiling,
                proto_chunk_mult, transport_mult, hw: Hardware, *,
                compute_active):
    """Vectorized ``comm_time``.  ``wb`` / ``n_steps`` are the per-(op, algo)
    constants from ``wire_bytes`` / ``comm_steps``; ``compute_active`` may be
    a bool or a boolean array."""
    bw = wire_bandwidth_v(nc, chunk_kb, proto_ceiling, transport_mult, hw)
    bw = np.where(compute_active, bw * (1.0 - hw.comm_comp_beta), bw)
    n_chunks = np.maximum(1, np.ceil(op_bytes / (chunk_kb * 1024)))
    nt_adj = 1.0 - 0.004 * (nt - 64) / 576.0
    latency = (hw.launch_us + 0.5 * nc
               + n_chunks * hw.chunk_us * proto_chunk_mult * nt_adj
               + n_steps * (1.0 + hw.hop_us)) * 1e-6
    return latency + wb / bw


def comp_time_v(theta_base, threadblocks, tb_per_slot, bytes_per_tb,
                nc, chunk_kb, V, hw: Hardware):
    """Vectorized ``comp_time``.  ``theta_base`` is the per-op pure-compute
    wave time ``(flops/μ)·TB·λ/achieved`` precomputed with scalar float
    arithmetic; nc == chunk_kb == V == 0 reproduces ``comp_time_alone``
    exactly (footprint multiplier collapses to 1.0, Eq. 6 denominator to B̄)."""
    lam = hw.num_slots
    nc_cl = np.minimum(nc, int(lam * 0.75))
    W = np.maximum(1, (lam - nc_cl) * tb_per_slot)
    g = np.ceil(threadblocks / W)
    footprint = nc * chunk_kb / hw.cache_kb
    theta = theta_base * (1.0 + hw.interference_gamma
                          * np.minimum(1.0, footprint))
    mem = W * bytes_per_tb / np.maximum(hw.hbm_bw - V, 0.05 * hw.hbm_bw)
    return g * (theta + mem)
