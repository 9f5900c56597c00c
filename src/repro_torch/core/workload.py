"""The port's own copy of ``repro.core.workload``.

Workload IR: what the tuner sees — overlap groups of computation and
communication operators (the M comps and N comms of Eq. 1).

The IR is framework-neutral: ``core.extract`` lowers a (model config ×
parallel plan × input shape) into this IR; the simulator executes it; the
tuners only ever see (Workload, configs) -> times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.comm_params import CommConfig

COMM_KINDS = ("allgather", "reducescatter", "allreduce", "alltoall", "permute")


@dataclass
class CompOp:
    """One computation operator (cuBLAS/cuDNN kernel; TPU fused region)."""
    name: str
    flops: float
    bytes_rw: float
    threadblocks: int          # μ_i — total blocks (tiles) to schedule
    tb_per_slot: int = 1       # TB_i — resident blocks per SM/slot
    bytes_per_tb: float = 0.0  # D_i — bytes moved per block

    def __post_init__(self):
        if not self.bytes_per_tb and self.threadblocks:
            self.bytes_per_tb = self.bytes_rw / self.threadblocks


@dataclass
class CommOp:
    """One collective in the serialized communication stream."""
    name: str
    kind: str                  # one of COMM_KINDS
    bytes: float               # payload per chip
    group_size: int = 8        # participating chips on its mesh axis
    site: str = ""             # stable dotted SiteId (runtime addressing);
                               # defaults to ``name`` when unset
    tier: str = ""             # fabric tier the site spans: "" = pod-local,
                               # "inter" = pod-joining (core.topology prices
                               # it on the slow fabric's Hardware)

    def __post_init__(self):
        assert self.kind in COMM_KINDS, self.kind

    @property
    def site_id(self) -> str:
        return self.site or self.name


@dataclass
class OverlapGroup:
    """One overlap window: comps run on the computation stream, comms on the
    (serialized) communication stream; makespan = max(X, Y) + unhidden."""
    name: str
    comps: List[CompOp] = field(default_factory=list)
    comms: List[CommOp] = field(default_factory=list)

    @property
    def total_flops(self) -> float:
        return sum(c.flops for c in self.comps)

    @property
    def total_comm_bytes(self) -> float:
        return sum(c.bytes for c in self.comms)


@dataclass
class Workload:
    """A training iteration (or serving step): sequence of overlap groups."""
    name: str
    groups: List[OverlapGroup]
    meta: Dict[str, float] = field(default_factory=dict)

    @property
    def num_comms(self) -> int:
        return sum(len(g.comms) for g in self.groups)

    def comm_sites(self) -> List[Tuple[int, int]]:
        """(group_idx, comm_idx) for every tunable communication."""
        return [(gi, ci) for gi, g in enumerate(self.groups)
                for ci in range(len(g.comms))]


ConfigSet = Dict[Tuple[int, int], CommConfig]


def comm_site_meta(wl: Workload) -> List[Dict]:
    """Portable per-site metadata — everything ``core.apply`` reads from
    the workload when lowering configs to runtime knobs, in a JSON-safe
    shape.  ``session.TunedPlan`` embeds this so a saved plan can be
    re-applied without rebuilding the workload it was tuned on.  ``site``
    is the stable dotted SiteId runtime call sites address
    (``collectives.runtime_for``)."""
    rows = []
    for gi, g in enumerate(wl.groups):
        for ci, op in enumerate(g.comms):
            row = dict(group=gi, comm=ci, name=op.name, kind=op.kind,
                       bytes=op.bytes, group_size=op.group_size,
                       site=op.site_id)
            if op.tier:           # append-only: flat workloads stay byte-stable
                row["tier"] = op.tier
            rows.append(row)
    return rows


def structure_components(wl: Workload) -> Tuple:
    """Shape-free structural identity of a workload: everything that stays
    fixed while batch/seq drift — the workload name (model × extraction
    kind), and per group its name, comp op names, and each comm's
    (kind, group_size, SiteId).  Two workloads with equal components are
    the same program at different shapes, which is the soundness condition
    for *tolerance-band* plan reuse (``PlanRepository.resolve(band=...)``):
    the sites line up one-to-one, only payload magnitudes differ.  Contrast
    ``session.workload_fingerprint``, which hashes op shapes/bytes and so
    changes with every batch/seq."""
    return (wl.name, tuple(
        (g.name,
         tuple(c.name for c in g.comps),
         # tier joins the identity only when set, so every pre-topology
         # fingerprint (and the plan repo keyed on it) stays stable
         tuple((c.kind, c.group_size, c.site_id) + ((c.tier,) if c.tier else ())
               for c in g.comms))
        for g in wl.groups))


def uniform_configs(wl: Workload, cfg: CommConfig) -> ConfigSet:
    return {site: cfg for site in wl.comm_sites()}


def matmul_comp(name: str, m: int, k: int, n: int, dsize: int = 2, *,
                tile: int = 128, tb_per_slot: int = 1) -> CompOp:
    """Helper: a GEMM's CompOp with tile-derived threadblock count."""
    flops = 2.0 * m * k * n
    bytes_rw = float(dsize) * (m * k + k * n + m * n)
    mu = max(1, math.ceil(m / tile) * math.ceil(n / tile))
    return CompOp(name=name, flops=flops, bytes_rw=bytes_rw,
                  threadblocks=mu, tb_per_slot=tb_per_slot)
