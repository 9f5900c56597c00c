"""The port's own copy of ``repro.core.cost_model``.

Unified overlap cost model (Eqs. 1–3) — the analytic counterpart of the
event-driven simulator, used for napkin math, search-space accounting, and
the benchmarks' sanity checks.

    Z = max(Y, X) = max(Σ_i y_i, Σ_j x_j^{s_j})          (Eq. 1)
    comm-bound:  min Z = Σ_j min_{s_j} x_j^{s_j}         (Eq. 2)
    comp-bound:  min Z = Σ_i y_i                         (Eq. 3)
"""
from __future__ import annotations

from typing import List

from repro_torch.core import contention as C
from repro_torch.core.comm_params import CommConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.workload import ConfigSet, OverlapGroup, Workload


def group_makespan(g: OverlapGroup, cfgs: List[CommConfig], hw: Hardware) -> float:
    """Closed-form Z = max(X, Y) with Y priced under the *sequence* of comm
    configs (each comm assumed to cover a Y-proportional window)."""
    if not g.comms:
        return sum(C.comp_time_alone(c, hw) for c in g.comps)
    X = sum(C.comm_time(op, s, hw, compute_active=bool(g.comps))
            for op, s in zip(g.comms, cfgs))
    # Eq. 4: computation is sliced across the j communications; weight each
    # config by its share of the communication stream.
    xs = [C.comm_time(op, s, hw, compute_active=bool(g.comps))
          for op, s in zip(g.comms, cfgs)]
    tot_x = sum(xs) or 1.0
    Y = 0.0
    for comp in g.comps:
        y = sum((xj / tot_x) * C.comp_time(comp, s, hw)
                for xj, s in zip(xs, cfgs))
        Y += y
    return max(X, Y)


def workload_makespan(wl: Workload, configs: ConfigSet, hw: Hardware) -> float:
    z = 0.0
    for gi, g in enumerate(wl.groups):
        cfgs = [configs[(gi, ci)] for ci in range(len(g.comms))]
        z += group_makespan(g, cfgs, hw)
    return z


def bottleneck(g: OverlapGroup, cfgs: List[CommConfig], hw: Hardware) -> str:
    if not g.comms:
        return "compute"
    X = sum(C.comm_time(op, s, hw) for op, s in zip(g.comms, cfgs))
    Y = sum(C.comp_time(c, cfgs[0], hw) for c in g.comps)
    return "compute" if Y >= X else "communication"
