"""The port's own copy of ``repro.core.autoccl``.

AutoCCL baseline [NSDI'25] — the state-of-the-art communication tuner
Lagom compares against.

AutoCCL optimizes each communication's OWN latency via divide-and-conquer
(implementation-related subspaces) + online sampling of resource-related
parameters, oblivious to the computation it overlaps with.  In
communication-bound overlaps this is near-optimal; in computation-bound
overlaps it over-allocates resources (e.g. NC=61 in the paper's Fig. 8)
and can land below the NCCL default (0.87×).

ProfileTime goes through the batched engine's caches (core.profiling):
coordinate descent revisits configs when a shrink/grow cycle stalls, and
structurally identical layers repeat whole search trajectories, so AutoCCL
never re-measures an already-profiled point.  Its inner loop stays
sequential by necessity — each candidate's acceptance mutates the descent
state (and the shared budget) that the next candidate derives from — so
``AutoCCLSearch`` yields one-candidate batches; the cross-group scheduler
(core.scheduler) still interleaves the per-group descents, folding every
unfinished group's next sample into one engine call per step.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Tuple

from repro_torch.core.comm_params import CommConfig
from repro_torch.core.scheduler import StepSearch, run_workload
from repro_torch.core.simulator import Simulator
from repro_torch.core.workload import ConfigSet, OverlapGroup, Workload

# pruned implementation-related subspaces (transport fixed to the cluster's
# native path, as AutoCCL's probe would select immediately)
_SUBSPACES: List[Tuple[str, str]] = [
    ("ring", "mixed"), ("ring", "bulk"), ("tree", "mixed"), ("bidir", "bulk"),
]


class AutoCCLSearch(StepSearch):
    """AutoCCL's per-group search as a resumable step machine.  The
    generator below is the former blocking coordinate descent with each
    in-situ sample (``sim.profile_group``) replaced by a one-candidate
    ``yield``; semantics and the per-comm budget are unchanged."""

    def __init__(self, group: OverlapGroup, *, max_steps_per_comm: int = 24):
        self.group = group
        self.max_steps_per_comm = max_steps_per_comm
        self.cfgs: List[CommConfig] = [CommConfig()
                                       for _ in range(len(group.comms))]
        super().__init__()

    def _search(self):
        group, cfgs = self.group, self.cfgs
        for j in range(len(group.comms)):
            best_cfg, best_x = None, math.inf
            budget = self.max_steps_per_comm
            for algo, proto in _SUBSPACES:
                if budget <= 0:
                    break
                # coordinate descent on (nc, chunk) inside the subspace:
                cur = CommConfig(algorithm=algo, protocol=proto,
                                 nc=4, chunk_kb=512)
                trial = list(cfgs)
                trial[j] = cur
                x_cur = (yield [trial])[0].comm_times[j]
                budget -= 1
                improved = True
                while improved and budget > 0:
                    improved = False
                    for field_, vals in (
                            ("nc", (cur.nc * 2, max(1, cur.nc // 2))),
                            ("chunk_kb", (cur.chunk_kb * 2,
                                          max(32, cur.chunk_kb // 2)))):
                        for v in vals:
                            if budget <= 0:
                                break
                            cand = cur.with_(**{field_: v})
                            if cand == cur:
                                continue
                            trial[j] = cand
                            x_c = (yield [trial])[0].comm_times[j]
                            budget -= 1
                            if x_c < x_cur * 0.995:
                                cur, x_cur = cand, x_c
                                improved = True
                if x_cur < best_x:
                    best_cfg, best_x = cur, x_cur
            cfgs[j] = best_cfg.with_(done=True)


def tune_group(sim: Simulator, group: OverlapGroup, *,
               max_steps_per_comm: int = 24) -> Tuple[List[CommConfig], int]:
    """Drive one ``AutoCCLSearch`` to completion (the serial walk)."""
    s = AutoCCLSearch(group, max_steps_per_comm=max_steps_per_comm)
    while not s.done:
        s.feed(sim.profile_many(group, s.pending))
    return s.cfgs, s.requests


def search_workload(sim: Simulator, wl: Workload, *,
                    mode: str = "interleaved") -> Tuple[ConfigSet, int]:
    """Tune every overlap group; ``mode="interleaved"`` (default) folds each
    unfinished group's next in-situ sample into one cross-group engine call
    per step, and whenever sharing is sound (deterministic or CRN noise —
    ``Simulator.can_share_trajectories``) structurally identical groups
    share one descent (scheduler.run_shared).  ``mode="serial"`` is the
    reference walk, ``mode="shared"`` requires sharing soundness up front;
    deterministic and CRN results are identical across all three."""
    from repro_torch.core.profiling import group_fingerprint

    per_group = run_workload(sim, wl.groups, AutoCCLSearch,
                             group_fingerprint, mode)
    configs: ConfigSet = {}
    iters = 0
    for gi, s in enumerate(per_group):
        for ci, cfg in enumerate(s.cfgs):
            configs[(gi, ci)] = cfg
        iters += s.requests
    return configs, iters


def tune_workload(sim: Simulator, wl: Workload, *,
                  interleave: bool = True) -> Tuple[ConfigSet, int]:
    """Deprecated pre-session entry point (one release of grace): the
    legacy 2-tuple signature, bit-identical to ``search_workload`` with
    ``mode="interleaved" if interleave else "serial"``.  Use
    ``repro_torch.core.session.tune(..., method="autoccl")`` instead."""
    warnings.warn(
        "autoccl.tune_workload is deprecated; use repro_torch.core.session.tune("
        "wl, hw, method='autoccl', mode=...) — or autoccl.search_workload "
        "for an existing Simulator — and will be removed next release",
        DeprecationWarning, stacklevel=2)
    return search_workload(sim, wl,
                           mode="interleaved" if interleave else "serial")
