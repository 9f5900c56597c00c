"""The port's own copy of ``repro.core.tuner``.

Lagom's search — Algorithm 1 (Cost-Effectiveness) + Algorithm 2
(Resource-Efficient Tuning).

Faithful to the paper with one documented interpretation: Alg. 2 line 8
writes ``lr = (x^{s'} − x^{s}) / x^{s'}`` which is ≤ 0 whenever the loop
continues (line 5 already terminated on positive), so we read it as the
relative improvement ``(x_prev − x_new) / x_new ≥ 0`` and apply it as a
multiplicative step on NC/NT/C (integer dials move by at least 1).  The
complexity remains linear in the number of communications: each comm takes
O(log(range)) growth steps and comms are tuned one-at-a-time by priority.

ProfileTime plumbing: the whole search is a resumable step machine
(``GroupSearch``, built on ``scheduler.StepSearch``) that *yields* its next
candidate batch — subspace probes, per-dial growth candidates, bisection
midpoints — and consumes the measurements fed back.  ``tune_group`` drives
one machine to completion through ``Simulator.profile_many`` (the serial
walk, bit-identical to the ``batched=False`` reference event loop
including the counter-based noise stream, core.noise); ``search_workload``
round-robins every group's pending batch into one cross-group
``profile_many_grouped`` call per step (``mode="interleaved"``, the
engine-aware default), which in deterministic and CRN-noise modes
produces configs, traces, and ``profile_count`` identical to the serial
walk.  ``profile_count`` still counts logical invocations.  The legacy
``tune_workload`` signature survives as a deprecation shim; the session
front door (``core.session``) is the supported public surface.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import priority
from repro_torch.core.comm_params import (C_MAX_KB, C_MIN_KB, NC_MAX, NC_MIN,
                                          NT_MAX, CommConfig, min_config)
from repro_torch.core.scheduler import StepSearch, run_workload
from repro_torch.core.simulator import Simulator
from repro_torch.core.workload import ConfigSet, OverlapGroup, Workload

LR_SEED = 0.5


@dataclass
class _CommState:
    cfg: CommConfig                  # current accepted config
    lr: float = LR_SEED
    h: float = priority.H_INIT
    done: bool = False
    initialized: bool = False
    last_x: float = math.inf         # measured comm time under accepted cfg
    history: List[Tuple[CommConfig, float]] = field(default_factory=list)


def _grow_candidates(cfg: CommConfig, lr: float, *, shrink: bool = False):
    """Per-dial growth candidates.  Lagom grows the dial whose step buys the
    most makespan — chunk size is contention-free (no slot steal) so it
    saturates first; NC only grows when chunks alone can't hide the comm.
    This is what lands on the paper's low-NC / moderate-C configs (Fig. 8:
    NC=2, C=684 KB where NCCL defaults NC=8, C=2 MB).

    ``shrink=True`` (warm-start mode, beyond-paper): also propose shrinking
    the contention dials, so a seed past the balance point can descend.

    Hot path: one positional ``CommConfig`` per stepped dial (``with_``'s
    dict merge costs ~3x as much and this runs for every tuning step)."""
    lr = max(0.25, min(1.0, lr))
    a, p, tr, done = cfg.algorithm, cfg.protocol, cfg.transport, cfg.done
    nc, nt, ck = cfg.nc, cfg.nt, cfg.chunk_kb
    cands = []
    c2 = min(C_MAX_KB, max(int(ck * 2), int(ck * (1 + lr))))
    if c2 != ck:
        cands.append(("chunk", CommConfig(a, p, tr, nc, nt, c2, done)))
    n2 = min(NC_MAX, max(nc + 1, int(round(nc * (1 + lr)))))
    if n2 != nc:
        cands.append(("nc", CommConfig(a, p, tr, n2, nt, ck, done)))
    t2 = min(NT_MAX, max(nt + 64, int(round(nt * (1 + lr)))))
    if t2 != nt:
        cands.append(("nt", CommConfig(a, p, tr, nc, t2, ck, done)))
    if shrink:
        n3 = max(NC_MIN, nc - max(1, nc // 3))
        if n3 != nc:
            cands.append(("nc-", CommConfig(a, p, tr, n3, nt, ck, done)))
        c3 = max(C_MIN_KB, ck // 2)
        if c3 != ck:
            cands.append(("chunk-", CommConfig(a, p, tr, nc, nt, c3, done)))
    return cands


def _midpoint(a: CommConfig, b: CommConfig) -> CommConfig:
    return a.with_(nc=(a.nc + b.nc) // 2, nt=(a.nt + b.nt) // 2,
                   chunk_kb=(a.chunk_kb + b.chunk_kb) // 2)


@dataclass
class TuneResult:
    configs: List[CommConfig]
    iterations: int                  # ProfileTime invocations
    trace: List[Dict]                # per-step log (benchmarks/Fig 8c)


def warm_start_config(group: OverlapGroup, j: int, hw) -> CommConfig:
    """Beyond-paper: instead of Algorithm 2's cold start from the minimum
    config, seed the search from the cost model's predicted balance point —
    the cheapest (NC, C) whose predicted communication time is below the
    group's un-contended computation time (§3.4 condition 3 says the optimum
    sits at X≈Y; the closed form gets us near it for free, and the online
    loop only has to correct model error)."""
    from repro_torch.core import contention as _C
    y_est = sum(_C.comp_time_alone(c, hw) for c in group.comps)
    x_share = y_est / max(1, len(group.comms))
    op = group.comms[j]
    best = None
    for nc in (1, 2, 3, 4, 6, 8, 12, 16):
        for chunk in (256, 512, 1024, 2048, 4096):
            cfg = CommConfig(nc=nc, chunk_kb=chunk)
            x = _C.comm_time(op, cfg, hw, compute_active=True)
            cost = nc + chunk / 2048.0          # resource footprint order
            if x <= x_share and (best is None or cost < best[0]):
                best = (cost, cfg)
    if best is None:                            # comm-bound: start near max bw
        return CommConfig(nc=8, chunk_kb=2048)
    return best[1]


class GroupSearch(StepSearch):
    """Algorithm 1/2 over one overlap group as a resumable step machine:
    the generator body below is the former blocking loop with every
    ProfileTime call replaced by a ``yield`` of the candidate batch, so the
    search semantics are textually intact while a scheduler can interleave
    many groups' measurement points.  ``warm_start=True`` enables the
    beyond-paper cost-model seeding (see warm_start_config)."""

    def __init__(self, group: OverlapGroup, hw, *,
                 base: Optional[CommConfig] = None,
                 warm_start: bool = False,
                 seed_cfgs: Optional[List[CommConfig]] = None,
                 max_steps: int = 200):
        self.group = group
        self.hw = hw
        self.base = base
        self.warm_start = warm_start
        self.max_steps = max_steps
        n = len(group.comms)
        self.seed_cfgs = list(seed_cfgs) if seed_cfgs is not None else None
        if self.seed_cfgs is not None:
            # re-tune mode (beyond-paper): seed every comm from an installed
            # plan's configs and skip the subspace probes — the seed already
            # carries a searched (algorithm, protocol) choice.  Dynamics are
            # the warm Z-driven ones (shrink candidates, no paper stops), so
            # a seed past the balance point on changed hardware can descend.
            if len(self.seed_cfgs) != n:
                raise ValueError(
                    f"seed_cfgs must carry one config per comm "
                    f"({n} expected, got {len(self.seed_cfgs)})")
            self.states = [_CommState(cfg=c.with_(done=False),
                                      initialized=True)
                           for c in self.seed_cfgs]
        elif warm_start:
            self.states = [_CommState(cfg=warm_start_config(group, j, hw))
                           for j in range(n)]
        else:
            self.states = [_CommState(cfg=min_config(base)) for _ in range(n)]
        self.trace: List[Dict] = []
        super().__init__()

    def result(self) -> TuneResult:
        if not self.done:
            raise RuntimeError("search still has pending measurements")
        return TuneResult([s.cfg for s in self.states], self.requests,
                          self.trace)

    def _search(self):
        group, states, trace = self.group, self.states, self.trace
        warm_start = self.warm_start or self.seed_cfgs is not None
        n = len(group.comms)
        if n == 0:
            return

        # Alg 1 line 3: while ∃ s not done
        steps = 0
        prev_meas = None
        if self.seed_cfgs is not None:
            # one baseline measurement of the seed configs anchors the
            # Z-driven stop: a retune that cannot improve on the installed
            # plan terminates after a single candidate round.
            meas = (yield [[s.cfg for s in states]])[0]
            prev_meas = meas
            for i, s in enumerate(states):
                s.last_x = meas.comm_times[i]
            trace.append(dict(step=0, comm=-1, cfg=None, x=None, X=meas.X,
                              Y=meas.Y, Z=meas.Z, h=priority.H_INIT,
                              seeded=True))
        while any(not s.done for s in states) and steps < self.max_steps:
            steps += 1
            # line 4: argmin H among unfinished (first minimum wins, like min())
            j = -1
            for i in range(n):
                if not states[i].done and (j < 0 or states[i].h < states[j].h):
                    j = i
            st = states[j]

            # ---- Algorithm 2 for communication j -------------------------
            if not st.initialized:                  # lines 1–3: minimum config
                st.initialized = True
                # divide-and-conquer subspace pick (the AutoCCL framework
                # Lagom plugs into, Sec. 3.2): probe implementation-related
                # params at a mid-resource point, keep the best, then restart
                # from minimum.
                subs = (("ring", "mixed"), ("ring", "bulk"),
                        ("tree", "mixed"), ("bidir", "bulk"))
                probe_lists = []
                for algo, proto in subs:
                    probe = st.cfg.with_(algorithm=algo, protocol=proto,
                                         nc=4, chunk_kb=1024)
                    cfgs = [states[i].cfg for i in range(n)]
                    cfgs[j] = probe
                    probe_lists.append(cfgs)
                best_sub, best_x = None, math.inf
                for (algo, proto), m in zip(subs, (yield probe_lists)):
                    if m.comm_times[j] < best_x:
                        best_sub, best_x = (algo, proto), m.comm_times[j]
                if warm_start:  # keep the cost-model seed, adopt the subspace
                    st.cfg = st.cfg.with_(algorithm=best_sub[0],
                                          protocol=best_sub[1])
                else:           # paper-faithful: restart from the minimum
                    st.cfg = min_config(st.cfg).with_(algorithm=best_sub[0],
                                                      protocol=best_sub[1])
                cand = st.cfg
                cfgs = [states[i].cfg for i in range(n)]
                cfgs[j] = cand
                meas = (yield [cfgs])[0]
            else:
                cands = _grow_candidates(st.cfg, st.lr, shrink=warm_start)
                if not cands:                       # all dials saturated
                    st.done = True
                    st.cfg = st.cfg.with_(done=True)
                    continue
                cfgs = [states[i].cfg for i in range(n)]
                cand_lists = []
                for _, c in cands:
                    cl = list(cfgs)
                    cl[j] = c
                    cand_lists.append(cl)
                best = None                         # step the best dial
                for (_, c), m in zip(cands, (yield cand_lists)):
                    if best is None or m.Z < best[1].Z:
                        best = (c, m)
                cand, meas = best
                cfgs[j] = cand
                # warm mode is Z-driven: no candidate improves -> done.  A
                # cost-model warm start chases 0.2% gains (it must correct
                # model error); a plan-seeded re-tune already starts from a
                # searched optimum, so it only keeps moving for >=1% gains —
                # that is what keeps drift-scoped re-tunes far cheaper than
                # a cold tune.
                min_gain = 0.99 if self.seed_cfgs is not None else 0.998
                if warm_start and prev_meas is not None \
                        and meas.Z >= prev_meas.Z * min_gain:
                    st.done = True
                    st.cfg = st.cfg.with_(done=True)
                    st.h = math.inf
                    continue
            x_new = meas.comm_times[j]
            X_, Y_ = meas.X, meas.Y
            y_before = prev_meas.Y if prev_meas is not None else Y_
            x_before = st.last_x

            trace.append(dict(step=steps, comm=j, cfg=cand, x=x_new, X=X_,
                              Y=Y_, Z=meas.Z, h=st.h))

            # line 5: terminate if comm got slower, or comm fully hidden.
            # (2% guard band: profiles are noisy; the paper's real system
            # faces the same jitter on wall-clock measurements)
            # warm-start mode is purely Z-driven: skip the paper's x/X<Y stops.
            if warm_start:
                st.cfg = cand
                st.last_x = x_new
                prev_meas = meas
                continue
            if x_new - x_before > 0.02 * x_before \
                    and not math.isinf(st.last_x):
                st.done = True                      # revert: keep st.cfg
                st.cfg = st.cfg.with_(done=True)
                st.h = math.inf
                continue
            if X_ < Y_:
                # crossed the X=Y boundary (§3.4 condition 3): the optimum
                # sits between the previous config and this one — bisect
                # toward it.
                best_cfg, best_z = cand, meas.Z
                lo, hi = st.cfg, cand
                for _ in range(3):
                    mid = _midpoint(lo, hi)
                    if mid in (lo, hi):
                        break
                    cfgs[j] = mid
                    m2 = (yield [cfgs])[0]
                    trace.append(dict(step=steps, comm=j, cfg=mid,
                                      x=m2.comm_times[j], X=m2.X, Y=m2.Y,
                                      Z=m2.Z, h=st.h, bisect=True))
                    if m2.Z < best_z:
                        best_cfg, best_z = mid, m2.Z
                    if m2.X < m2.Y:
                        hi = mid    # still past the boundary — shrink down
                    else:
                        lo = mid
                st.cfg = best_cfg.with_(done=True)
                st.done = True
                st.last_x = x_new
                prev_meas = meas
                continue

            # accept; lines 8–11: grow by relative improvement
            if not math.isinf(st.last_x):
                st.lr = max(0.0, (x_before - x_new) / max(x_new, 1e-12))
                st.h = priority.metric_h(y_before, Y_, x_before, x_new)
            st.cfg = cand
            st.last_x = x_new
            st.history.append((cand, x_new))
            prev_meas = meas


def tune_group(sim: Simulator, group: OverlapGroup, *,
               base: Optional[CommConfig] = None,
               warm_start: bool = False,
               seed_cfgs: Optional[List[CommConfig]] = None,
               max_steps: int = 200) -> TuneResult:
    """Drive one ``GroupSearch`` to completion (the serial walk)."""
    gs = GroupSearch(group, sim.hw, base=base, warm_start=warm_start,
                     seed_cfgs=seed_cfgs, max_steps=max_steps)
    while not gs.done:
        gs.feed(sim.profile_many(group, gs.pending))
    return gs.result()


def search_workload(sim: Simulator, wl: Workload, *,
                    mode: str = "interleaved",
                    base: Optional[CommConfig] = None,
                    warm_start: bool = False,
                    ) -> Tuple[ConfigSet, int, List[Dict]]:
    """Tune every overlap group; groups are independent (their comms only
    contend within their own window), so their searches interleave into one
    cross-group engine call per step by default — and whenever trajectory
    sharing is sound (deterministic mode, or CRN noise: see
    ``Simulator.can_share_trajectories``) structurally identical groups
    share one trajectory outright (scheduler.run_shared).

    ``mode`` selects the schedule (``scheduler.MODES``): ``"serial"`` is
    the reference group walk, ``"interleaved"`` (default) the cross-group
    lock-step pipeline with opportunistic sharing, and ``"shared"``
    requires sharing soundness up front.  In deterministic and CRN modes
    all three return identical configs, traces, and ``profile_count``.

    This is the engine entry the session front door (``core.session``)
    drives; prefer ``session.tune`` unless you already hold a Simulator."""
    from repro_torch.core.profiling import group_fingerprint

    def make(g):
        return GroupSearch(g, sim.hw, base=base, warm_start=warm_start)

    per_group = run_workload(sim, wl.groups, make, group_fingerprint, mode)
    configs: ConfigSet = {}
    iters = 0
    traces: List[Dict] = []
    for gi, gs in enumerate(per_group):
        res = gs.result()
        for ci, cfg in enumerate(res.configs):
            configs[(gi, ci)] = cfg
        iters += res.iterations
        traces.extend(dict(group=gi, **t) for t in res.trace)
    return configs, iters, traces


def tune_workload(sim: Simulator, wl: Workload, *,
                  base: Optional[CommConfig] = None,
                  warm_start: bool = False,
                  interleave: bool = True) -> Tuple[ConfigSet, int, List[Dict]]:
    """Deprecated pre-session entry point (one release of grace): the
    legacy 3-tuple signature, bit-identical to ``search_workload`` with
    ``mode="interleaved" if interleave else "serial"``.  Use
    ``repro_torch.core.session.tune(..., method="lagom")`` instead."""
    warnings.warn(
        "tuner.tune_workload is deprecated; use repro_torch.core.session.tune("
        "wl, hw, method='lagom', mode=...) — or tuner.search_workload for "
        "an existing Simulator — and will be removed next release",
        DeprecationWarning, stacklevel=2)
    return search_workload(sim, wl,
                           mode="interleaved" if interleave else "serial",
                           base=base, warm_start=warm_start)
