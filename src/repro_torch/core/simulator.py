"""The port's own copy of ``repro.core.simulator``.

Event-driven overlap simulator — the ProfileTime oracle.

Plays the role of the paper's online profiling step (DESIGN.md §2 deviation
1): two serialized streams (computation / communication) advance in
continuous time; whichever communication is active at an instant sets the
computation's instantaneous rate via the contention model, and vice versa
(reciprocal bandwidth steal).  The tuners treat this as a black box:
``profile(workload, configs) -> Measurement``.

Optional multiplicative lognormal noise emulates real measurement jitter so
the search algorithms cannot overfit exact model values.  The jitter comes
from counter-based Philox streams (``core.noise``): every noisy submission
holds a ticket ``(stream key, submission index)`` and its multipliers are a
pure function of that ticket, so the batched engine and the scalar
reference path below consume bit-identical values.  ``noise_mode``
selects the ticket policy — ``"default"`` (independent draws in flat
submission order) or ``"crn"`` (common random numbers keyed on the group's
structural fingerprint, which makes trajectory sharing sound under
jitter); see the ``core.noise`` module docstring for the full contract.

``faults=`` attaches a scripted :class:`~repro_torch.core.faults.FaultSchedule`:
each logical ProfileTime invocation advances the fault clock by one step
(``profile_many`` counts one step per candidate, in flat submission order,
so the clock agrees with a loop of ``profile_group`` calls), and any
active fault window reshapes that step's draws — degraded link hardware
for matching comm sites, a duration multiplier on comps, and an extra
deterministic jitter burst.  Faulted steps run on the scalar reference
path (bypassing the engine's structural caches, which are keyed on
healthy hardware); an empty schedule is normalized away entirely, so the
fault-free path — and its results — are byte-identical to ``faults=None``.
"""
from __future__ import annotations

import math
import numbers
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core import contention as C
from repro_torch.core.comm_params import CommConfig
from repro_torch.core.faults import FaultSchedule, FaultState
from repro_torch.core.hardware import Hardware
from repro_torch.core.noise import NOISE_MODES, NoiseModel
from repro_torch.core.topology import HierarchicalHardware
from repro_torch.core.workload import ConfigSet, OverlapGroup, Workload


@dataclass
class GroupMeasurement:
    name: str
    Z: float                       # group makespan
    X: float                       # total communication busy time
    Y: float                       # total computation busy time
    comm_times: List[float]        # measured x_j (with contention)
    comp_times: List[float]        # measured y_i (with contention)


@dataclass
class Measurement:
    Z: float                       # iteration makespan (Σ group makespans)
    groups: List[GroupMeasurement]

    @property
    def X(self):
        return sum(g.X for g in self.groups)

    @property
    def Y(self):
        return sum(g.Y for g in self.groups)


class Simulator:
    """ProfileTime oracle.  ``batched=True`` (default) routes measurements
    through the vectorized + cached ``profiling.BatchSimulator`` engine;
    ``batched=False`` keeps every call on the pure-Python event loop below
    (the reference path, used by equivalence tests and the
    ``benchmarks/tuning_throughput.py`` baseline).  Both paths are
    numerically identical — including the noise RNG stream."""

    def __init__(self, hw, *, noise: float = 0.0, seed: int = 0,
                 noise_mode: str = "default", batched: bool = True,
                 cache_size: int = 131072, faults: FaultSchedule = None):
        # ``hw`` may be a flat Hardware profile or a
        # ``topology.HierarchicalHardware``.  Flat topologies (pods == 1)
        # collapse to their bare island profile, so their entire code path
        # — and results — are byte-identical to passing the Hardware
        # directly.  Hierarchical ones keep the topology for per-comm tier
        # pricing in ``run_group``.
        topology = None
        if isinstance(hw, HierarchicalHardware):
            topology = None if hw.is_flat else hw
            hw = hw.island
        elif not isinstance(hw, Hardware):
            raise ValueError(
                "hw must be a Hardware profile or a HierarchicalHardware "
                f"topology, got {type(hw).__name__}")
        # eager argument validation: a bad seed or noise level otherwise
        # only surfaces as an opaque Philox/Box-Muller failure (or silent
        # NaN measurements) deep inside the first noisy profile call
        if noise_mode not in NOISE_MODES:
            raise ValueError(
                f"noise_mode must be one of {NOISE_MODES}, got {noise_mode!r}")
        if isinstance(seed, bool) or not isinstance(seed, numbers.Integral):
            raise ValueError(
                f"seed must be an int, got {type(seed).__name__} ({seed!r})")
        if isinstance(noise, bool) or not isinstance(noise, numbers.Real) \
                or math.isnan(noise) or math.isinf(noise) or noise < 0:
            raise ValueError(
                "noise must be a finite non-negative lognormal sigma, got "
                f"{noise!r}")
        if faults is not None and not isinstance(faults, FaultSchedule):
            raise ValueError(
                f"faults must be a FaultSchedule, got {type(faults).__name__}")
        self.hw = hw
        self.topology = topology
        self.noise = noise
        self.seed = seed
        self.noise_mode = noise_mode
        self._noise = NoiseModel(seed, noise, noise_mode) if noise else None
        self.profile_count = 0     # tuning-efficiency accounting (Fig. 8c)
        # hierarchical measurements run on the scalar reference path: the
        # engine's structural caches are keyed on a single healthy hardware
        # (same reason faulted steps bypass it)
        self.batched = batched and topology is None
        self._cache_size = cache_size
        self._engine = None
        # empty schedule -> None: the fault-free path is left untouched
        self.faults = faults if faults else None

    @property
    def can_share_trajectories(self) -> bool:
        """Whether structurally identical groups provably walk identical
        search trajectories, i.e. measurements are pure functions of
        (structure, configs, trajectory position): true noise-free and in
        CRN mode (fingerprint-keyed draws) — the soundness condition for
        ``scheduler.run_shared``.  A fault schedule breaks purity a second
        way: measurements then also depend on the global fault clock."""
        return (not self.noise or self.noise_mode == "crn") \
            and self.faults is None

    @property
    def engine(self):
        """The batched profiling engine (created lazily; import here avoids
        a simulator <-> profiling cycle)."""
        if self._engine is None:
            from repro_torch.core.profiling import BatchSimulator
            self._engine = BatchSimulator(self, cache_size=self._cache_size)
        return self._engine

    # -- single overlap group (sequential reference path) ----------------
    def run_group(self, g: OverlapGroup, cfgs: List[CommConfig], *,
                  fstate: FaultState = None) -> GroupMeasurement:
        assert len(cfgs) == len(g.comms)
        hw = self.hw
        if self.noise:
            # one ticket per submission; jitters are a pure function of it
            jit_comp, jit_comm = self._noise.group_jitters(
                g, len(g.comps), len(g.comms))
        else:
            jit_comp = [1.0] * len(g.comps)
            jit_comm = [1.0] * len(g.comms)

        comm_hw = None
        if self.topology is not None:
            # hierarchical topology: each comm prices on the fabric tier
            # its site spans — the pod-local island or the slow inter-pod
            # tier (which still carries the island's compute side, so
            # Eqs. 4-6 contention applies across tiers)
            comm_hw = [self.topology.comm_hardware(op) for op in g.comms]
        if fstate is not None:
            # active fault window: per-comm degraded link hardware (faults
            # degrade whichever tier the comm prices on), a global comp
            # slowdown, and this step's jitter burst folded into the
            # submission multipliers
            base_hw = comm_hw if comm_hw is not None else [hw] * len(g.comms)
            comm_hw = [
                fstate.hardware_for(op.site_id, op.name.split(".", 1)[0], bh)
                for op, bh in zip(g.comms, base_hw)]
            if fstate.comp_scale != 1.0:
                jit_comp = [j * fstate.comp_scale for j in jit_comp]
            if fstate.sigma:
                b_comp, b_comm = fstate.burst_jitters(
                    len(g.comps), len(g.comms))
                jit_comp = [j * b for j, b in zip(jit_comp, b_comp)]
                jit_comm = [j * b for j, b in zip(jit_comm, b_comm)]

        # remaining work is tracked in fractions of each op
        comp_left = [1.0] * len(g.comps)
        comm_left = [1.0] * len(g.comms)
        comp_busy = comm_busy = 0.0
        comm_meas = [0.0] * len(g.comms)
        comp_meas = [0.0] * len(g.comps)
        ci = ki = 0                 # heads of comp / comm streams
        t = 0.0
        guard = 0
        while ci < len(g.comps) or ki < len(g.comms):
            guard += 1
            if guard > 100000:
                raise RuntimeError("simulator did not converge")
            active_cfg = cfgs[ki] if ki < len(g.comms) else None
            comp_active = ci < len(g.comps)
            # the active comm's (possibly degraded) link sets the contention
            # terms for BOTH streams: a slower link shrinks the comm's
            # memory-bandwidth draw V, so overlapped compute responds too
            cur_hw = comm_hw[ki] if comm_hw is not None and ki < len(g.comms) \
                else hw

            comp_rate_dur = comm_rate_dur = math.inf
            if comp_active:
                comp_rate_dur = C.comp_time(g.comps[ci], active_cfg, cur_hw) * jit_comp[ci]
            if ki < len(g.comms):
                comm_rate_dur = C.comm_time(g.comms[ki], cfgs[ki], cur_hw,
                                            compute_active=comp_active) * jit_comm[ki]

            dt_options = []
            if comp_active:
                dt_options.append(comp_left[ci] * comp_rate_dur)
            if ki < len(g.comms):
                dt_options.append(comm_left[ki] * comm_rate_dur)
            dt = min(dt_options)
            t += dt
            if comp_active:
                comp_busy += dt
                comp_meas[ci] += dt
                comp_left[ci] -= dt / comp_rate_dur
                if comp_left[ci] <= 1e-12:
                    ci += 1
            if ki < len(g.comms):
                comm_busy += dt
                comm_meas[ki] += dt
                comm_left[ki] -= dt / comm_rate_dur
                if comm_left[ki] <= 1e-12:
                    ki += 1

        return GroupMeasurement(name=g.name, Z=t, X=comm_busy, Y=comp_busy,
                                comm_times=comm_meas, comp_times=comp_meas)

    def _fault_states(self, count: int):
        """The fault window for each of the next ``count`` logical
        invocations (fault clock = pre-increment ``profile_count``), or
        ``None`` when no window is active — the fault-free fast path."""
        if self.faults is None:
            return None
        states = [self.faults.state_at(self.profile_count + i)
                  for i in range(count)]
        return states if any(s is not None for s in states) else None

    # -- full workload ------------------------------------------------------
    def profile(self, wl: Workload, configs: ConfigSet) -> Measurement:
        states = self._fault_states(1)
        self.profile_count += 1
        gms = []
        for gi, g in enumerate(wl.groups):
            cfgs = [configs[(gi, ci)] for ci in range(len(g.comms))]
            if states is not None:
                gms.append(self.run_group(g, cfgs, fstate=states[0]))
            else:
                gms.append(self.engine.measure_one(g, cfgs) if self.batched
                           else self.run_group(g, cfgs))
        return Measurement(Z=sum(g.Z for g in gms), groups=gms)

    def profile_group(self, g: OverlapGroup, cfgs: List[CommConfig]) -> GroupMeasurement:
        states = self._fault_states(1)
        self.profile_count += 1
        if states is not None:
            return self.run_group(g, cfgs, fstate=states[0])
        if self.batched:
            return self.engine.measure_one(g, cfgs)
        return self.run_group(g, cfgs)

    def profile_many(self, g: OverlapGroup,
                     cfg_lists: List[List[CommConfig]]) -> List[GroupMeasurement]:
        """Batched ProfileTime: one logical invocation per candidate (the
        Fig. 8c counter sees exactly what a loop of ``profile_group`` calls
        would), evaluated in a single vectorized pass.  An empty candidate
        list returns ``[]`` without touching the engine or the counter.
        When a fault window covers any candidate's step, the whole call
        takes the scalar reference path (the two paths are bit-identical,
        so unfaulted candidates are unaffected) with per-candidate states."""
        if not cfg_lists:
            return []
        states = self._fault_states(len(cfg_lists))
        self.profile_count += len(cfg_lists)
        if states is not None:
            return [self.run_group(g, cfgs, fstate=s)
                    for cfgs, s in zip(cfg_lists, states)]
        if self.batched:
            return self.engine.measure_many(g, cfg_lists)
        return [self.run_group(g, cfgs) for cfgs in cfg_lists]

    def profile_many_grouped(
            self, requests: List[Tuple[OverlapGroup, List[List[CommConfig]]]],
    ) -> List[List[GroupMeasurement]]:
        """Cross-group batched ProfileTime for the tuning scheduler: every
        request is ``(group, cfg_lists)`` and the result lists align with
        the requests.  Accounting is unchanged — one logical invocation per
        candidate, summed across requests, so an interleaved schedule
        reports the same ``profile_count`` as the serial walk.  In noisy
        mode the reference path consumes the jitter RNG in flat submission
        order, matching the engine's draw contract (core.scheduler); the
        fault clock ticks in the same flat candidate order."""
        total = sum(len(cfg_lists) for _, cfg_lists in requests)
        if not total:
            return [[] for _ in requests]
        states = self._fault_states(total)
        self.profile_count += total
        if states is not None:
            out, k = [], 0
            for g, cfg_lists in requests:
                row = []
                for cfgs in cfg_lists:
                    row.append(self.run_group(g, cfgs, fstate=states[k]))
                    k += 1
                out.append(row)
            return out
        if self.batched:
            return self.engine.measure_many_grouped(requests)
        return [[self.run_group(g, cfgs) for cfgs in cfg_lists]
                for g, cfg_lists in requests]
