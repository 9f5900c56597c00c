"""The port's own copy of ``repro.core.session``.

One front door for the tuning product surface: ``tune`` -> ``TunedPlan``.

The engine stack underneath (batched profiling, cross-group scheduling,
counter-based noise) grew fast, but every caller still hand-wired a
``Simulator``, picked among ``tuner.tune_workload`` (3-tuple),
``autoccl.tune_workload`` (2-tuple) and ``baselines.nccl_defaults``, then
separately threaded configs through ``core.apply`` — the tune -> profile ->
compare -> apply loop was duplicated across every example, benchmark and
launcher.  This module is the paper's actual pitch ("co-tune once, deploy
the plan") as an API:

``tune(workload, hardware, *, method, mode, noise, noise_mode, seed)``
    One call, any registered search method, returning a ``TunedPlan``.

``TunedPlan``
    A first-class, persistable artifact: tuned configs plus provenance
    (method, hardware, workload structural fingerprint, seed, noise mode),
    per-step traces, ``profile_count`` and engine cache telemetry.  It
    round-trips through JSON (``save``/``load``/``to_json``/``from_json``),
    refuses to act on a structurally different workload
    (``PlanMismatchError``), lowers itself to runtime knobs
    (``runtime_plan``, self-contained — the embedded site metadata means a
    deserialized plan needs no workload object), and produces the speedup
    rows the benchmarks print (``compare``).

``SearchBackend`` registry
    The built-in methods (``"lagom"``, ``"autoccl"``, ``"nccl"``) are
    plain registry entries; third-party tuners join with::

        @register_backend("mytuner")
        class MyBackend:
            def search(self, sim, wl, *, mode, **options):
                return SearchOutcome(configs, profile_count, traces)

    and are immediately addressable as ``tune(..., method="mytuner")``.

Scheduling ``mode`` (``scheduler.MODES``): ``"serial"`` is the reference
per-group walk, ``"interleaved"`` (default) the cross-group lock-step
pipeline with trajectory sharing whenever sound, ``"shared"`` requires
sharing soundness up front.  Deterministic and CRN-noise searches return
byte-identical configs under all three.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional, Protocol, Union, runtime_checkable

from repro_torch.core.comm_params import CommConfig
from repro_torch.core.faults import FaultSchedule, parse_fault_schedule
from repro_torch.core.hardware import Hardware, by_name, profiles
from repro_torch.core.scheduler import MODES, resolve_mode
from repro_torch.core.simulator import Measurement, Simulator
from repro_torch.core.topology import HierarchicalHardware, resolve_topology
from repro_torch.core.workload import (ConfigSet, Workload, comm_site_meta,
                                       structure_components)

PLAN_VERSION = 1


def workload_fingerprint(wl: Workload) -> str:
    """Structural identity of a whole workload: the per-group fingerprints
    the profiling cache keys on (op shapes/bytes, names excluded), hashed
    so plans can carry it as a short provenance string.  Two workloads
    with equal fingerprints are indistinguishable to the contention model,
    which is exactly the condition under which re-applying a plan is
    sound."""
    from repro_torch.core.profiling import group_fingerprint

    payload = repr(tuple(group_fingerprint(g) for g in wl.groups))
    return hashlib.sha256(payload.encode()).hexdigest()


def structure_fingerprint(wl: Workload) -> str:
    """Shape-free sibling of ``workload_fingerprint``: hashes
    ``workload.structure_components`` (names, comm kinds/group sizes,
    SiteIds — no payload magnitudes), so it is invariant under batch/seq
    drift.  This is the key tolerance-band repository resolution matches
    on: an exact-fingerprint miss may still be a structural hit at a
    nearby shape."""
    payload = repr(structure_components(wl))
    return hashlib.sha256(payload.encode()).hexdigest()


def workload_shape(wl: Workload) -> Dict[str, int]:
    """The banded shape coordinates a plan carries as provenance
    (``TunedPlan.shape``): seq/global_batch from the workload meta."""
    return {k: int(wl.meta[k]) for k in ("seq", "global_batch")
            if k in wl.meta}


class PlanMismatchError(ValueError):
    """Raised when a ``TunedPlan`` is applied to a workload whose
    structural fingerprint differs from the one it was tuned on."""


# ---------------------------------------------------------------------------
# search-backend registry
# ---------------------------------------------------------------------------

@dataclass
class SearchOutcome:
    """What a backend hands back: tuned configs for every comm site, the
    number of logical ProfileTime invocations spent, and optional per-step
    trace rows (dicts; ``cfg`` entries may be ``CommConfig``)."""
    configs: ConfigSet
    profile_count: int = 0
    traces: List[Dict] = field(default_factory=list)


@runtime_checkable
class SearchBackend(Protocol):
    """A tuning method: anything with
    ``search(sim, wl, *, mode, **options) -> SearchOutcome``."""

    def search(self, sim: Simulator, wl: Workload, *, mode: str,
               **options) -> SearchOutcome: ...


_BACKENDS: Dict[str, SearchBackend] = {}


def register_backend(name: str, *, overwrite: bool = False) -> Callable:
    """Class/instance decorator registering a ``SearchBackend`` under
    ``name`` (classes are instantiated with no arguments).  The method is
    immediately addressable as ``tune(..., method=name)``."""
    def deco(obj):
        if name in _BACKENDS and not overwrite:
            raise ValueError(f"search backend {name!r} already registered "
                             "(pass overwrite=True to replace it)")
        backend = obj() if isinstance(obj, type) else obj
        if not callable(getattr(backend, "search", None)):
            raise TypeError(f"backend {name!r} must expose a "
                            "search(sim, wl, *, mode, **options) method")
        _BACKENDS[name] = backend
        return obj
    return deco


def unregister_backend(name: str) -> None:
    _BACKENDS.pop(name, None)


def available_methods() -> List[str]:
    return sorted(_BACKENDS)


def get_backend(name: str) -> SearchBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown tuning method {name!r}; registered: "
                       f"{available_methods()}") from None


@register_backend("lagom")
class LagomBackend:
    """Algorithms 1–2 (``core.tuner``); options: ``base``, ``warm_start``."""

    def search(self, sim, wl, *, mode, base=None, warm_start=False):
        from repro_torch.core import tuner
        configs, iters, traces = tuner.search_workload(
            sim, wl, mode=mode, base=base, warm_start=warm_start)
        return SearchOutcome(configs, iters, traces)


@register_backend("autoccl")
class AutoCCLBackend:
    """AutoCCL [NSDI'25] coordinate descent (``core.autoccl``).  Takes no
    options — an unexpected one raises, same as the lagom backend."""

    def search(self, sim, wl, *, mode):
        from repro_torch.core import autoccl
        configs, iters = autoccl.search_workload(sim, wl, mode=mode)
        return SearchOutcome(configs, iters, [])


@register_backend("nccl")
class NCCLBackend:
    """Vendor defaults (``core.baselines``) — zero profiles, the un-tuned
    baseline as a plan so it composes with ``compare``/``runtime_plan``."""

    def search(self, sim, wl, *, mode):
        from repro_torch.core import baselines
        return SearchOutcome(baselines.nccl_defaults(wl, sim.hw), 0, [])


# ---------------------------------------------------------------------------
# the portable artifact
# ---------------------------------------------------------------------------

# derived, not hand-listed: a field added to CommConfig can never be
# silently dropped from saved plans
_CFG_FIELDS = tuple(f.name for f in fields(CommConfig))


def _cfg_to_dict(cfg: CommConfig) -> Dict:
    return {f: getattr(cfg, f) for f in _CFG_FIELDS}


def _cfg_from_dict(d: Dict) -> CommConfig:
    return CommConfig(**{f: d[f] for f in _CFG_FIELDS})


def _trace_val_to_json(v):
    """Trace values hold two non-JSON types: ``CommConfig`` rows and the
    non-finite floats of Algorithm 1's H metric (``inf`` marks a finished
    comm).  Both get *tagged* dict encodings — applied recursively and
    under any trace key, so third-party backend traces (nested lists/dicts
    included; tuples come back as lists, as in any JSON) round-trip too —
    and the emitted document is strict RFC JSON
    (``json.dumps(allow_nan=True)`` would write the bare ``Infinity``
    token, which jq/JS/most non-Python readers reject)."""
    if isinstance(v, CommConfig):
        return {"__commconfig__": _cfg_to_dict(v)}
    if isinstance(v, float) and not math.isfinite(v):
        return {"__nonfinite__": repr(v)}
    if isinstance(v, (list, tuple)):
        return [_trace_val_to_json(x) for x in v]
    if isinstance(v, dict):
        return {k: _trace_val_to_json(x) for k, x in v.items()}
    return v


def _trace_val_from_json(v):
    if isinstance(v, dict):
        if "__nonfinite__" in v:
            return float(v["__nonfinite__"])
        if "__commconfig__" in v:
            return _cfg_from_dict(v["__commconfig__"])
        return {k: _trace_val_from_json(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_trace_val_from_json(x) for x in v]
    return v


@dataclass
class TunedPlan:
    """A tuned-configuration artifact with provenance — persist it, diff
    it, ship it to the runtime.  Produced by ``tune`` (cold) or ``retune``
    (warm, drift-scoped — provenance in ``.lineage``); self-contained: the
    embedded ``sites`` metadata (one row per comm site: name, kind, payload
    bytes) lets a deserialized plan lower itself to runtime knobs without
    the workload object, while ``fingerprint`` guards every
    workload-taking operation against structural mismatch.

    Example — tune, round-trip through JSON, check identity::

        >>> from repro_torch.configs import get_smoke_config
        >>> from repro_torch.core import ParallelPlan, extract_decode_workload
        >>> wl = extract_decode_workload(
        ...     get_smoke_config("llama3-8b"), ParallelPlan(kind="tp", tp=2),
        ...     global_batch=8, seq=64)
        >>> plan = tune(wl, "h100-sxm", method="nccl")
        >>> again = TunedPlan.from_json(plan.to_json())
        >>> again.configs == plan.configs
        True
        >>> again.artifact_digest() == plan.artifact_digest()
        True
        >>> plan.matches(wl) and not plan.lineage
        True
    """
    method: str                    # registry name that produced the configs
    mode: str                      # scheduling mode it searched under
    hardware: str                  # Hardware.name it was tuned for
    workload: str                  # Workload.name (informational)
    fingerprint: str               # workload_fingerprint at tune time
    seed: int
    noise: float
    noise_mode: str
    configs: ConfigSet = field(default_factory=dict)
    sites: List[Dict] = field(default_factory=list)
    profile_count: int = 0
    traces: List[Dict] = field(default_factory=list)
    cache_stats: Optional[Dict] = None
    # banded provenance (defaults keep pre-band plan files loading): the
    # shape-free structure_fingerprint and the (seq, global_batch) the plan
    # was tuned at — what tolerance-band repository resolution matches on.
    structure: str = ""
    shape: Dict = field(default_factory=dict)
    # fault provenance (empty for nominal plans; default keeps pre-fault
    # plan files loading): the schedule a plan was tuned under, or — for
    # robust plans — the ensemble, per-candidate regrets and the winner.
    faults: Dict = field(default_factory=dict)
    # retune lineage (empty for cold-tuned plans; default keeps pre-retune
    # plan files loading): ``retuned_from`` (parent artifact digest),
    # ``sites``/``groups`` (the drift scope), ``calibration`` (per-site
    # observed/predicted/scale deltas), ``generation`` and ``chain`` (every
    # ancestor digest, newest first) — see ``core.retune``.
    lineage: Dict = field(default_factory=dict)
    # hierarchical-fabric provenance (empty for flat-tuned plans; default
    # keeps pre-topology plan files loading): ``fingerprint``/``name`` of
    # the ``core.topology.HierarchicalHardware`` the plan was tuned under
    # plus its full ``spec`` (``to_dict``), so ``evaluate`` can rebuild the
    # exact two-tier simulator and ``check_topology`` can refuse a
    # different fabric — a cross-pod plan applied to a flat cluster is as
    # unsound as one for the wrong model.
    topology: Dict = field(default_factory=dict)
    version: int = PLAN_VERSION

    # -- identity ----------------------------------------------------------
    def artifact_digest(self) -> str:
        """Content hash of the whole serialized artifact (sha256 hex of
        ``to_json()``) — the identity retune lineage records ancestors by.

        Returns:
            64-char hex string; equal plans (all fields, configs and
            traces included) digest equally, any edit moves it.
        """
        return hashlib.sha256(self.to_json(indent=None).encode()).hexdigest()

    # -- structural guard --------------------------------------------------
    def matches(self, wl: Workload) -> bool:
        return self.fingerprint == workload_fingerprint(wl)

    def matches_structure(self, wl: Workload) -> bool:
        """Shape-free match: same program at a possibly different
        batch/seq.  Pre-band plans (no recorded structure) never match."""
        return bool(self.structure) and self.structure == structure_fingerprint(wl)

    def check(self, wl: Workload) -> None:
        fp = workload_fingerprint(wl)
        if fp != self.fingerprint:
            raise PlanMismatchError(
                f"plan was tuned on {self.workload!r} "
                f"(fingerprint {self.fingerprint[:12]}…) but workload "
                f"{wl.name!r} fingerprints to {fp[:12]}… — structures "
                "differ, re-applying the configs is unsound; re-tune")

    def check_topology(self, topology=None) -> None:
        """Refuse a fabric mismatch: a plan tuned under one
        ``HierarchicalHardware`` (or under the flat single-fabric model —
        empty ``self.topology``) must only be applied under the same one.
        ``topology`` accepts anything ``core.topology.resolve_topology``
        does; ``None`` (or a flat topology) asserts the plan is
        flat-tuned."""
        topo = resolve_topology(topology)
        want = "" if topo is None or topo.is_flat else topo.fingerprint()
        have = self.topology.get("fingerprint", "")
        if have != want:
            def lbl(fp, name):
                return f"{name} ({fp[:12]}…)" if fp else "flat single-fabric"
            raise PlanMismatchError(
                "plan was tuned under the "
                f"{lbl(have, self.topology.get('name', '?'))} topology but "
                f"is being applied under {lbl(want, topo.name if topo else '')}"
                " — cross-tier configs are unsound there; re-tune with "
                "tune(..., topology=...)")

    # -- apply / evaluate / compare ---------------------------------------
    def runtime_plan(self, wl: Optional[Workload] = None) -> Dict:
        """Lower to per-site runtime knobs (``core.apply``): one
        ``CollectiveRuntime`` per SiteId plus hierarchical prefix/class
        fallback entries, so two comm sites of one model can carry
        different chunk structure.  Self-contained via the embedded site
        metadata; pass the workload to assert it structurally matches
        before applying."""
        from repro_torch.core import apply as apply_mod

        if wl is not None:
            self.check(wl)
        return apply_mod.site_runtime_plan(self.sites, self.configs)

    @contextlib.contextmanager
    def applied(self, wl: Optional[Workload] = None):
        """Scope this plan's runtime knobs to a ``with`` block::

            with plan.applied():
                knobs = collectives.runtime_for("tp.layer0.mlp.ag", "ag")

        Nested ``applied()`` scopes shadow (innermost wins) and every exit
        path — normal or exceptional — restores the prior state; the
        process-global install (``core.apply.activate`` / the launchers'
        ``--tuned-plan``) stays untouched underneath.  Yields the lowered
        runtime plan."""
        from repro_torch.parallel import collectives

        rt = self.runtime_plan(wl)
        with collectives.use_runtime_plan(rt):
            yield rt

    # -- diffing -----------------------------------------------------------
    def diff(self, other: "TunedPlan") -> Dict:
        """Field-level config deltas vs ``other``, per site and only for
        changed fields::

            {"changed":    {site_id: {field: [self_val, other_val]}},
             "only_self":  [site_id, ...],   # sites other has no config for
             "only_other": [site_id, ...],
             "meta":       {field: [self_val, other_val]}}   # provenance

        Sites are labeled by SiteId (falling back to ``group:comm`` when a
        site is missing from the embedded metadata — e.g. diffing against
        a plan from a structurally different workload)."""
        def labels(plan):
            return {(s["group"], s["comm"]): s.get("site") or s["name"]
                    for s in plan.sites}

        lab = labels(self)
        lab.update({k: v for k, v in labels(other).items() if k not in lab})
        changed: Dict[str, Dict] = {}
        only_self: List[str] = []
        only_other: List[str] = []
        for key in sorted(set(self.configs) | set(other.configs)):
            sid = lab.get(key, f"{key[0]}:{key[1]}")
            a, b = self.configs.get(key), other.configs.get(key)
            if b is None:
                only_self.append(sid)
                continue
            if a is None:
                only_other.append(sid)
                continue
            delta = {f: [getattr(a, f), getattr(b, f)] for f in _CFG_FIELDS
                     if getattr(a, f) != getattr(b, f)}
            if delta:
                changed[sid] = delta
        meta = {f: [getattr(self, f), getattr(other, f)]
                for f in ("method", "mode", "hardware", "workload",
                          "fingerprint", "seed", "noise", "noise_mode")
                if getattr(self, f) != getattr(other, f)}
        return {"changed": changed, "only_self": only_self,
                "only_other": only_other, "meta": meta}

    def _hw(self):
        """The simulation target the plan was tuned for: the recorded
        ``HierarchicalHardware`` when topology provenance is present
        (hierarchical names are not registry profiles — the embedded spec
        is authoritative), else the named flat profile."""
        if self.topology.get("spec"):
            return HierarchicalHardware.from_dict(self.topology["spec"])
        try:
            return by_name(self.hardware)
        except KeyError:
            raise KeyError(
                f"plan hardware {self.hardware!r} is not a registered "
                f"profile ({profiles()}); pass an explicit sim= to "
                "evaluate/compare") from None

    def evaluate(self, wl: Workload, *, sim: Optional[Simulator] = None,
                 faults=None) -> Measurement:
        """Profile the plan's configs on its workload (fingerprint-checked).
        Defaults to a fresh deterministic simulator on the plan's hardware
        profile — or, for a topology-tuned plan, on the recorded
        ``HierarchicalHardware`` rebuilt from provenance — so evaluations
        are stable; pass ``sim=`` to evaluate under jitter or on shared RNG
        state, or ``faults=`` (a ``FaultSchedule``, inline spec, or
        schedule-file path) to evaluate under a scripted fault — the fresh
        simulator's fault clock starts at step 0."""
        if faults is not None:
            if sim is not None:
                raise ValueError("sim= carries its own fault schedule; "
                                 "pass faults= or sim=, not both")
            sim = Simulator(self._hw(), faults=parse_fault_schedule(faults))
        self.check(wl)
        sim = sim or Simulator(self._hw())
        return sim.profile(wl, self.configs)

    def compare(self, other: "TunedPlan", wl: Workload, *,
                sim: Optional[Simulator] = None) -> Dict:
        """The speedup row the benchmarks print; ``speedup`` = how much
        faster this plan's makespan is than ``other``'s.  Deterministic by
        default (a fresh noise-free simulator on the plan's hardware).
        For a *paired* noisy comparison, evaluate each plan on its own
        fresh ``noise_mode="crn"`` simulator with one seed — CRN draws are
        a pure function of (structure, trajectory position), so both
        evaluations then see identical jitter; a shared default-noise
        simulator gives independent draws, not pairing."""
        sim = sim or Simulator(self._hw())
        mine = self.evaluate(wl, sim=sim)
        theirs = other.evaluate(wl, sim=sim)
        return dict(workload=wl.name, method=self.method,
                    baseline=other.method,
                    z_ms=mine.Z * 1e3, baseline_z_ms=theirs.Z * 1e3,
                    speedup=theirs.Z / mine.Z,
                    profiles=self.profile_count,
                    baseline_profiles=other.profile_count)

    # -- serialization -----------------------------------------------------
    def to_json(self, *, indent: Optional[int] = 2) -> str:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["configs"] = [dict(group=gi, comm=ci, **_cfg_to_dict(cfg))
                        for (gi, ci), cfg in sorted(self.configs.items())]
        d["traces"] = [_trace_val_to_json(t) for t in self.traces]
        return json.dumps(d, indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "TunedPlan":
        d = json.loads(text)
        version = d.pop("version", None)
        if version != PLAN_VERSION:
            raise ValueError(f"unsupported TunedPlan version {version!r} "
                             f"(this build reads version {PLAN_VERSION})")
        d["configs"] = {(c["group"], c["comm"]): _cfg_from_dict(c)
                        for c in d["configs"]}
        d["traces"] = [_trace_val_from_json(t) for t in d["traces"]]
        return cls(version=PLAN_VERSION, **d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TunedPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def load_plan(path: str) -> TunedPlan:
    """Module-level alias for ``TunedPlan.load`` (launcher convenience)."""
    return TunedPlan.load(path)


def _lookup_hw(hardware: Union[Hardware, str]) -> Hardware:
    # names resolve through the core.hardware registry (its KeyError
    # already lists the registered profiles)
    return by_name(hardware) if isinstance(hardware, str) else hardware


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

def _search_to_plan(backend, method: str, mode: str, sim: Simulator,
                    workload: Workload, options: Dict,
                    faults_meta: Optional[Dict] = None) -> TunedPlan:
    """One search on ``sim`` lowered to a ``TunedPlan`` (the shared tail of
    nominal, faulted and robust tuning)."""
    resolved = resolve_mode(sim, mode)
    outcome = backend.search(sim, workload, mode=resolved, **options)
    stats = (sim.engine.cache_stats()
             if sim.batched and sim._engine is not None else None)
    # provenance follows the simulator actually searched on: a hierarchical
    # one stamps its topology (and keys the plan on the topology's
    # repo-safe name); a flat one leaves topology empty — byte-identical
    # to pre-topology plans
    topo_meta, hw_name = {}, sim.hw.name
    if sim.topology is not None:
        topo_meta = {"fingerprint": sim.topology.fingerprint(),
                     "name": sim.topology.name,
                     "spec": sim.topology.to_dict()}
        hw_name = sim.topology.name
    return TunedPlan(
        method=method, mode=resolved, hardware=hw_name,
        workload=workload.name, fingerprint=workload_fingerprint(workload),
        seed=sim.seed, noise=sim.noise, noise_mode=sim.noise_mode,
        configs=dict(outcome.configs), sites=comm_site_meta(workload),
        profile_count=outcome.profile_count, traces=list(outcome.traces),
        cache_stats=stats, structure=structure_fingerprint(workload),
        shape=workload_shape(workload), faults=dict(faults_meta or {}),
        topology=topo_meta)


def _scenario_states(sched: Optional[FaultSchedule]) -> List:
    """The distinct fault windows a scenario can present — ``None`` (the
    healthy window) plus every unique active state over the schedule's
    horizon.  Worst-case scoring over these captures transient events
    (flaps, late-start degradations) that a single step-0 probe would
    miss."""
    states = [None]
    if sched is None:
        return states
    horizon = 1
    for ev in sched.events:
        horizon = max(horizon,
                      ev.stop if ev.stop is not None
                      else ev.start + max(1, ev.period))
    seen = set()
    for step in range(horizon):
        st = sched.state_at(step)
        if st is None:
            continue
        key = (st.comp_scale, st.sigma, st.comm_events)
        if key not in seen:
            seen.add(key)
            states.append(st)
    return states


def _robust_tune(backend, method: str, mode: str, workload: Workload,
                 hw: Hardware, sim_kw: Dict, ensemble: List[FaultSchedule],
                 options: Dict) -> TunedPlan:
    """Minimax-regret tuning over a fault ensemble: tune one candidate per
    scenario (nominal + each schedule), score every candidate's worst-case
    makespan under every scenario's fault windows, and keep the candidate
    whose worst regret vs the per-scenario best is smallest (ties break
    toward better nominal time).  The winner's ``faults`` provenance
    records the ensemble, the per-candidate regrets and the total search
    cost; its own ``profile_count`` stays its search cost."""
    scenarios: List[Optional[FaultSchedule]] = [None] + list(ensemble)
    labels = ["nominal"] + [f"robust[{i}]" for i in range(len(ensemble))]
    candidates: List[TunedPlan] = []
    for sched in scenarios:
        sim = Simulator(hw, faults=sched, **sim_kw)
        candidates.append(
            _search_to_plan(backend, method, mode, sim, workload, options))

    # score on the scalar reference path with an explicit fault window, so
    # every candidate sees each scenario's exact degraded physics
    eval_sim = Simulator(hw, batched=False)
    eval_profiles = 0

    def worst_z(plan: TunedPlan, sched: Optional[FaultSchedule]) -> float:
        nonlocal eval_profiles
        worst = 0.0
        for st in _scenario_states(sched):
            z = 0.0
            for gi, g in enumerate(workload.groups):
                cfgs = [plan.configs[(gi, ci)] for ci in range(len(g.comms))]
                z += eval_sim.run_group(g, cfgs, fstate=st).Z
            eval_profiles += 1
            worst = max(worst, z)
        return worst

    z_table = [[worst_z(c, sched) for sched in scenarios]
               for c in candidates]
    best = [min(z_table[c][s] for c in range(len(candidates)))
            for s in range(len(scenarios))]
    regrets = [max(z_table[c][s] - best[s] for s in range(len(scenarios)))
               for c in range(len(candidates))]
    win = min(range(len(candidates)),
              key=lambda c: (regrets[c], z_table[c][0]))

    plan = candidates[win]
    plan.faults = {
        "robust": True,
        "ensemble": [s.to_dict() for s in ensemble],
        "selected": labels[win],
        "worst_case_regret": regrets[win],
        "regrets": dict(zip(labels, regrets)),
        "nominal_z": z_table[win][0],
        "total_profiles": sum(c.profile_count for c in candidates)
        + eval_profiles,
    }
    return plan


def _lint_gate(plan: TunedPlan, workload: Workload, topology,
               lint: Optional[str]) -> None:
    """The ``tune(lint=...)`` hook: run the deployment linter
    (``repro_torch.analysis.lint``) on a freshly tuned plan before it is
    returned or persisted.  ``None``/``"off"`` skip, ``"warn"`` emits one
    ``RuntimeWarning`` carrying the findings, ``"error"`` raises
    ``PlanLintError`` on ERROR-severity findings (warnings still warn)."""
    if lint in (None, "off"):
        return
    if lint not in ("warn", "error"):
        raise ValueError(f"lint= must be None, 'off', 'warn' or 'error', "
                         f"got {lint!r}")
    from repro_torch.analysis.lint import (PlanLintError, errors,
                                           format_findings, lint_plan)

    findings = lint_plan(plan, workload=workload, topology=topology)
    if lint == "error" and errors(findings):
        raise PlanLintError(findings,
                            label=f"tuned plan for {workload.name!r}")
    if findings:
        import warnings

        warnings.warn(format_findings(findings, label=repr(workload.name)),
                      RuntimeWarning, stacklevel=3)


def tune(workload: Workload, hardware: Union[Hardware, str, None] = None, *,
         method: str = "lagom", mode: str = "interleaved",
         noise: float = 0.0, noise_mode: str = "default", seed: int = 0,
         batched: bool = True, simulator: Optional[Simulator] = None,
         repo=None, faults=None, fault_ensemble=None, topology=None,
         lint: Optional[str] = None, **options) -> TunedPlan:
    """Tune ``workload``'s collectives for ``hardware`` and return the
    result as a portable ``TunedPlan``.

    ``hardware`` is a ``Hardware`` profile or its registry name
    (``core.hardware.PROFILES``).  ``method`` selects a registered search
    backend (``available_methods()``); ``mode`` a schedule from
    ``scheduler.MODES``.  ``noise``/``noise_mode``/``seed``/``batched``
    configure the ProfileTime simulator exactly as ``Simulator(...)`` —
    configs are byte-identical to driving the per-method search by hand
    with the same simulator arguments.  Pass ``simulator=`` to reuse RNG
    state / engine caches instead (``hardware`` may then be omitted, and
    the simulator kwargs must stay unset — they would be silently shadowed
    otherwise, so that is rejected).  ``repo`` (a directory path or
    ``plan_repo.PlanRepository``) auto-``put``s the tuned plan under its
    (fingerprint, hardware) key so later launches with ``--plan-repo``
    resolve it with zero tuning work.

    Fault-aware tuning (``core.faults``): ``faults=`` (a ``FaultSchedule``,
    inline spec, or schedule-file path) injects scripted degradation into
    the search's ProfileTime draws and records the schedule as plan
    provenance — an empty schedule is a no-op and results stay
    byte-identical to the fault-free call.  ``fault_ensemble=`` (a list of
    schedules/specs) instead runs minimax-regret robust tuning: one
    candidate per scenario (nominal first), scored by worst-case makespan
    across all scenarios' fault windows; the returned plan carries the
    ensemble, regrets and total search cost in ``plan.faults``.  Both
    build their own simulators, so they reject ``simulator=``.

    Hierarchical tuning (``core.topology``): ``topology=`` (a
    ``HierarchicalHardware``, its ``to_dict()`` spec, or a saved-topology
    path) prices every comm against the fabric tier its site spans and
    stamps the topology fingerprint/spec into ``plan.topology`` (the plan
    then keys on the topology's name in repositories and refuses
    evaluation under a different fabric via ``check_topology``).  A flat
    topology (``pods == 1``) collapses to the bare island profile —
    results and provenance stay byte-identical to the single-fabric path.

    Static analysis (``repro_torch.analysis``): ``lint=`` runs the deployment
    linter on the tuned plan before it is returned or auto-``put`` —
    ``"warn"`` surfaces findings as one ``RuntimeWarning``, ``"error"``
    additionally raises ``PlanLintError`` on ERROR-severity findings (the
    plan is then neither returned nor persisted).  Default ``None`` skips.

    Remaining keyword ``options`` go to the backend (e.g. Lagom's
    ``warm_start``).

    Args:
        workload: the overlap-group IR to tune (``core.extract``).
        hardware: a ``Hardware`` profile or registry name; optional only
            when ``simulator=`` is passed.
        method/mode/noise/noise_mode/seed/batched: search backend,
            schedule and ProfileTime simulator knobs (see above).
        simulator: reuse an existing ``Simulator`` (RNG state, caches).
        repo: directory or ``PlanRepository`` to auto-``put`` into.
        faults / fault_ensemble: scripted degradation for fault-aware or
            minimax-robust tuning (see above).
        lint: deployment-linter gate on the result — ``None``/``"off"``,
            ``"warn"``, or ``"error"`` (see above).

    Returns:
        A ``TunedPlan`` carrying the configs and full provenance.

    Raises:
        KeyError: unknown ``method`` or ``hardware`` name.
        ValueError: conflicting simulator/hardware/fault arguments.

    Example::

        >>> from repro_torch.configs import get_smoke_config
        >>> from repro_torch.core import ParallelPlan, extract_decode_workload
        >>> wl = extract_decode_workload(
        ...     get_smoke_config("llama3-8b"), ParallelPlan(kind="tp", tp=2),
        ...     global_batch=8, seq=64)
        >>> plan = tune(wl, "h100-sxm", method="lagom")
        >>> plan.method, plan.profile_count > 0
        ('lagom', True)
    """
    backend = get_backend(method)
    topo = resolve_topology(topology)
    if topo is not None:
        if simulator is not None:
            raise ValueError(
                "topology= builds its own simulator; construct "
                "Simulator(topology) and pass simulator= alone (its "
                "topology lands in the plan provenance automatically)")
        if hardware is not None and _lookup_hw(hardware) != topo.island:
            raise ValueError(
                f"topology island {topo.island.name!r} conflicts with "
                "hardware=; pass one or the other")
        hardware = topo.island
        if topo.is_flat:
            topo = None   # degenerate single-pod case: plain flat tuning
    faults = parse_fault_schedule(faults)
    if not faults:
        faults = None            # empty schedule == fault-free tuning
    if faults is not None and fault_ensemble is not None:
        raise ValueError("pass faults= (tune under one schedule) or "
                         "fault_ensemble= (robust minimax tuning), not both")
    if simulator is not None:
        if faults is not None or fault_ensemble is not None:
            raise ValueError(
                "faults=/fault_ensemble= build their own simulators; drop "
                "simulator= (or construct Simulator(faults=...) yourself)")
        sim = simulator
        if hardware is not None:
            hw = _lookup_hw(hardware)
            if hw is not sim.hw:
                raise ValueError(
                    f"simulator hardware {sim.hw.name!r} conflicts with "
                    f"hardware={hw.name!r}; pass one or the other")
        if (noise, noise_mode, seed, batched) != (0.0, "default", 0, True):
            raise ValueError(
                "simulator= carries its own noise/noise_mode/seed/batched; "
                "configure the Simulator instead of passing them to tune()")
    else:
        if hardware is None:
            raise ValueError("pass hardware= (profile or name) or simulator=")
        hw = _lookup_hw(hardware)
        sim_kw = dict(noise=noise, seed=seed, noise_mode=noise_mode,
                      batched=batched)
        target = topo if topo is not None else hw
        if fault_ensemble is not None:
            ensemble = [parse_fault_schedule(f) for f in fault_ensemble]
            ensemble = [e for e in ensemble if e]
            if not ensemble:
                raise ValueError("fault_ensemble has no non-empty schedules")
            plan = _robust_tune(backend, method, mode, workload, target,
                                sim_kw, ensemble, options)
            _lint_gate(plan, workload, topo, lint)
            if repo is not None:
                from repro_torch.core.plan_repo import as_repository
                as_repository(repo).put(plan)
            return plan
        sim = Simulator(target, faults=faults, **sim_kw)
    # validate here, not just in the built-in backends, so mode errors and
    # the shared-soundness rejection are uniform across every method
    # (nccl, third-party backends included)
    faults_meta = {"schedule": faults.to_dict()} if faults is not None else {}
    plan = _search_to_plan(backend, method, mode, sim, workload, options,
                           faults_meta)
    _lint_gate(plan, workload,
               topo if topo is not None else getattr(sim, "topology", None),
               lint)
    if repo is not None:
        from repro_torch.core.plan_repo import as_repository
        as_repository(repo).put(plan)
    return plan


def retune(plan: TunedPlan, workload: Workload, *, sites=None,
           telemetry=None, hardware=None, repo=None,
           max_steps: Optional[int] = None) -> TunedPlan:
    """Drift-scoped warm re-tune of an installed plan (``core.retune``).

    Where ``tune`` searches every group from scratch, ``retune`` (1)
    calibrates the simulator's hardware model from observed per-site
    costs (``telemetry``), (2) re-searches only the comm groups owning
    the drifted ``sites`` — warm-started from ``plan``'s own configs,
    re-seeded at the calibrated cost model's balance point — and (3)
    returns a child ``TunedPlan`` whose ``lineage`` records the parent
    digest, drift scope and calibration deltas.  Untouched groups keep
    the parent's configs verbatim.

    Args:
        plan: the installed ``TunedPlan`` to warm-start from.
        workload: the live workload; must fingerprint-match ``plan``.
        sites: drifted SiteIds scoping the re-search (``None`` = every
            group, still warm-started).
        telemetry: observed per-site costs (seconds) — a ``{site: cost}``
            dict or a ``serving.telemetry.SiteTelemetry`` buffer (its
            most recent row is used).  ``None`` skips calibration.
        hardware: override profile (default: the plan's own).
        repo: directory or ``PlanRepository`` to auto-``put`` the child
            into (same key as the parent — the repo entry advances).
        max_steps: per-group search-step cap.

    Returns:
        A new ``TunedPlan`` with ``lineage["retuned_from"]`` set to
        ``plan.artifact_digest()``.

    Raises:
        PlanMismatchError: ``workload`` is structurally different from
            the one ``plan`` was tuned on.

    Example::

        >>> from repro_torch.configs import get_smoke_config
        >>> from repro_torch.core import ParallelPlan, extract_decode_workload
        >>> wl = extract_decode_workload(
        ...     get_smoke_config("llama3-8b"), ParallelPlan(kind="tp", tp=2),
        ...     global_batch=8, seq=64)
        >>> parent = tune(wl, "h100-sxm", method="lagom")
        >>> child = retune(parent, wl, sites=["serve.layer0.attn.ar"])
        >>> child.lineage["retuned_from"] == parent.artifact_digest()
        True
        >>> child.lineage["generation"]
        1
    """
    from repro_torch.core.retune import retune_plan  # lazy: retune imports session

    return retune_plan(plan, workload, sites=sites, telemetry=telemetry,
                       hardware=hardware, repo=repo, max_steps=max_steps)


__all__ = [
    "MODES", "PLAN_VERSION", "PlanMismatchError", "SearchBackend",
    "SearchOutcome", "TunedPlan", "available_methods", "get_backend",
    "load_plan", "register_backend", "retune", "structure_fingerprint",
    "tune", "unregister_backend", "workload_fingerprint", "workload_shape",
]


# ---------------------------------------------------------------------------
# CLI:  python -m repro_torch.core.session diff a.json b.json
# ---------------------------------------------------------------------------

def _format_diff(a_path: str, b_path: str, d: Dict) -> str:
    lines = [f"plan diff: {a_path} vs {b_path}"]
    for f, (va, vb) in sorted(d["meta"].items()):
        lines.append(f"  meta {f}: {va!r} -> {vb!r}")
    if not d["changed"] and not d["only_self"] and not d["only_other"]:
        lines.append("  configs: identical")
        return "\n".join(lines)
    for sid, delta in d["changed"].items():
        fields_ = ", ".join(f"{f}: {va!r} -> {vb!r}"
                            for f, (va, vb) in sorted(delta.items()))
        lines.append(f"  {sid}: {fields_}")
    for sid in d["only_self"]:
        lines.append(f"  {sid}: only in {a_path}")
    for sid in d["only_other"]:
        lines.append(f"  {sid}: only in {b_path}")
    lines.append(f"  ({len(d['changed'])} site(s) changed, "
                 f"{len(d['only_self'])} only-left, "
                 f"{len(d['only_other'])} only-right)")
    return "\n".join(lines)


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.session",
        description="TunedPlan artifact tooling")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff", help="field-level per-site config deltas "
                                    "between two saved plans")
    d.add_argument("a", help="baseline plan JSON")
    d.add_argument("b", help="comparison plan JSON")
    args = ap.parse_args(argv)
    if args.cmd == "diff":
        import sys

        plans = []
        for path in (args.a, args.b):
            # a missing file, non-JSON bytes, or JSON that is not a
            # TunedPlan artifact must exit with a clean diagnostic, not a
            # traceback — this CLI is wired into launch scripts
            try:
                plans.append(TunedPlan.load(path))
            except (OSError, ValueError, KeyError, TypeError) as e:
                print(f"error: {path}: not a readable TunedPlan artifact "
                      f"({e.__class__.__name__}: {e})", file=sys.stderr)
                return 2
        delta = plans[0].diff(plans[1])
        print(_format_diff(args.a, args.b, delta))
        return 0 if not (delta["changed"] or delta["only_self"]
                         or delta["only_other"] or delta["meta"]) else 1
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())
