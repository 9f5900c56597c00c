"""The port's own copy of ``repro.core.retune``.

Online re-tuning: live drift evidence -> calibrated, drift-scoped warm
re-search -> zero-downtime plan publish.

The offline pipeline tunes once and deploys the plan; this module is the
loop that keeps the plan true as the fabric changes underneath it.  Three
stages, each cheap by construction:

1. **Calibrate** (``calibrate_sites``): per drifted site, invert the
   contention model — find the bandwidth scale at which the site's tuned
   config would cost what telemetry actually observed — and express the
   result as an open-ended per-site ``degrade`` fault event.  A
   ``Simulator`` built on that schedule prices exactly the degraded
   fabric the engines are measuring, with zero profiling work.
2. **Warm re-search** (``retune_plan``): only the overlap groups owning
   drifted sites are re-searched.  Each drifted comm is re-seeded at the
   *calibrated* cost model's balance point (``tuner.warm_start_config``
   on the degraded hardware — the closed form does the big jump for
   free), non-drifted siblings seed from the installed plan verbatim,
   and the seeded ``GroupSearch`` refines with its Z-driven stop.  The
   result: an order-of-magnitude fewer ProfileTime calls than a cold
   full tune, with the same final makespan.
3. **Publish** (``RetuneService``): the child plan carries full lineage
   (parent digest, drift scope, calibration deltas, ancestor chain),
   lands in the ``PlanRepository`` under the same (fingerprint,
   hardware) key, and hot-swaps into the serving engine's
   ``PlanBinding`` between batches — compiled-step caches key on the
   plan digest, so the next batch retraces under the new configs and no
   token is ever dropped.

``RetuneService`` is the wiring: the engines hand it the sites their
``HealthMonitor`` flags (synchronous drive-by-tick — what
``launch/serve.py --retune`` and the tests use), or ``start()`` runs the
same ``tick`` on a background thread.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.core import contention
from repro_torch.core.comm_params import vendor_default
from repro_torch.core.faults import FaultEvent, FaultSchedule, degraded_hardware
from repro_torch.core.session import (
    PlanMismatchError,
    TunedPlan,
    _lookup_hw,
    structure_fingerprint,
    workload_shape,
)
from repro_torch.core.simulator import Simulator
from repro_torch.core.tuner import tune_group, warm_start_config
from repro_torch.core.workload import Workload, comm_site_meta

# a calibrated scale this close to 1.0 is measurement noise, not drift:
# no fault event is emitted and the site keeps its installed seed
_SCALE_NOISE_FLOOR = 0.999
_SCALE_MIN = 1e-3
DEFAULT_MAX_STEPS = 60


def _calibrate_scale(op, cfg, hw, observed: float) -> Tuple[float, float]:
    """Invert the contention model for one site: the bandwidth scale
    ``s`` at which ``comm_time(op, cfg, degraded_hardware(hw, s))``
    matches the observed cost.  Returns ``(scale, predicted_healthy)``;
    monotone geometric bisection (cost strictly rises as links slow), so
    ~40 iterations pin the scale to float precision with zero profiles."""
    predicted = contention.comm_time(op, cfg, hw, compute_active=False)
    if observed <= predicted * (1.0 + 1e-9):
        return 1.0, predicted  # at or below prediction: healthy
    worst = contention.comm_time(
        op, cfg, degraded_hardware(hw, _SCALE_MIN), compute_active=False
    )
    if worst < observed:
        return _SCALE_MIN, predicted  # beyond model range: clamp
    lo, hi = _SCALE_MIN, 1.0
    for _ in range(40):
        mid = math.sqrt(lo * hi)
        cost = contention.comm_time(
            op, cfg, degraded_hardware(hw, mid), compute_active=False
        )
        if cost > observed:
            lo = mid  # too slow a fabric -> raise the scale
        else:
            hi = mid
    return round(math.sqrt(lo * hi), 6), predicted


def calibrate_sites(
    plan: TunedPlan,
    workload: Workload,
    observed: Dict[str, float],
    sites: List[str],
    hw,
) -> Tuple[Dict, Optional[FaultSchedule]]:
    """Per-site hardware-model calibration from observed costs.

    Returns ``(calibration, schedule)``: one
    ``{site: {observed, predicted, scale}}`` row per calibrated site,
    plus a ``FaultSchedule`` of open-ended exact-site ``degrade`` events
    realizing those scales (``None`` when nothing drifted) — the
    schedule a re-tuning ``Simulator`` is built on."""
    by_site = {}
    for gi, g in enumerate(workload.groups):
        for ci, op in enumerate(g.comms):
            by_site[op.site_id] = (gi, ci, op)
    calibration: Dict[str, Dict] = {}
    events: List[FaultEvent] = []
    for sid in sorted(set(sites)):
        if sid not in by_site:
            raise ValueError(
                f"unknown drift site {sid!r}; workload sites: {sorted(by_site)}"
            )
        obs = observed.get(sid)
        if obs is None or obs <= 0:
            continue  # no evidence for this site: search uncalibrated
        gi, ci, op = by_site[sid]
        cfg = plan.configs.get((gi, ci)) or vendor_default(hw)
        scale, predicted = _calibrate_scale(op, cfg, hw, obs)
        calibration[sid] = {"observed": obs, "predicted": predicted, "scale": scale}
        if scale < _SCALE_NOISE_FLOOR:
            events.append(FaultEvent("degrade", site=sid, scale=scale, start=0))
    sched = FaultSchedule(events=tuple(events)) if events else None
    return calibration, sched


def retune_plan(
    plan: TunedPlan,
    workload: Workload,
    *,
    sites: Optional[List[str]] = None,
    telemetry=None,
    hardware=None,
    repo=None,
    max_steps: Optional[int] = None,
) -> TunedPlan:
    """Drift-scoped warm re-tune (the engine behind ``session.retune`` —
    see its docstring for the full argument contract).

    Only the overlap groups owning ``sites`` are re-searched; each
    drifted comm is re-seeded at the calibrated cost model's balance
    point, siblings and untouched groups keep the installed configs.
    The returned child plan's ``lineage`` records parentage
    (``retuned_from`` + ``chain``), the drift scope (``sites``,
    ``groups``) and the ``calibration`` deltas; ``faults["calibrated"]``
    carries the calibration schedule the search ran under."""
    plan.check(workload)
    hw = _lookup_hw(hardware if hardware is not None else plan.hardware)
    if hasattr(telemetry, "latest"):  # a SiteTelemetry ring buffer
        observed = telemetry.latest()
    else:
        observed = dict(telemetry or {})

    all_sites = {
        op.site_id: gi for gi, g in enumerate(workload.groups) for op in g.comms
    }
    if sites is None:
        scoped = sorted(range(len(workload.groups)))
        cal_sites = sorted(s for s in all_sites if s in observed)
    else:
        cal_sites = sorted(set(sites))
        unknown = [s for s in cal_sites if s not in all_sites]
        if unknown:
            raise ValueError(
                f"unknown drift site(s) {unknown}; workload sites: {sorted(all_sites)}"
            )
        scoped = sorted({all_sites[s] for s in cal_sites})

    calibration, sched = calibrate_sites(plan, workload, observed, cal_sites, hw)

    sim = Simulator(hw, faults=sched)
    configs = dict(plan.configs)
    profiles = 0
    traces: List[Dict] = []
    for gi in scoped:
        g = workload.groups[gi]
        seeds = []
        for ci, op in enumerate(g.comms):
            inst = plan.configs.get((gi, ci)) or vendor_default(hw)
            cal = calibration.get(op.site_id)
            if cal and cal["scale"] < _SCALE_NOISE_FLOOR:
                # the big jump is free: re-seed the drifted comm at the
                # calibrated model's balance point, keeping the searched
                # (algorithm, protocol) subspace choice
                ws = warm_start_config(g, ci, degraded_hardware(hw, cal["scale"]))
                seeds.append(
                    inst.with_(nc=ws.nc, nt=ws.nt, chunk_kb=ws.chunk_kb, done=False)
                )
            else:
                seeds.append(inst)
        res = tune_group(
            sim, g, seed_cfgs=seeds, max_steps=max_steps or DEFAULT_MAX_STEPS
        )
        for ci, cfg in enumerate(res.configs):
            configs[(gi, ci)] = cfg
        profiles += res.iterations
        traces.extend(dict(group=gi, **t) for t in res.trace)

    parent_digest = plan.artifact_digest()
    parent_lineage = plan.lineage or {}
    new = TunedPlan(
        method="lagom",
        mode="serial",
        hardware=hw.name,
        workload=workload.name,
        fingerprint=plan.fingerprint,
        seed=plan.seed,
        noise=0.0,
        noise_mode="default",
        configs=configs,
        sites=comm_site_meta(workload),
        profile_count=profiles,
        traces=traces,
        cache_stats=None,
        structure=plan.structure or structure_fingerprint(workload),
        shape=dict(plan.shape) or workload_shape(workload),
        faults={"calibrated": sched.to_dict()} if sched else {},
        lineage={
            "retuned_from": parent_digest,
            "generation": int(parent_lineage.get("generation", 0)) + 1,
            "sites": cal_sites,
            "groups": scoped,
            "calibration": calibration,
            "chain": [parent_digest] + list(parent_lineage.get("chain", [])),
        },
    )
    if repo is not None:
        from repro_torch.core.plan_repo import as_repository

        as_repository(repo).put(new)
    return new


class RetuneService:
    """The online re-tuning loop around one serving ``PlanBinding``.

    ``handle(sites)`` is the synchronous drive-by-tick entry the engines
    call when their ``HealthMonitor`` flags sustained drift: it
    rate-limits (``interval`` batches between publishes, ``max_retunes``
    per run, optional ``drift_threshold`` floor), rebuilds the decode
    workload at the installed plan's shape, runs ``retune_plan`` on the
    binding's live telemetry, publishes to ``repo`` and hot-swaps via
    ``PlanBinding.set_plan`` — returning the new plan, or ``None`` when
    it declined (the engine then falls back to demotion).  ``tick()``
    polls the monitor for flagged-but-unhandled sites; ``start()`` runs
    ``tick`` on a daemon thread for true background operation."""

    def __init__(
        self,
        binding,
        *,
        repo=None,
        interval: int = 1,
        max_retunes: int = 4,
        drift_threshold: Optional[float] = None,
        max_steps: Optional[int] = None,
        poll_s: float = 0.05,
    ):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval!r}")
        if max_retunes < 1:
            raise ValueError(f"max_retunes must be >= 1, got {max_retunes!r}")
        self.binding = binding
        self.repo = repo if repo is not None else binding.repo
        self.interval = interval
        self.max_retunes = max_retunes
        self.drift_threshold = drift_threshold
        self.max_steps = max_steps
        self.poll_s = poll_s
        self.history: List[Dict] = []
        self._last_publish: Optional[int] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def retunes(self) -> int:
        """Plans published so far this run."""
        return sum(1 for e in self.history if e["event"] == "retune")

    def handle(self, sites) -> Optional[TunedPlan]:
        """Re-tune for ``sites`` (drift-flagged SiteIds) now, or decline
        with ``None`` — rate limits and failures both decline, so the
        caller can fall back to demotion."""
        sites = sorted(set(sites))
        if not sites:
            return None
        with self._lock:
            return self._handle(sites)

    def _handle(self, sites: List[str]) -> Optional[TunedPlan]:
        b = self.binding
        old = b._plan
        if old is None:
            return None
        if self.retunes >= self.max_retunes:
            self._skip(sites, "max_retunes budget exhausted")
            return None
        if (
            self._last_publish is not None
            and b._batch - self._last_publish < self.interval
        ):
            self._skip(sites, f"within {self.interval}-batch interval")
            return None
        if self.drift_threshold is not None and b._health is not None:
            worst = max((b._health.last_drift.get(s, 0.0) for s in sites), default=0.0)
            if worst < self.drift_threshold:
                self._skip(
                    sites,
                    f"drift {worst:.3f} below threshold {self.drift_threshold:g}",
                )
                return None
        from repro_torch.core.extract import extract_decode_workload

        shape = old.shape or {}
        gb = int(shape.get("global_batch") or b.last_batch or 1)
        seq = int(shape.get("seq") or b.max_seq or 0)
        wl = extract_decode_workload(b.cfg, b.parallel, global_batch=gb, seq=seq)
        try:
            new = retune_plan(
                old,
                wl,
                sites=sites,
                telemetry=b.telemetry.latest() or None,
                repo=self.repo,
                max_steps=self.max_steps,
            )
        except (PlanMismatchError, ValueError) as e:
            warnings.warn(
                f"online re-tune declined ({type(e).__name__}: {e}); "
                "falling back to demotion",
                RuntimeWarning,
                stacklevel=3,
            )
            self._skip(sites, f"{type(e).__name__}: {e}")
            return None
        b.set_plan(new)  # zero-downtime: picked up between batches
        event = {
            "event": "retune",
            "batch": b._batch,
            "sites": sites,
            "groups": list(new.lineage["groups"]),
            "profiles": new.profile_count,
            "retuned_from": new.lineage["retuned_from"][:12],
            "generation": new.lineage["generation"],
            "published": self.repo is not None,
        }
        b.events.append(event)
        self.history.append(event)
        self._last_publish = b._batch
        return new

    def _skip(self, sites: List[str], reason: str) -> None:
        event = {
            "event": "retune_skipped",
            "batch": self.binding._batch,
            "sites": sites,
            "reason": reason,
        }
        self.binding.events.append(event)
        self.history.append(event)

    # -- background mode ---------------------------------------------------
    def tick(self) -> Optional[TunedPlan]:
        """One poll: re-tune for any sites the binding's monitor has
        flagged and nothing has handled yet (a successful publish resets
        the monitor through ``set_plan``)."""
        mon = self.binding._health
        if mon is None:
            return None
        pending = sorted(set(mon.unhealthy) - set(self.binding.demoted))
        if not pending:
            return None
        return self.handle(pending)

    def start(self) -> None:
        """Run ``tick`` on a daemon thread every ``poll_s`` seconds until
        ``stop()``.  The synchronous ``handle`` path stays usable —
        publishes are serialized on one lock either way."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                self.tick()
                time.sleep(self.poll_s)

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="retune-service"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    def report(self) -> str:
        """One human-readable summary line (the launcher prints this
        after serving)."""
        n = self.retunes
        skipped = len(self.history) - n
        if not self.history:
            return (
                f"retune: armed, 0 re-tunes (budget {self.max_retunes}, "
                f"interval {self.interval} batch(es))"
            )
        parts = [f"retune: {n} re-tune(s)"]
        if n:
            last = next(e for e in reversed(self.history) if e["event"] == "retune")
            parts.append(
                f"last at batch {last['batch']} "
                f"({len(last['sites'])} site(s), "
                f"{last['profiles']} profiles, "
                f"generation {last['generation']})"
            )
        if skipped:
            parts.append(f"{skipped} declined")
        return ", ".join(parts)


__all__ = ["DEFAULT_MAX_STEPS", "RetuneService", "calibrate_sites", "retune_plan"]
