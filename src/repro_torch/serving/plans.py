"""Plan resolution, hot-swap and fault-aware degradation state for the
serving engines (the port's counterpart of ``repro.serving.plans``).

Both engines carry a ``PlanBinding``: either a pinned ``TunedPlan``
(``plan=``, hot-swappable between batches via ``set_plan``) or a
``PlanRepository`` (``repo=``) that is re-resolved as the decode batch
shape drifts under traffic — exact fingerprint first, then the tolerance
band (``PlanRepository.resolve(band=...)``).

Two mechanics matter here:

* **Scoping** — a resolved plan is applied through the scoped
  ``collectives.use_runtime_plan`` stack, never a process-global install,
  so every exit path (normal or exceptional) restores the ambient plan
  and two engines in one process can serve under different plans.
* **Per-plan steps** — the reference's plans bind at trace time, so its
  engines key compiled steps on ``digest()``.  Eager PyTorch consumes a
  plan whenever a collective helper runs, so the port's engines key their
  per-plan steps on the same digest and run each step under its own
  plan's scope: a hot-swap lands on a different key, and a later
  CUDA-graph capture of the decode step can key on it too.

Fault-aware lifecycle (``serving.health`` + ``core.faults``):

* **Drift detection** — ``attach_faults`` arms a per-site
  ``HealthMonitor`` against the bound plan's predicted costs, fed by
  simulated telemetry replaying the fault schedule per served batch
  (``health_tick``).  Sites that drift past tolerance for K consecutive
  batches come back as demotion candidates.
* **Graceful degradation** — ``demote`` swaps in a new runtime plan whose
  affected sites carry fallback knobs (XLA default or their class
  bucket), *scoped to those sites only* and transactional: an exception
  from the engine's apply callback rolls back to the prior plan and
  re-raises.  Every demotion/rollback lands in ``events``.
* **Band backoff** — repeated repository misses widen the resolution
  band with capped exponential backoff; any hit resets it to the
  operator's configured band.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Union

from repro_torch.core.apply import plan_digest
from repro_torch.core.extract import ParallelPlan, extract_decode_workload, parse_parallel
from repro_torch.core.faults import parse_fault_schedule
from repro_torch.core.plan_repo import as_repository
from repro_torch.core.session import TunedPlan
from repro_torch.parallel import collectives as C
from repro_torch.serving.telemetry import SiteTelemetry

DEFAULT_BAND = 0.5
BAND_CAP = 2.0  # backoff ceiling: 3x shape deviation is already a re-tune
_MIN_BAND = 0.05  # backoff floor so band=0.0 repos still start widening


class PlanBinding:
    """Per-engine plan state; see module docstring.  ``parallel`` names the
    deployed topology the decode workload is rebuilt with for repository
    lookups (a ``ParallelPlan`` or a ``kind:degree`` spec string; degrees
    of 1 still fingerprint, they just carry no comm sites).

    Args:
        cfg: the model config the engine serves.
        plan: pinned plan — a ``TunedPlan``, a path to its JSON, or an
            already-lowered runtime dict.
        repo: a ``PlanRepository`` (or directory) re-resolved per shape.
        hardware: profile name keying repository lookups.
        parallel: deployed topology for workload rebuilds (see above).
        band: shape tolerance for banded repository resolution.
        max_seq: decode sequence length the workload is rebuilt at.
        lint: deployment-lint gate on pinned ``TunedPlan``s —
            ``"error"`` (default) refuses a plan with ERROR-severity
            findings (``repro_torch.analysis.lint.PlanLintError``), ``"warn"``
            surfaces findings as one ``RuntimeWarning``, ``"off"``
            disables the gate.  Findings from the last gated install are
            kept on ``lint_findings``.

    The live surfaces the engines and the retune loop read: ``current``
    (the runtime plan decode is scoped under), ``stats`` (resolution
    counters), ``events`` (structured drift/demotion/retune log),
    ``demoted`` (site -> batch), ``telemetry`` (``SiteTelemetry`` ring of
    observed per-site costs, one row per ``health_tick``) and
    ``last_batch`` (the shape most recently resolved).

    Example — an unbound binding resolves to "inherit ambient"::

        >>> from repro_torch.configs import get_smoke_config
        >>> binding = PlanBinding(get_smoke_config("llama3-8b"))
        >>> binding.bound, binding.resolve(4) is None, binding.last_batch
        (False, True, 4)
    """

    def __init__(
        self,
        cfg,
        *,
        plan=None,
        repo=None,
        hardware: str = "h100-sxm",
        parallel: Union[ParallelPlan, str, None] = None,
        band: float = DEFAULT_BAND,
        max_seq: int = 0,
        lint: str = "error",
    ):
        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint= must be 'off', 'warn' or 'error', "
                             f"got {lint!r}")
        self.cfg = cfg
        self.hardware = hardware
        self.band = band
        self.max_seq = max_seq
        self.lint = lint
        self.lint_findings: List = []  # last gated install's findings
        if isinstance(parallel, str):
            parallel = parse_parallel(parallel)
        self.parallel = parallel or ParallelPlan(kind="tp", tp=1)
        self.repo = as_repository(repo) if repo is not None else None
        self.stats = {"exact": 0, "banded": 0, "miss": 0, "swaps": 0}
        self.events: List[Dict] = []  # structured degradation event log
        self.demoted: Dict[str, int] = {}  # site -> batch it was demoted at
        self._fallbacks: Dict[str, C.CollectiveRuntime] = {}
        self._rt: Optional[Dict] = None
        self._digest = None  # None = never set (the first swap is free)
        self._plan: Optional[TunedPlan] = None  # last full artifact seen
        self._batch = 0  # serving-side fault/health clock
        self._band_now = band  # live band under backoff
        self._fault_schedule = None
        self._tolerance = 0.25
        self._window = 3
        self._health = None
        self._telemetry = None
        self.telemetry = SiteTelemetry()  # live observed-cost ring buffer
        self.last_batch: Optional[int] = None  # shape last resolved at
        if plan is not None:
            self.set_plan(plan)

    @property
    def bound(self) -> bool:
        """Whether this binding can ever produce a plan (pinned or repo)."""
        return self._rt is not None or self.repo is not None

    @property
    def current(self) -> Optional[Dict]:
        """The runtime plan decode is currently scoped under (``None`` =
        inherit the ambient plan, i.e. untuned unless one is installed)."""
        return self._rt

    def set_plan(self, plan) -> None:
        """Hot-swap the pinned plan: a ``TunedPlan``, a path to its JSON,
        an already-lowered runtime dict, or ``None`` (unpin).

        Installing a fresh ``TunedPlan`` resets the drift flag state —
        monitor, demotions and sticky fallbacks — so a site that drifts
        again *after* the swap is re-flagged against the new plan's
        predictions instead of being silently ignored forever.  (Repo
        re-resolution through ``resolve`` deliberately does NOT reset:
        a repo hit is the same operator intent, not a new plan decision.)
        """
        if isinstance(plan, (str, os.PathLike)):
            plan = TunedPlan.load(plan)
        if isinstance(plan, TunedPlan):
            self._gate(plan)
            self._plan = plan
            self._health = self._telemetry = None  # re-arm on the new plan
            self.demoted.clear()  # new plan: every site starts trusted and
            self._fallbacks.clear()  # re-flaggable against new predictions
            rt = plan.runtime_plan()
        else:
            rt = plan
        self._swap(rt)

    def _gate(self, plan: TunedPlan) -> None:
        """The deployment-lint refusal gate: a pinned artifact with
        ERROR-severity findings must not reach decode (``lint="error"``,
        the default) — a dead/shadowed/mis-tiered plan silently serves
        wrong knobs otherwise.  ``lint="off"`` is the operator override."""
        if self.lint == "off":
            return
        from repro_torch.analysis.lint import PlanLintError, errors, lint_plan

        self.lint_findings = lint_plan(plan)
        bad = errors(self.lint_findings)
        if bad and self.lint == "error":
            raise PlanLintError(
                self.lint_findings,
                label=f"plan pinned to PlanBinding({self.cfg.name!r})")
        if self.lint == "warn" and self.lint_findings:
            import warnings

            from repro_torch.analysis.lint import format_findings

            warnings.warn(format_findings(self.lint_findings,
                                          label=repr(self.cfg.name)),
                          RuntimeWarning, stacklevel=3)

    def _swap(self, rt: Optional[Dict]) -> None:
        d = plan_digest(rt) if rt is not None else ()
        if self._digest is not None and d != self._digest:
            self.stats["swaps"] += 1
        self._digest = d
        self._rt = rt

    def resolve(self, batch_size: int) -> Optional[Dict]:
        """The runtime plan for a batch of ``batch_size`` in-flight
        sequences.  Repo-bound engines rebuild the decode workload at this
        shape and re-resolve (exact > banded > miss, recorded in
        ``stats``); pinned plans are returned as-is.  Repeated misses
        widen the band with capped exponential backoff (logged to
        ``events``); a hit resets it to the configured band."""
        self.last_batch = batch_size
        if self.repo is None:
            return self._rt
        wl = extract_decode_workload(
            self.cfg, self.parallel, global_batch=batch_size, seq=self.max_seq
        )
        plan, how = self.repo.resolve_explain(
            wl, self.hardware, band=self._band_now
        )
        self.stats[how] += 1
        if how == "miss":
            widened = min(max(self._band_now * 2.0, _MIN_BAND), BAND_CAP)
            if widened != self._band_now:
                self.events.append(
                    {
                        "event": "band_widened",
                        "batch": self._batch,
                        "from": self._band_now,
                        "to": widened,
                    }
                )
                self._band_now = widened
        else:
            self._band_now = self.band
        if plan is not None:
            self._plan = plan
            if self._health is not None and self._health.predicted != (
                _predicted(plan)
            ):
                self._health = self._telemetry = None  # predictions moved
        rt = plan.runtime_plan() if plan is not None else None
        if rt is not None and self._fallbacks:
            # demoted sites stay on their fallback knobs across re-resolves
            # until the operator resets; a fresh repo hit must not silently
            # re-trust a site the monitor flagged
            rt = dict(rt)
            rt.update(self._fallbacks)
        self._swap(rt)
        return self._rt

    def scope(self, rt: Optional[Dict]):
        """Context manager applying ``rt`` via the scoped plan stack
        (no-op for ``None``: inherit the ambient plan)."""
        if rt is None:
            return contextlib.nullcontext()
        return C.use_runtime_plan(rt)

    def digest(self, rt: Optional[Dict]) -> tuple:
        """Per-plan step key for ``rt``.  An unbound step inherits the
        *ambient* plan, so its key reflects that plan too — a later
        process-global install must not reuse a step keyed on the previous
        one."""
        return plan_digest(rt if rt is not None else C.active_runtime_plan())

    # -- fault-aware lifecycle ---------------------------------------------
    def attach_faults(
        self, schedule, *, tolerance: float = 0.25, window: int = 3
    ) -> None:
        """Arm drift detection: replay ``schedule`` (a ``FaultSchedule``,
        inline spec, or schedule-file path) as per-batch telemetry against
        the bound plan's predicted site costs.  The monitor is built
        lazily on the first ``health_tick`` so repo-bound engines arm
        against whichever plan resolution lands on."""
        self._fault_schedule = parse_fault_schedule(schedule)
        self._tolerance = tolerance
        self._window = window
        self._health = self._telemetry = None

    def attach_health(self, monitor, telemetry) -> None:
        """Inject an explicit monitor/telemetry pair (tests, or a real
        measured-timings feed) instead of the lazy simulated one."""
        self._health = monitor
        self._telemetry = telemetry

    def _arm(self) -> bool:
        if self._health is not None and self._telemetry is not None:
            return True
        if self._plan is None:
            return False
        from repro_torch.serving.health import HealthMonitor, SimulatedTelemetry

        if self._telemetry is None:
            if self._fault_schedule is None:
                return False
            self._telemetry = SimulatedTelemetry(
                self._plan, self._fault_schedule
            )
        if self._health is None:
            self._health = HealthMonitor(
                _predicted(self._plan),
                tolerance=self._tolerance,
                window=self._window,
            )
        return True

    def health_tick(self, step_s: Optional[float] = None) -> List[str]:
        """Advance the serving-side batch clock by one served batch and
        return the sites that just crossed the drift threshold (already
        demoted sites excluded).  ``step_s`` is the measured wall time of
        the batch step, recorded on the health events for the report."""
        idx = self._batch
        self._batch += 1
        if not self._arm():
            return []
        observed = self._telemetry.observe(idx)
        # live telemetry: one structured ring-buffer row per served batch —
        # the observed-cost evidence the online re-tune loop calibrates from
        self.telemetry.record(idx, observed, step_s=step_s)
        newly = [
            s
            for s in self._health.observe(idx, observed)
            if s not in self.demoted
        ]
        if newly:
            self.events.append(
                {
                    "event": "drift",
                    "batch": idx,
                    "sites": newly,
                    "drift": {
                        s: round(self._health.last_drift.get(s, 0.0), 4)
                        for s in newly
                    },
                    "step_s": step_s,
                }
            )
        return newly

    def demote(self, sites, *, apply=None, to: str = "xla") -> Dict:
        """Gracefully degrade ``sites``: swap to a runtime plan whose exact
        entries for those sites carry fallback knobs — ``to="xla"`` the
        XLA-default ``CollectiveRuntime()``, ``to="class"`` the site's
        class-bucket entry (XLA default when the plan has none).  Sibling
        sites keep their tuned knobs.  Transactional: ``apply`` (e.g. the
        engine's per-plan step builder) runs under the new plan before it
        is committed; an exception rolls back to the prior plan, logs the
        event as rolled back, and re-raises."""
        sites = sorted(set(sites))
        if to not in ("xla", "class"):
            raise ValueError(f"demotion target must be 'xla' or 'class', got {to!r}")
        base = dict(self._rt if self._rt is not None else C.active_runtime_plan())
        fallback = {}
        for sid in sites:
            fb = C.CollectiveRuntime()
            if to == "class":
                fb = base.get(C.site_class(sid), fb)
            fallback[sid] = fb
        new = dict(base)
        new.update(fallback)
        prior_rt, prior_digest = self._rt, self._digest
        self._swap(new)
        event = {
            "event": "demotion",
            "batch": self._batch,
            "sites": sites,
            "to": to,
            "fallback": {
                s: (fb.strategy, fb.num_chunks) for s, fb in fallback.items()
            },
            "rolled_back": False,
        }
        if apply is not None:
            try:
                apply(new)
            except Exception:
                self._rt, self._digest = prior_rt, prior_digest
                event["rolled_back"] = True
                self.events.append(event)
                raise
        self.events.append(event)
        for sid in sites:
            self.demoted[sid] = self._batch
        self._fallbacks.update(fallback)
        return event

    def health_report(self) -> str:
        """One human-readable degradation summary line (the launcher
        prints this after serving)."""
        demos = [e for e in self.events if e["event"] == "demotion"]
        rolled = sum(1 for e in demos if e["rolled_back"])
        widened = [e for e in self.events if e["event"] == "band_widened"]
        if not self.events:
            return (
                f"health: {self._batch} batches, no drift detected, "
                "0 sites demoted"
            )
        parts = [
            f"health: {self._batch} batches",
            f"{len(self.demoted)} site(s) demoted",
        ]
        if self.demoted:
            parts.append(
                "["
                + ", ".join(
                    f"{s}@batch{b}" for s, b in sorted(self.demoted.items())
                )
                + "]"
            )
        if rolled:
            parts.append(f"{rolled} rolled-back swap(s)")
        if widened:
            parts.append(
                f"band widened {len(widened)}x to {self._band_now:g}"
            )
        return ", ".join(parts)


def _predicted(plan: TunedPlan) -> Dict[str, float]:
    from repro_torch.serving.health import predicted_site_costs

    return predicted_site_costs(plan)
