"""Per-site runtime health: drift detection against a plan's predictions.

A tuned plan is a *prediction* — each ``serve.*`` comm site should cost
what the contention model priced it at on healthy hardware.  This module
closes the loop at serving time:

``predicted_site_costs``
    Re-prices every comm site embedded in a ``TunedPlan`` (the plan is
    self-contained: its ``sites`` metadata rebuilds each ``CommOp``)
    under the plan's own tuned config and hardware profile — the
    per-site baseline the monitor compares against.

``HealthMonitor``
    The K-consecutive-drift detector: feed it per-batch observed site
    costs; a site whose observed cost exceeds its prediction by more
    than ``tolerance`` (relative) for ``window`` consecutive batches is
    flagged unhealthy exactly once — the signal ``PlanBinding.demote``
    acts on.

``SimulatedTelemetry``
    Observed-cost source for drills and tests: replays a
    ``core.faults.FaultSchedule`` against the plan's sites, so observed
    == predicted while the fabric is healthy and diverges exactly when a
    bandwidth fault window (degrade/flap) covers a site.  Real
    deployments would feed ``HealthMonitor.observe`` from measured
    per-site timings instead; the monitor does not care where the
    numbers come from.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import contention
from repro_torch.core.comm_params import vendor_default
from repro_torch.core.faults import FaultSchedule, degraded_hardware
from repro_torch.core.hardware import Hardware
from repro_torch.core.session import TunedPlan, _lookup_hw
from repro_torch.core.workload import CommOp


def _site_ops(plan: TunedPlan):
    """``(site_id, class, CommOp, CommConfig)`` for every comm site the
    plan carries metadata for (tuned config, vendor default when a site
    has none)."""
    hw = _lookup_hw(plan.hardware)
    rows = []
    for s in plan.sites:
        op = CommOp(
            name=s["name"],
            kind=s["kind"],
            bytes=s["bytes"],
            group_size=s["group_size"],
            site=s.get("site", ""),
        )
        cfg = plan.configs.get((s["group"], s["comm"])) or vendor_default(hw)
        rows.append((op.site_id, s["name"].split(".", 1)[0], op, cfg))
    return rows


def predicted_site_costs(
    plan: TunedPlan, hardware: Optional[Hardware] = None
) -> Dict[str, float]:
    """Each comm site's standalone cost (seconds) under the plan's tuned
    config on ``hardware`` (default: the plan's own profile) — the
    baseline ``HealthMonitor`` measures drift against.

    A re-tuned plan carries calibration lineage (``core.retune``): sites
    it re-searched under a degraded hardware model are priced on that
    *calibrated* fabric, so the monitor expects the degraded cost and a
    still-degraded link no longer reads as drift — only *new* movement
    beyond the calibrated state re-flags.

    Args:
        plan: the installed ``TunedPlan`` (self-contained site metadata).
        hardware: override profile; default is the plan's own.

    Returns:
        ``{site_id: seconds}`` for every comm site the plan carries.
    """
    hw = hardware if hardware is not None else _lookup_hw(plan.hardware)
    calibration = (plan.lineage or {}).get("calibration", {})
    out = {}
    for sid, _cls, op, cfg in _site_ops(plan):
        site_hw = hw
        cal = calibration.get(sid)
        if cal and cal.get("scale", 1.0) < 1.0:
            site_hw = degraded_hardware(hw, float(cal["scale"]))
        out[sid] = contention.comm_time(op, cfg, site_hw, compute_active=False)
    return out


class HealthMonitor:
    """Flag sites whose observed cost drifts beyond ``tolerance`` of the
    prediction for ``window`` consecutive observations.

    Args:
        predicted: ``{site_id: seconds}`` baseline (typically
            ``predicted_site_costs(plan)``).
        tolerance: relative drift (``observed/predicted - 1``) that
            counts as a drifted observation; must be > 0.
        window: consecutive drifted observations before a site is
            flagged (K of the K-consecutive detector); must be >= 1.

    Raises:
        ValueError: non-positive ``tolerance`` or ``window`` < 1.

    Example — two drifted batches flag at window=2, exactly once::

        >>> mon = HealthMonitor({"s": 1.0}, tolerance=0.25, window=2)
        >>> mon.observe(0, {"s": 2.0})
        []
        >>> mon.observe(1, {"s": 2.0})
        ['s']
        >>> mon.observe(2, {"s": 2.0})   # already flagged: reported once
        []
        >>> mon.reset(); mon.unhealthy   # a plan swap re-arms the site
        set()
    """

    def __init__(
        self,
        predicted: Dict[str, float],
        *,
        tolerance: float = 0.25,
        window: int = 3,
    ):
        if tolerance <= 0:
            raise ValueError(f"tolerance must be > 0, got {tolerance!r}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        self.predicted = dict(predicted)
        self.tolerance = tolerance
        self.window = window
        self.unhealthy: set = set()
        self._streak: Dict[str, int] = {}
        self.last_drift: Dict[str, float] = {}

    def observe(self, batch_idx: int, observed: Dict[str, float]) -> List[str]:
        """Record one batch's observed per-site costs; returns the sites
        that just crossed the K-consecutive threshold (each site is
        reported once — it stays in ``unhealthy`` until ``reset``)."""
        newly: List[str] = []
        for sid, cost in observed.items():
            want = self.predicted.get(sid)
            if not want:
                continue
            drift = cost / want - 1.0
            self.last_drift[sid] = drift
            if drift > self.tolerance:
                self._streak[sid] = self._streak.get(sid, 0) + 1
                if self._streak[sid] >= self.window and sid not in self.unhealthy:
                    self.unhealthy.add(sid)
                    newly.append(sid)
            else:
                self._streak[sid] = 0
        return sorted(newly)

    def reset(self, sites=None) -> None:
        """Forget drift state (all sites, or just ``sites``) — e.g. after
        the fabric recovers or a re-tuned plan replaces predictions."""
        targets = set(self.predicted) if sites is None else set(sites)
        self.unhealthy -= targets
        for sid in targets:
            self._streak.pop(sid, None)
            self.last_drift.pop(sid, None)


class SimulatedTelemetry:
    """Per-batch observed site costs generated by replaying a fault
    schedule against the plan's comm sites (see module docstring)."""

    def __init__(
        self,
        plan: TunedPlan,
        schedule: Optional[FaultSchedule] = None,
        hardware: Optional[Hardware] = None,
    ):
        self.hw = hardware if hardware is not None else _lookup_hw(plan.hardware)
        self.schedule = schedule if schedule else None
        self._rows = _site_ops(plan)
        self._healthy = {
            sid: contention.comm_time(op, cfg, self.hw, compute_active=False)
            for sid, _cls, op, cfg in self._rows
        }

    def observe(self, batch_idx: int) -> Dict[str, float]:
        """Observed cost per site at ``batch_idx`` — the healthy predicted
        cost unless a bandwidth fault window is active on that site."""
        state = self.schedule.state_at(batch_idx) if self.schedule else None
        if state is None or not state.comm_events:
            return dict(self._healthy)
        out = {}
        for sid, cls, op, cfg in self._rows:
            hw = state.hardware_for(sid, cls, self.hw)
            if hw is self.hw:
                out[sid] = self._healthy[sid]
            else:
                out[sid] = contention.comm_time(op, cfg, hw, compute_active=False)
        return out


__all__ = [
    "HealthMonitor",
    "SimulatedTelemetry",
    "predicted_site_costs",
]
