"""Live per-site timing telemetry for the serving engines.

The engines already time every decode step; this module turns that wall
clock plus the per-site observed costs the health path computes into a
structured, bounded record the online re-tune loop can consume:
``PlanBinding.health_tick`` records one ``SiteTelemetry`` row per served
batch, and ``core.retune`` reads the most recent window back out as the
observed-cost evidence it calibrates the simulator's hardware model from.

The buffer is a plain ring (``collections.deque(maxlen=...)``): serving
runs for millions of batches, the re-tuner only ever needs the recent
past, and a bounded buffer means the telemetry path can never grow the
engine's memory footprint.

    >>> tel = SiteTelemetry(capacity=2)
    >>> tel.record(0, {"serve.layer0.attn.ar": 1.0})
    >>> tel.record(1, {"serve.layer0.attn.ar": 3.0}, step_s=0.01)
    >>> tel.record(2, {"serve.layer0.attn.ar": 5.0})
    >>> len(tel)            # capacity 2: batch 0 fell off
    2
    >>> tel.latest()
    {'serve.layer0.attn.ar': 5.0}
    >>> tel.mean()["serve.layer0.attn.ar"]
    4.0
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 256


class SiteTelemetry:
    """Bounded ring buffer of per-batch observed site costs.

    Each row is ``{"batch": int, "costs": {site_id: seconds},
    "step_s": float | None}``.  ``record`` appends (evicting the oldest
    row past ``capacity``); ``latest``/``mean`` are the read surface the
    re-tune loop uses.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.capacity = capacity
        self._rows: deque = deque(maxlen=capacity)

    def record(
        self,
        batch: int,
        costs: Dict[str, float],
        *,
        step_s: Optional[float] = None,
    ) -> None:
        """Append one served batch's observed per-site costs (seconds)
        plus the measured wall time of the whole step, if known."""
        self._rows.append(
            {"batch": int(batch), "costs": dict(costs), "step_s": step_s}
        )

    def rows(self) -> List[Dict]:
        """The buffered rows, oldest first (copies — mutating a returned
        row never reaches the buffer)."""
        return [dict(r, costs=dict(r["costs"])) for r in self._rows]

    def latest(self) -> Dict[str, float]:
        """The most recent non-empty per-site cost map (``{}`` when the
        buffer is empty or holds only cost-less rows)."""
        for r in reversed(self._rows):
            if r["costs"]:
                return dict(r["costs"])
        return {}

    def mean(self, window: int = 8) -> Dict[str, float]:
        """Per-site mean cost over the last ``window`` rows — a smoother
        calibration input than a single batch when the fabric jitters.
        Sites missing from some rows average over the rows that carry
        them."""
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        acc: Dict[str, float] = {}
        n: Dict[str, int] = {}
        for r in list(self._rows)[-window:]:
            for sid, c in r["costs"].items():
                acc[sid] = acc.get(sid, 0.0) + c
                n[sid] = n.get(sid, 0) + 1
        return {sid: acc[sid] / n[sid] for sid in acc}

    def clear(self) -> None:
        self._rows.clear()

    def __len__(self) -> int:
        return len(self._rows)


__all__ = ["DEFAULT_CAPACITY", "SiteTelemetry"]
