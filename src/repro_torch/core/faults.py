"""The port's own copy of ``repro.core.faults``.

Fault injection for the cost model: scripted hardware-degradation
schedules the ProfileTime simulator replays deterministically.

Production fabrics degrade — links flap, chips straggle, thermal events
add jitter — and a plan tuned on healthy hardware silently becomes the
wrong plan.  A :class:`FaultSchedule` scripts such episodes as a list of
:class:`FaultEvent` windows over the simulator's *step clock* (one step
per logical ProfileTime invocation during tuning; one step per served
batch when the serving health monitor replays the same schedule):

``degrade``
    Link bandwidth degradation: every comm site matching ``site`` sees a
    hardware profile whose ``link_bw``/``chan_bw`` are multiplied by
    ``scale`` (< 1).  Composes *physically* with the contention model —
    ``comm_time`` slows down AND the communication's memory-bandwidth
    draw ``V`` shrinks, so overlapped computation speeds up slightly,
    exactly as on a real degraded link.

``straggler``
    Slowdown multiplier ``scale`` (> 1) on every computation operator's
    duration — a thermally throttled or contended chip.

``jitter``
    A jitter burst: extra lognormal measurement noise of width ``sigma``
    on top of the simulator's own noise model, drawn from a Philox
    stream keyed on ``(schedule seed, step)`` so bursts are bit-exactly
    reproducible and independent of the tuner's draw order.

``flap``
    A transient link fault with recovery: within the event window the
    link cycles every ``period`` steps, degraded (by ``scale``) for the
    first ``duty`` fraction of each cycle and healthy for the rest.

``site`` filters comm-affecting events by dotted SiteId prefix
(``"serve.layer0"`` covers ``serve.layer0.mlp.ag`` and siblings) or by
collective class (``"ag"``/``"rs"``/``"ar"``/``"a2a"``/``"p2p"``);
empty means every comm site.  An *empty* schedule is falsy and the
simulator treats it exactly like ``faults=None`` — the fault-free code
path is untouched, so results stay byte-identical to a fault-free run.

Schedules round-trip through JSON (``save``/``load``) and also parse
from a compact inline spec (``parse_fault_schedule``)::

    degrade,site=serve,scale=0.25,start=2;straggler,scale=1.5,start=6,stop=9
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.hardware import Hardware
from repro_torch.core.noise import lognormal_rows, stream_key, uniform_rows

FAULT_KINDS = ("degrade", "straggler", "jitter", "flap")

_SCALED = ("degrade", "flap", "straggler")


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault window; see the module docstring for kinds."""

    kind: str
    start: int = 0
    stop: Optional[int] = None  # exclusive; None = open-ended
    site: str = ""  # dotted SiteId prefix or class ("" = all comm sites)
    scale: float = 1.0  # bw multiplier (degrade/flap) / comp slowdown (straggler)
    sigma: float = 0.0  # extra lognormal sigma (jitter)
    period: int = 0  # flap cycle length in steps
    duty: float = 0.5  # flap: fraction of each cycle spent degraded

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        object.__setattr__(self, "site", self.site.rstrip("."))
        if self.start < 0 or (self.stop is not None and self.stop <= self.start):
            raise ValueError(
                f"fault window [{self.start}, {self.stop}) is empty or negative"
            )
        if self.kind in _SCALED and not (
            isinstance(self.scale, (int, float))
            and math.isfinite(self.scale)
            and self.scale > 0
        ):
            raise ValueError(
                f"{self.kind} scale must be a finite positive multiplier, "
                f"got {self.scale!r}"
            )
        if self.kind == "jitter" and not (
            math.isfinite(self.sigma) and self.sigma >= 0
        ):
            raise ValueError(f"jitter sigma must be finite >= 0, got {self.sigma!r}")
        if self.kind == "flap":
            if self.period <= 0:
                raise ValueError("flap needs period > 0 (steps per cycle)")
            if not 0.0 < self.duty <= 1.0:
                raise ValueError(f"flap duty must be in (0, 1], got {self.duty!r}")

    # -- activity ----------------------------------------------------------
    def active(self, step: int) -> bool:
        """Whether this event degrades anything at ``step`` (flaps are
        active only during the degraded fraction of their cycle)."""
        if step < self.start or (self.stop is not None and step >= self.stop):
            return False
        if self.kind == "flap":
            duty_steps = max(1, int(round(self.period * self.duty)))
            return (step - self.start) % self.period < duty_steps
        return True

    def matches(self, site: str, cls: str) -> bool:
        """Whether a comm site is covered by this event's ``site`` filter
        (exact id, dotted prefix, or collective class; empty = all)."""
        if not self.site:
            return True
        return (
            site == self.site
            or site.startswith(self.site + ".")
            or self.site == cls
        )


@dataclass(frozen=True)
class FaultState:
    """The active fault window at one step — what the simulator's scalar
    event loop consumes.  ``comp_scale`` multiplies every computation
    duration; ``comm_scale``/``hardware_for`` degrade the hardware seen
    by matching comm sites; ``burst_jitters`` adds the step's jitter
    burst (deterministic in ``(seed, step)``)."""

    step: int
    seed: int
    comp_scale: float = 1.0
    sigma: float = 0.0
    comm_events: Tuple[FaultEvent, ...] = ()

    def comm_scale(self, site: str, cls: str) -> float:
        s = 1.0
        for ev in self.comm_events:
            if ev.matches(site, cls):
                s *= ev.scale
        return s

    def hardware_for(self, site: str, cls: str, hw: Hardware) -> Hardware:
        """``hw`` with the link degraded by every matching active event
        (identity when none match)."""
        return degraded_hardware(hw, self.comm_scale(site, cls))

    def burst_jitters(self, m: int, n: int) -> Tuple[List[float], List[float]]:
        """Extra lognormal multipliers for this step's submission —
        ``(comp multipliers, comm multipliers)``, a pure function of
        ``(seed, step)`` via the counter-based Philox stream."""
        if not self.sigma:
            return [1.0] * m, [1.0] * n
        key = stream_key(self.seed, ("fault-burst", self.step))
        row = lognormal_rows(uniform_rows(key, 0, 1), self.sigma, m + n)[0].tolist()
        return row[:m], row[m:]


_HW_CACHE: Dict[Tuple[str, float], Hardware] = {}


def degraded_hardware(hw: Hardware, scale: float) -> Hardware:
    """``hw`` with ``link_bw`` and ``chan_bw`` multiplied by ``scale`` —
    the degraded-link variant the contention model prices (memoized;
    ``scale == 1`` returns ``hw`` itself)."""
    if scale == 1.0:
        return hw
    key = (hw.name, scale)
    got = _HW_CACHE.get(key)
    if got is None:
        got = dataclasses.replace(
            hw,
            name=f"{hw.name}~deg{scale:g}",
            link_bw=hw.link_bw * scale,
            chan_bw=hw.chan_bw * scale,
        )
        _HW_CACHE[key] = got
    return got


@dataclass(frozen=True)
class FaultSchedule:
    """An ordered script of :class:`FaultEvent` windows plus the seed
    keying its jitter-burst stream.  Falsy when empty — the simulator's
    fault-free path is then untouched."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"events must be FaultEvent, got {type(ev).__name__}")

    def __bool__(self) -> bool:
        return bool(self.events)

    def state_at(self, step: int) -> Optional[FaultState]:
        """The composed fault state at ``step``, or ``None`` when no event
        is active (the simulator's fast path)."""
        comp = 1.0
        sigma = 0.0
        comm: List[FaultEvent] = []
        for ev in self.events:
            if not ev.active(step):
                continue
            if ev.kind == "straggler":
                comp *= ev.scale
            elif ev.kind == "jitter":
                sigma = max(sigma, ev.sigma)
            else:  # degrade / flap
                comm.append(ev)
        if comp == 1.0 and sigma == 0.0 and not comm:
            return None
        return FaultState(
            step=step,
            seed=self.seed,
            comp_scale=comp,
            sigma=sigma,
            comm_events=tuple(comm),
        )

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "seed": self.seed,
            "events": [
                {f.name: getattr(ev, f.name) for f in fields(ev)}
                for ev in self.events
            ],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSchedule":
        return cls(
            events=tuple(FaultEvent(**ev) for ev in d.get("events", ())),
            seed=int(d.get("seed", 0)),
        )

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# inline spec parsing (launcher --fault-schedule)
# ---------------------------------------------------------------------------

_EVENT_FIELDS = {f.name: f for f in fields(FaultEvent)}
_INT_FIELDS = ("start", "stop", "period")
_FLOAT_FIELDS = ("scale", "sigma", "duty")


def _parse_event(tokens: List[str]) -> FaultEvent:
    kw: Dict[str, object] = {}
    for i, tok in enumerate(tokens):
        if "=" not in tok:
            if i == 0:
                kw["kind"] = tok
                continue
            raise ValueError(
                f"fault event token {tok!r} is not key=value (only the "
                "leading kind may be bare)"
            )
        key, val = tok.split("=", 1)
        if key not in _EVENT_FIELDS:
            raise ValueError(
                f"unknown fault event field {key!r}; known: "
                f"{sorted(_EVENT_FIELDS)}"
            )
        if key in _INT_FIELDS:
            kw[key] = int(val)
        elif key in _FLOAT_FIELDS:
            kw[key] = float(val)
        else:
            kw[key] = val
    if "kind" not in kw:
        raise ValueError(f"fault event {';'.join(tokens)!r} names no kind")
    return FaultEvent(**kw)  # type: ignore[arg-type]


def parse_fault_schedule(
    spec: Union[str, os.PathLike, FaultSchedule, None],
) -> Optional[FaultSchedule]:
    """Coerce a ``--fault-schedule`` value to a :class:`FaultSchedule`:
    an existing schedule (or ``None``) passes through, a path to a JSON
    file loads it, anything else parses as an inline spec —
    ``;``-separated events of comma-separated ``key=value`` pairs whose
    first token is the kind, with an optional leading ``seed=N`` segment::

        seed=7;degrade,site=serve,scale=0.25,start=2;flap,period=4,duty=0.5
    """
    if spec is None or isinstance(spec, FaultSchedule):
        return spec
    spec = os.fspath(spec)
    if os.path.exists(spec):
        return FaultSchedule.load(spec)
    seed = 0
    events: List[FaultEvent] = []
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        tokens = [t.strip() for t in seg.split(",") if t.strip()]
        if len(tokens) == 1 and tokens[0].startswith("seed="):
            seed = int(tokens[0].split("=", 1)[1])
            continue
        events.append(_parse_event(tokens))
    return FaultSchedule(events=tuple(events), seed=seed)


__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultSchedule",
    "FaultState",
    "degraded_hardware",
    "parse_fault_schedule",
]
