"""The port's own copy of ``repro.core.scheduler``.

Cross-group tuning scheduler — one lock-step engine pipeline.

``tuner.tune_workload`` used to walk overlap groups one after another, so
every tuning step paid engine dispatch for a 3–5 candidate micro-batch
while independent groups sat idle — the same "keep both resources busy"
imbalance Lagom removes at the system level, reproduced inside the tuner.
This module turns the per-group searches into resumable step machines and
round-robins their pending candidate batches into a single cross-group
``Simulator.profile_many_grouped`` call per step, so the batched engine
(core.profiling) amortizes dispatch and vectorizes the replay across the
whole workload.

Protocol
========
A search is a ``StepSearch``: it exposes

  * ``pending`` — the candidate batch (list of config lists, all for one
    overlap group) it needs measured next; never empty while unfinished;
  * ``feed(measurements)`` — consume the measurements for ``pending`` (one
    ``GroupMeasurement`` per candidate, aligned) and advance to the next
    batch;
  * ``done`` / ``requests`` — completion flag and the number of logical
    ProfileTime invocations submitted so far.

Subclasses implement ``_search`` as a generator that *yields* candidate
batches and receives the measurement lists back — the natural way to keep
Algorithm 1/2 (and AutoCCL's coordinate descent) textually intact while
making every measurement point resumable.

Trajectory sharing
==================
In deterministic mode, measurements are pure functions of the group's
*structural* fingerprint and the configs, so two structurally identical
groups driven by the same search parameters provably walk the same
trajectory step for step.  ``run_shared`` exploits this: groups are
classed by a caller-supplied key (the tuner passes the structural
fingerprint), ONE search per class actually runs, and the duplicates'
logical ProfileTime invocations are accounted on top — a stack of
identical transformer layers tunes once, in lock-step, instead of
re-walking the cache layer after layer.

The same purity argument extends to CRN noise (``Simulator(noise_mode=
"crn")``): jitter is a pure function of ``(seed, structural fingerprint,
trajectory position)`` (core.noise), so identical groups see identical
noisy measurements at identical positions and their trajectories stay
byte-equal — sharing is sound under jitter.  ``Simulator.
can_share_trajectories`` is the authoritative predicate.  In default
noise mode each submission is an independent draw and trajectories of
identical groups legitimately diverge, so default-noisy callers schedule
one search per group.

Equivalence contract
====================
Deterministic mode: measurements are pure functions of ``(group, cfgs)``,
and each search only ever sees its own group's measurements, so the
interleaved schedule — with or without trajectory sharing — produces
configs, traces, and ``profile_count`` IDENTICAL to the serial walk
(tests/test_scheduler.py asserts equality on every multi-group model-zoo
workload).  ``profile_count`` keeps PR 1's meaning of *logical*
invocations: a shared trajectory increments it for every member group,
exactly as the serial walk's per-layer cache hits did.

Default noisy mode: noise tickets are issued per candidate in *flat
submission order* — requests in the order the scheduler submits them
(unfinished groups in group order, each group's batch in its internal
order), candidates within a request in list order.  That order differs
from the serial walk's, so noisy interleaved results may legitimately
differ from noisy serial ones, but they are seed-reproducible: same seed
+ same workload -> same configs, identical between the batched engine and
the ``batched=False`` reference path (which re-derives each submission's
ticket draws in the same flat order).

CRN noisy mode: tickets are keyed per structural fingerprint and indexed
per group trajectory, so results do NOT depend on the submission
interleaving at all — serial, interleaved, and shared schedules return
byte-identical configs, traces, and ``profile_count`` (asserted across
the model zoo in tests/test_noise.py), exactly like deterministic mode.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.workload import OverlapGroup

#: Scheduling modes for a whole-workload search (the session API's ``mode``):
#:   ``"serial"``      — finish each group before starting the next (the
#:                       reference walk; the exact pre-scheduler request
#:                       stream).
#:   ``"interleaved"`` — one cross-group engine call per lock-step round,
#:                       with trajectory sharing engaged automatically
#:                       whenever it is sound (``can_share_trajectories``).
#:   ``"shared"``      — interleaved with trajectory sharing *required*:
#:                       rejected up front when sharing is unsound
#:                       (default-mode noise) instead of silently degrading.
MODES = ("serial", "interleaved", "shared")


def resolve_mode(sim, mode: str) -> str:
    """Validate ``mode`` against ``MODES`` and the simulator's sharing
    soundness; returns the mode unchanged so call sites can inline it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "shared" and not sim.can_share_trajectories:
        raise ValueError(
            "mode='shared' requires trajectory sharing to be sound — a "
            "deterministic simulator or noise_mode='crn' (this one has "
            f"noise={sim.noise}, noise_mode={sim.noise_mode!r}); use "
            "mode='interleaved' to share opportunistically instead")
    return mode


class StepSearch:
    """Resumable search over one overlap group (see module docstring)."""

    def __init__(self):
        self._gen = self._search()
        self.done = False
        self.pending = None
        self.requests = 0           # logical ProfileTime invocations submitted
        self._advance(None)

    def _search(self):
        """Generator: yields candidate batches, receives measurement lists."""
        raise NotImplementedError
        yield  # pragma: no cover — marks this as a generator to subclasses

    def _advance(self, measurements) -> None:
        try:
            self.pending = self._gen.send(measurements)
        except StopIteration:
            self.done, self.pending = True, None
            return
        self.requests += len(self.pending)

    def feed(self, measurements: Sequence) -> None:
        """Consume measurements for ``pending`` and advance."""
        if self.done:
            raise RuntimeError("feed() on a finished search")
        self._advance(list(measurements))


Searches = List[Tuple[OverlapGroup, StepSearch]]


def run_serial(sim, searches: Searches) -> None:
    """Reference driver: finish each group before starting the next — the
    exact request stream of the pre-scheduler per-group loop."""
    for g, s in searches:
        while not s.done:
            s.feed(sim.profile_many(g, s.pending))


def run_interleaved(sim, searches: Searches) -> int:
    """Round-robin every unfinished group's pending batch into one
    cross-group engine call per step.  Returns the number of lock-step
    rounds (≈ the longest single group's step count, not the sum)."""
    rounds = 0
    while True:
        live = [(g, s) for g, s in searches if not s.done]
        if not live:
            return rounds
        requests = [(g, s.pending) for g, s in live]
        for (_, s), ms in zip(live, sim.profile_many_grouped(requests)):
            s.feed(ms)
        rounds += 1


def run_shared(sim, groups: Sequence[OverlapGroup], make_search,
               class_key) -> List[StepSearch]:
    """Interleave with trajectory sharing: groups with equal
    ``class_key(group)`` share one search (see module docstring — sound
    when ``sim.can_share_trajectories``: deterministic or CRN noise).
    Returns one search per group, aligned with ``groups``; duplicates
    reference their class's search.  Each duplicate's logical invocations
    are added to ``sim.profile_count`` so accounting matches a serial walk
    exactly."""
    classes: dict = {}
    reps: Searches = []
    order: List[StepSearch] = []
    for g in groups:
        key = class_key(g)
        s = classes.get(key)
        if s is None:
            s = make_search(g)
            classes[key] = s
            reps.append((g, s))
        order.append(s)
    run_interleaved(sim, reps)
    counted = set()
    for s in order:
        if id(s) in counted:
            sim.profile_count += s.requests     # logical accounting (Fig. 8c)
        else:
            counted.add(id(s))
    return order


def run_workload(sim, groups: Sequence[OverlapGroup], make_search,
                 class_key, mode: str) -> List[StepSearch]:
    """Mode dispatch shared by every whole-workload tuner
    (``tuner.search_workload`` / ``autoccl.search_workload``): validate
    ``mode``, pick the schedule — sharing whenever sound and not serial —
    and drive every group's search to completion.  Returns one finished
    search per group, aligned with ``groups``."""
    mode = resolve_mode(sim, mode)
    if mode != "serial" and sim.can_share_trajectories:
        return run_shared(sim, groups, make_search, class_key)
    searches = [(g, make_search(g)) for g in groups]
    if mode != "serial":
        run_interleaved(sim, searches)
    else:
        run_serial(sim, searches)
    return [s for _, s in searches]
