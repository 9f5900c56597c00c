"""Per-site plan addressing for the port's collectives (the plan half of
``repro.parallel.collectives``).

Every tunable collective call site carries a stable dotted **SiteId**
(e.g. ``fsdp.layer3.ag_params``, ``tp.layer1.mlp.rs``) derived from the
Workload IR names that ``core.extract`` emits.  A runtime plan is a
``{site_id: CollectiveRuntime}`` map (what ``session.TunedPlan.
runtime_plan()`` lowers to); ``runtime_for(site, cls)`` resolves a site
against the *active* plan by walking from most- to least-specific:

  exact site id -> each dotted prefix (``tp.layer1.mlp`` -> ``tp.layer1``
  -> ``tp``) -> the site *class* (``"ag"`` / ``"rs"`` / ``"ar"`` /
  ``"a2a"`` / ``"p2p"``) -> defaults (one unchunked collective).

so one plan can drive two layers of the same model to different chunk
structure.  Plans are scoped: ``use_runtime_plan`` pushes a plan for a
``with`` block (what ``TunedPlan.applied()`` uses — nested scopes shadow,
exits restore, exception-safe), while ``install_runtime_plan`` sets the
process-wide base plan.  ``set_runtime_plan`` remains as a deprecation
shim over the latter.

Strategy names are the reference's (``"xla"`` | ``"ring"`` |
``"chunked"``), so one plan lowers to equal knobs in both packages.  The
execution half, the chunked collective matmuls over a torch
``ProcessGroup`` that consume these knobs, arrives with the port's
chunked-collectives slice (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class CollectiveRuntime:
    """Runtime knobs for one collective site (what `core.apply` emits)."""
    strategy: str = "xla"        # xla | ring | chunked
    num_chunks: int = 1


@dataclass(frozen=True)
class SiteResolution:
    """One ``resolve_runtime`` consultation observed by
    ``record_site_resolutions``: the site a program addressed, with the
    knobs and the fallback tier it actually received (what an overlap
    verifier attributes the emitted chunk structure with)."""
    site: str
    cls: Optional[str]
    strategy: str
    num_chunks: int
    matched_key: str     # plan key that supplied the knobs ("" = default)
    tier: str            # "exact" | "prefix" | "class" | "default"


# Active runtime plans, each ``{site_id: CollectiveRuntime}``.  The base
# plan is process-wide (``install_runtime_plan``, what
# ``core.apply.activate`` calls); ``use_runtime_plan`` layers scoped plans
# over it (``TunedPlan.applied()``) in a ``ContextVar`` so concurrent
# threads/tasks cannot pop each other's scopes.  The *innermost* plan is
# the active one — scopes shadow rather than merge, so ``applied()`` means
# "exactly this plan", and exiting restores whatever was active before.
_BASE_PLAN: Dict[str, CollectiveRuntime] = {}
_SCOPED_PLANS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_runtime_plans", default=())

_DEFAULT_RUNTIME = CollectiveRuntime()


def install_runtime_plan(plan: Optional[Dict[str, CollectiveRuntime]] = None,
                         ) -> None:
    """Install ``{site_id: CollectiveRuntime}`` as the process-wide base
    plan (replacing any previous one; ``None``/empty clears it).  Scoped
    plans pushed by ``use_runtime_plan`` shadow it while active."""
    global _BASE_PLAN
    _BASE_PLAN = dict(plan or {})


@contextlib.contextmanager
def use_runtime_plan(plan: Dict[str, CollectiveRuntime]):
    """Scope a runtime plan to a ``with`` block: inside, ``runtime_for``
    resolves against ``plan`` (shadowing any outer/base plan); on exit —
    normal or exceptional — the prior state is restored.  Nests, and is
    thread/async-safe (context-local, token-based restore)."""
    token = _SCOPED_PLANS.set(_SCOPED_PLANS.get() + (dict(plan),))
    try:
        yield
    finally:
        _SCOPED_PLANS.reset(token)


def set_runtime_plan(plan: Dict[str, CollectiveRuntime]) -> None:
    """Deprecated alias for ``install_runtime_plan`` (the pre-per-site
    process-global API).  Resolved knobs are bit-identical; prefer
    ``TunedPlan.applied()`` for scoped use."""
    warnings.warn(
        "set_runtime_plan is deprecated; use install_runtime_plan(plan) for "
        "a process-wide install or `with plan.applied(): ...` for a scoped "
        "one", DeprecationWarning, stacklevel=2)
    install_runtime_plan(plan)


def _active_plan() -> Dict[str, CollectiveRuntime]:
    scopes = _SCOPED_PLANS.get()
    return scopes[-1] if scopes else _BASE_PLAN


# Site-resolution recorder (context-local, like the scoped plans): while a
# ``record_site_resolutions`` block is active, every ``resolve_runtime``
# call appends a ``SiteResolution`` row, so a caller learns which sites a
# program consulted and what knobs each received (call sites address
# plans at coarser granularity than the Workload IR site ids, so name
# matching alone is not enough).
_RESOLUTION_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_site_resolution_log", default=None)


@contextlib.contextmanager
def record_site_resolutions():
    """Record every ``resolve_runtime`` consultation in the ``with`` block.

    Yields the live list of ``SiteResolution`` rows (appended in call
    order, duplicates included — a builder may consult one site several
    times).  Nests: the innermost recorder captures the rows; outer
    recorders resume on exit.  Thread/async-safe (context-local)."""
    rows: list = []
    token = _RESOLUTION_LOG.set(rows)
    try:
        yield rows
    finally:
        _RESOLUTION_LOG.reset(token)


def active_runtime_plan() -> Dict[str, CollectiveRuntime]:
    """The innermost active plan (a copy)."""
    return dict(_active_plan())


def site_class(site: str) -> str:
    """First dotted component of a site id — the coarse bucket the legacy
    three-knob plans keyed on (``"ag"``/``"rs"``/``"ar"``/``"a2a"``/
    ``"p2p"`` for Workload IR comm names)."""
    return site.split(".", 1)[0]


def resolve_runtime(site: str, cls: Optional[str] = None,
                    ) -> Tuple[CollectiveRuntime, str, str]:
    """Resolve ``site`` against the active plan, reporting *how* it
    matched: ``(knobs, matched_key, tier)`` with ``tier`` one of
    ``"exact"`` (the full site id), ``"prefix"`` (a dotted prefix —
    ``acc.step3.rs_grads`` served by an ``acc`` entry), ``"class"`` (the
    ``cls`` fallback bucket), or ``"default"`` (the defaults,
    ``matched_key == ""``).  Resolution order: exact site id, then each
    dotted prefix (most to least specific), then ``cls``."""
    plan = _active_plan()
    rt, key, tier = _DEFAULT_RUNTIME, "", "default"
    if site:
        parts = site.split(".")
        for k in range(len(parts), 0, -1):
            pk = ".".join(parts[:k])
            if pk in plan:
                rt, key, tier = plan[pk], pk, ("exact" if k == len(parts)
                                               else "prefix")
                break
    if tier == "default" and cls is not None and cls in plan:
        rt, key, tier = plan[cls], cls, "class"
    log = _RESOLUTION_LOG.get()
    if log is not None:
        log.append(SiteResolution(site=site, cls=cls, strategy=rt.strategy,
                                  num_chunks=rt.num_chunks, matched_key=key,
                                  tier=tier))
    return rt, key, tier


def explain_runtime(site: str, cls: Optional[str] = None,
                    ) -> Tuple[CollectiveRuntime, str]:
    """Resolve ``site`` against the active plan; returns ``(knobs,
    matched_key)`` where ``matched_key`` is the plan key that supplied the
    knobs (``""`` = the defaults).  ``resolve_runtime`` additionally names
    the fallback tier that matched."""
    rt, key, _ = resolve_runtime(site, cls)
    return rt, key


def runtime_for(site: str, cls: Optional[str] = None) -> CollectiveRuntime:
    """The active knobs for a collective site.  ``site`` may be a full
    SiteId (``"fsdp.layer3.ag_params"``) or a bare site class (``"ag"``,
    ``"rs"``, ``"ar"``, ``"a2a"``, ``"p2p"``); ``cls`` is the fallback
    class a specific site degrades to when the plan has no entry at any
    of its prefixes.  The defaults when nothing matches."""
    return explain_runtime(site, cls)[0]


def _resolve_chunks(num_chunks, site: str, cls: Optional[str] = None) -> int:
    """Explicit ``num_chunks`` wins; ``None`` defers to the active plan."""
    return runtime_for(site, cls).num_chunks if num_chunks is None else num_chunks


class CollectiveDegradedWarning(RuntimeWarning):
    """A tuned site degrading to its monolithic/fallback collective when
    it runs.  Carries the same stable lint code as the static rule in
    ``repro_torch.analysis.lint`` (``LAG010``: chunk count does not divide the
    payload) plus the resolved site id, so runtime warnings and static
    findings name the identical defect.  ``args[0]`` is the formatted
    message; ``site``/``code`` are machine-readable."""

    code = "LAG010"

    def __init__(self, message: str, *, site: str = ""):
        super().__init__(message)
        self.site = site


# Sites already warned about in this process: a degraded site warns once,
# not once per call (every step and every serving hot-swap would
# otherwise repeat the identical message).  Tests reset
# via ``reset_degraded_warnings``.
_DEGRADED_WARNED: set = set()


def reset_degraded_warnings() -> None:
    """Clear the per-process ``CollectiveDegradedWarning`` dedupe state so
    the next degradation at any site warns again (test isolation)."""
    _DEGRADED_WARNED.clear()


def warn_degraded(site: str, detail: str, *, stacklevel: int = 3) -> None:
    """Emit the structured ``LAG010`` degradation warning for ``site``,
    once per (site, detail) per process.  ``detail`` finishes the sentence
    "collective site S: ..." — it should name what failed to divide and
    what the fallback emission is."""
    key = (site, detail)
    if key in _DEGRADED_WARNED:
        return
    _DEGRADED_WARNED.add(key)
    warnings.warn(
        CollectiveDegradedWarning(
            f"[{CollectiveDegradedWarning.code}] collective site {site!r}: "
            f"{detail}", site=site),
        stacklevel=stacklevel)


def _warn_unchunked(site: str, num_chunks: int, detail: str) -> None:
    """A tuned chunk count that does not divide the shard shape silently
    degrading to the monolithic collective is an audit hazard — name the
    site once instead."""
    warn_degraded(
        site,
        f"num_chunks={num_chunks} does not divide {detail}; emitting the "
        "unchunked collective for this site",
        stacklevel=4)
