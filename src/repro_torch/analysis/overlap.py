"""Overlap-materialization verifier: does what a program issued carry the
plan's tuned chunk knobs?  (Counterpart of ``repro.analysis.overlap``.)

A ``TunedPlan`` only earns its speedup if a tuned chunk count ``nc``
changes what runs: ``nc`` collectives interleaved with the products, not
just a number in a JSON file.  This module makes that checkable: run a
plan-aware program under the plan with the resolution recorder armed
(``collectives.record_site_resolutions``), take its op graph
(``analysis.ir``: the record of what the host issued, and optionally the
profile of what the card ran), and judge every consulted tuned site:

``MATERIALIZED``
    The site resolved to the plan's knobs AND the artifact holds the chunk
    structure those knobs promise (a helper call of trip == ``nc`` of the
    site class's collective shape; trivially satisfied when the plan
    leaves the site unchunked).
``DEGRADED``
    The knobs reached the site but the chunk structure is missing or
    wrong: the helper fell back to the monolithic collective (an
    indivisible payload, the ``LAG010`` runtime warning) or its chunks do
    not interleave with the products.
``ABSENT``
    The site never received the plan's knobs (run with the plan not
    installed, or shadowed by another scope) or its collective class is
    missing from the artifact entirely.

The rules (``verify``) are the reference's word for word; only the
artifacts differ.  Per-class expected chunk shapes:

* ``ag`` — ``ring_ag_matmul``: a compute-only loop of ``nc`` product
  chunks inside the ring (the ring itself issues the ``permute``s).
* ``rs`` — ``mm_reduce_scatter``: a loop of trip ``nc`` interleaving a
  product with a ``reduce-scatter``.
* ``a2a`` — ``chunked_all_to_all``: a loop of trip ``nc`` of partial
  all-to-alls.
* ``p2p`` — the pipeline's ``_chunked_ppermute``: a loop of trip ``nc`` of
  point-to-point transfers.
* ``ar`` / ``acc`` / ``outer`` — ``psum_tree_chunked``: a loop of trip
  ``nc`` of partial all-reduces.

Verdicts are structural, not temporal: whether NCCL's kernels ran under
the products is measured (``ir.nccl_overlap``), never judged.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.ir import (OpGraph, capture, graph_from_profile,
                                     graph_from_record, load_trace)
from repro_torch.parallel import collectives as C

VERDICTS = ("MATERIALIZED", "DEGRADED", "ABSENT")

# site class -> (loop collective kind [None = compute-only chunk loop],
#                companion kind that must exist at all for the class,
#                body must interleave compute)
_CLASS_EXPECT: Dict[str, Tuple[Optional[str], str, bool]] = {
    "ag": (None, "permute", False),
    "rs": ("reducescatter", "reducescatter", True),
    "a2a": ("alltoall", "alltoall", False),
    "p2p": ("permute", "permute", False),
    "ar": ("allreduce", "allreduce", False),
    "acc": ("allreduce", "allreduce", False),
    "outer": ("allreduce", "allreduce", False),
}


@dataclass(frozen=True)
class SiteVerdict:
    """One tuned site's materialization verdict."""

    site: str
    cls: str                 # site class the expectation was drawn from
    strategy: str            # plan-intended knobs
    num_chunks: int
    verdict: str             # MATERIALIZED | DEGRADED | ABSENT
    detail: str
    resolution_tier: str     # how the trace resolved it (exact/prefix/...)


@dataclass
class OverlapReport:
    """Per-site verdicts for one traced artifact against one plan.

    ``unobserved`` lists plan-tuned SiteIds the trace never consulted
    (e.g. an fsdp plan verified against a tp builder) — excluded from
    verdicts rather than reported ABSENT, so verification over partial
    surfaces stays false-positive-free.  ``untuned`` lists consulted
    sites the plan carries no entry for."""

    source: str
    verdicts: List[SiteVerdict] = field(default_factory=list)
    unobserved: List[str] = field(default_factory=list)
    untuned: List[str] = field(default_factory=list)

    def by_verdict(self, verdict: str) -> List[SiteVerdict]:
        return [v for v in self.verdicts if v.verdict == verdict]

    @property
    def materialized(self) -> List[SiteVerdict]:
        return self.by_verdict("MATERIALIZED")

    @property
    def degraded(self) -> List[SiteVerdict]:
        return self.by_verdict("DEGRADED")

    @property
    def absent(self) -> List[SiteVerdict]:
        return self.by_verdict("ABSENT")

    def ok(self, *, allow_degraded: bool = False) -> bool:
        """Every consulted tuned site materialized (``allow_degraded``
        tolerates indivisible-payload fallbacks)."""
        if self.absent:
            return False
        return allow_degraded or not self.degraded

    def verdict_for(self, site: str) -> Optional[str]:
        for v in self.verdicts:
            if v.site == site:
                return v.verdict
        return None

    def format(self) -> str:
        n = len(self.verdicts)
        counts = ", ".join(
            f"{len(self.by_verdict(v))} {v}" for v in VERDICTS
            if self.by_verdict(v))
        lines = [f"overlap[{self.source}]: {n} tuned site(s) verified"
                 + (f" — {counts}" if counts else "")]
        for v in self.verdicts:
            lines.append(
                f"  {v.verdict:12s} {v.site}  {v.strategy}/x{v.num_chunks}"
                f"  ({v.detail})")
        if self.unobserved:
            lines.append(
                f"  ({len(self.unobserved)} plan site(s) not exercised by "
                "this trace)")
        return "\n".join(lines)


def _as_runtime_plan(plan) -> Dict[str, C.CollectiveRuntime]:
    """A ``TunedPlan`` (lowered) or an already-lowered runtime dict."""
    if hasattr(plan, "runtime_plan"):
        return plan.runtime_plan()
    return dict(plan)


def _plan_site_ids(plan) -> List[str]:
    if hasattr(plan, "sites"):
        return [s.get("site") or s["name"] for s in plan.sites]
    return []


def _dedupe_rows(rows: Sequence[C.SiteResolution]) -> List[C.SiteResolution]:
    seen, out = set(), []
    for r in rows:
        if r.site not in seen:
            seen.add(r.site)
            out.append(r)
    return out


def verify(plan, graph: OpGraph,
           resolutions: Sequence[C.SiteResolution]) -> OverlapReport:
    """Judge every consulted tuned site against ``graph`` (see module
    docstring).  ``plan`` is a ``TunedPlan`` or a lowered runtime dict;
    ``resolutions`` is the log recorded while the program ran
    (``collectives.record_site_resolutions``)."""
    rt = _as_runtime_plan(plan)
    report = OverlapReport(source=graph.source)
    rows = _dedupe_rows(resolutions)

    judged: List[Tuple[C.SiteResolution, C.CollectiveRuntime, str]] = []
    with C.use_runtime_plan(rt):
        for row in rows:
            expect, _key, tier = C.resolve_runtime(row.site, row.cls)
            if tier == "default":
                report.untuned.append(row.site)
                continue
            judged.append((row, expect, tier))

    observed = {row.site for row in rows}
    report.unobserved = sorted(
        {s for s in _plan_site_ids(plan) if s not in observed})

    # multiset supply of chunk loops per (loop_kind, trip): two sites tuned
    # to the same signature must find two distinct loops
    supply: Dict[Tuple[Optional[str], int], int] = {}

    def take(loop_kind: Optional[str], nc: int,
             need_compute: bool) -> Optional[str]:
        """Consume one matching loop; returns a description or ``None``."""
        key = (loop_kind, nc)
        if key not in supply:
            exact = graph.chunk_loops(loop_kind, trip=nc)
            if need_compute:
                exact = [lp for lp in exact if lp.has_compute]
            supply[key] = len(exact)
        if supply[key] > 0:
            supply[key] -= 1
            return f"chunk loop of trip {nc}"
        # calls whose chunks no kernel shows (trip 0): kind matches, trip unknown
        wild = (loop_kind, 0)
        if wild not in supply:
            loops = [lp for lp in graph.chunk_loops(loop_kind)
                     if lp.trip == 0]
            if need_compute:
                loops = [lp for lp in loops if lp.has_compute]
            supply[wild] = len(loops)
        if supply[wild] > 0:
            supply[wild] -= 1
            return "chunk loop (trip not statically visible)"
        return None

    for row, expect, _tier in sorted(judged, key=lambda j: j[0].site):
        site, nc = row.site, expect.num_chunks
        cls = row.cls if row.cls in _CLASS_EXPECT else C.site_class(site)
        loop_kind, companion, need_compute = _CLASS_EXPECT.get(
            cls, (None, "", False))
        recorded = (row.strategy, row.num_chunks)
        intended = (expect.strategy, expect.num_chunks)

        if recorded != intended:
            verdict, detail = "ABSENT", (
                f"traced under {row.strategy}/x{row.num_chunks} "
                f"(resolution tier {row.tier!r}) but the plan intends "
                f"{expect.strategy}/x{nc} — plan not installed at trace "
                "time?")
        elif nc <= 1:
            verdict, detail = "MATERIALIZED", (
                "plan leaves this site unchunked (nc=1); nothing to "
                "materialize")
        elif cls not in _CLASS_EXPECT:
            # unknown class: accept any loop of the right trip
            hit = take(None, nc, False)
            for k in ("allreduce", "reducescatter", "alltoall", "permute"):
                if hit is not None:
                    break
                hit = take(k, nc, False)
            verdict = "MATERIALIZED" if hit else "DEGRADED"
            detail = hit or (f"no chunk loop of trip {nc} for "
                             f"unrecognized site class {cls!r}")
        else:
            hit = take(loop_kind, nc, need_compute)
            if hit is not None:
                extra = ""
                if cls == "ag":
                    if graph.count("permute") == 0:
                        hit, extra = None, ""
                    else:
                        extra = " inside the ppermute ring"
                if hit is not None:
                    verdict, detail = "MATERIALIZED", hit + extra
            if hit is None:
                present = graph.count(companion) if companion else 0
                if present:
                    verdict, detail = "DEGRADED", (
                        f"{companion} collective emitted but no trip-{nc} "
                        "chunk loop — monolithic fallback (indivisible "
                        "payload, LAG010) or serialized body")
                else:
                    verdict, detail = "ABSENT", (
                        f"no {companion or 'matching'} collective in the "
                        "artifact for this site's class")
        report.verdicts.append(SiteVerdict(
            site=site, cls=cls, strategy=expect.strategy, num_chunks=nc,
            verdict=verdict, detail=detail, resolution_tier=row.tier))
    return report


def trace_and_verify(plan, fn, *args, install: bool = True,
                     profile: Union[bool, str] = False,
                     ) -> Union[OverlapReport, Tuple[OverlapReport, OverlapReport]]:
    """Run ``fn(*args)`` with the resolution recorder armed and the record
    captured (``ir.capture``), and verify the record against ``plan``.
    ``install=True`` (default) scopes the plan over the run — the normal
    "does my plan materialize" question; ``install=False`` runs under the
    ambient plan instead, which is how a deliberately-uninstalled plan
    flips every tuned chunked site to ``ABSENT``.  ``profile=True`` also
    runs it under ``torch.profiler`` (the card's kernels, where there is a
    card) and judges the profile with the same resolution log; returns
    ``(record_report, profile_report)`` then.  A path as ``profile`` also
    keeps the profile's chrome trace there (``ir.nccl_overlap`` reads it)."""
    rt = _as_runtime_plan(plan)
    scope = C.use_runtime_plan(rt) if install else contextlib.nullcontext()
    prof = None
    with scope, C.record_site_resolutions() as rows, capture() as cap:
        if profile:
            prof = _profiled(fn, args)
        else:
            fn(*args)
    report = verify(plan, graph_from_record(cap), rows)
    if not profile:
        return report
    trace = load_trace(prof)
    if isinstance(profile, str):
        with open(profile, "w") as f:
            json.dump(trace, f)
    return report, verify(plan, graph_from_profile(trace), rows)


def _profiled(fn, args):
    """Run ``fn(*args)`` under ``torch.profiler`` (the CPU and, where there
    is one, the card) and return the finished profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof


def verify_profile(plan, trace, resolutions: Sequence[C.SiteResolution]) -> OverlapReport:
    """Judge a profile (a chrome trace, its path, or a finished profiler)
    against ``plan`` using a resolution log recorded when the program
    ran."""
    return verify(plan, graph_from_profile(trace), resolutions)
