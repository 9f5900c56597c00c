"""The port's copy of ``repro.analysis.lint``, lowering through the port's
``core.apply`` and resolving under its ``parallel.collectives``.

Deployment linter: pure static checks on ``TunedPlan × Workload ×
Hardware/Topology``.

A broken plan should be caught before it is bound to a serving engine or
installed into a trainer — not discovered as a ``RuntimeWarning``
mid-serve.  Every check is a registered rule with a stable code
(``LAG0xx``) and a fixed severity; rules run on the plan artifact alone
(the embedded ``sites`` metadata makes it self-contained), with optional
``workload=``/``topology=`` arguments unlocking the cross-artifact
provenance rules.

Rule catalog (see ``docs/analysis.md`` for rationale + examples):

========  ========  =====================================================
code      severity  what it catches
========  ========  =====================================================
LAG001    error     dead plan entry: a tuned config resolving to no site
LAG002    warning   untuned site: a comm site the plan has no config for
LAG003    error     shadowed entry: a site's tuned knobs can never win
                    their own resolution (captured by an earlier entry)
LAG004    error     duplicate SiteId rows lowering to conflicting knobs
LAG010    warning   chunk count that cannot divide the site's payload
                    (the runtime ``CollectiveDegradedWarning`` twin)
LAG020    error     inter-pod site in a flat-tuned plan (tier mismatch)
LAG021    warning   hierarchical topology recorded but no inter-tier site
LAG030    error     provenance drift: fingerprint/structure/topology
                    disagree with the artifact or given workload/topology
LAG031    warning   banded-repo entry whose structure/shape can never
                    match a tolerance-band lookup
LAG040    error     malformed retune lineage (repo walks would quarantine)
========  ========  =====================================================

``lint_plan`` returns findings sorted most severe first; front doors in
the port: ``session.tune(lint=...)`` and ``PlanRepository.put(lint=...)``
(the reference's CLI, dry run and ``PlanBinding`` gate arrive with later
slices of the port).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One lint finding: a stable rule code, its severity, the SiteId it
    anchors to (``""`` for plan-level findings) and a message."""

    code: str
    severity: str
    site: str
    message: str

    def format(self) -> str:
        where = f" site={self.site}" if self.site else ""
        return f"{self.code} {self.severity}{where}: {self.message}"


@dataclass(frozen=True)
class Rule:
    code: str
    severity: str
    doc: str
    fn: Callable


_RULES: Dict[str, Rule] = {}


def rule(code: str, *, severity: str = "warning"):
    """Register a lint rule.  The decorated function receives a
    ``_LintContext`` and yields/returns ``(site, message)`` pairs; the
    registry stamps the code and severity::

        @rule("LAG0xx", severity="error")
        def _my_rule(ctx):
            yield "", "something is statically wrong"
    """
    if severity not in SEVERITIES:
        raise ValueError(
            f"rule severity must be one of {SEVERITIES}, got {severity!r}")

    def deco(fn):
        if code in _RULES:
            raise ValueError(f"lint rule {code!r} already registered")
        _RULES[code] = Rule(code=code, severity=severity,
                            doc=(fn.__doc__ or "").strip(), fn=fn)
        return fn

    return deco


def rules() -> Dict[str, Rule]:
    """The registered rule catalog (code -> Rule), insertion-ordered."""
    return dict(_RULES)


class _LintContext:
    """Everything a rule may inspect, computed once per lint run."""

    def __init__(self, plan, workload=None, topology=None):
        from repro_torch.core.apply import site_runtime_plan, to_runtime

        self.plan = plan
        self.workload = workload
        self.topology = topology
        self.sites: List[Dict] = list(plan.sites)
        self.configs = dict(plan.configs)
        # canonical lowering of this artifact (what activate() installs)
        self.runtime = site_runtime_plan(self.sites, self.configs)
        self._to_runtime = to_runtime

    def site_id(self, row: Dict) -> str:
        return row.get("site") or row["name"]

    def row_runtime(self, row: Dict):
        """The knobs ``row``'s own tuned config lowers to (``None`` when
        the site has no config)."""
        cfg = self.configs.get((row["group"], row["comm"]))
        if cfg is None:
            return None
        return self._to_runtime(cfg, row["bytes"])

    def site_tier(self, row: Dict) -> str:
        from repro_torch.core.topology import site_tier

        tier = row.get("tier")
        return tier if tier is not None else site_tier(self.site_id(row))


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@rule("LAG001", severity="error")
def _dead_entry(ctx):
    """A tuned config keyed to a (group, comm) coordinate with no site
    row: the config can never lower into the runtime plan — it is dead
    weight, usually a merge of plans from different workloads."""
    coords = {(s["group"], s["comm"]) for s in ctx.sites}
    for key in sorted(ctx.configs, key=str):
        if key not in coords:
            yield "", (f"config for (group={key[0]}, comm={key[1]}) "
                       "matches no site row; it will never lower to "
                       "runtime knobs")


@rule("LAG002", severity="warning")
def _untuned_site(ctx):
    """A comm site with no tuned config: it silently falls back to a
    prefix/class entry or XLA defaults at runtime."""
    for row in ctx.sites:
        if (row["group"], row["comm"]) not in ctx.configs:
            yield ctx.site_id(row), (
                "site has no tuned config; it will resolve through "
                "fallback entries or XLA defaults")


@rule("LAG003", severity="error")
def _shadowed_entry(ctx):
    """A site whose tuned knobs never win its own resolution: an earlier
    row's prefix fallback captured this site's exact key (``setdefault``
    lowering is first-wins), so the tuned config is silently dropped."""
    from repro_torch.parallel import collectives as C

    with C.use_runtime_plan(ctx.runtime):
        for row in ctx.sites:
            own = ctx.row_runtime(row)
            if own is None:
                continue
            sid = ctx.site_id(row)
            got, key, _tier = C.resolve_runtime(sid, C.site_class(sid))
            if got != own:
                yield sid, (
                    f"tuned knobs {own.strategy}/x{own.num_chunks} are "
                    f"shadowed: resolution lands on entry {key!r} with "
                    f"{got.strategy}/x{got.num_chunks}")


@rule("LAG004", severity="error")
def _duplicate_site(ctx):
    """Two site rows sharing one SiteId but lowering to different knobs:
    only the first row's knobs survive the first-wins lowering."""
    seen: Dict[str, object] = {}
    for row in ctx.sites:
        sid = ctx.site_id(row)
        own = ctx.row_runtime(row)
        if own is None:
            continue
        if sid in seen and seen[sid] != own:
            yield sid, (
                f"duplicate SiteId with conflicting knobs "
                f"({seen[sid].strategy}/x{seen[sid].num_chunks} vs "
                f"{own.strategy}/x{own.num_chunks}); the first row wins")
        seen.setdefault(sid, own)


@rule("LAG010", severity="warning")
def _indivisible_chunk(ctx):
    """A lowered chunk count that cannot evenly divide the site's payload:
    the runtime will degrade to the monolithic collective and emit the
    matching ``CollectiveDegradedWarning`` at trace time — same rule,
    caught statically."""
    for row in ctx.sites:
        rt = ctx.row_runtime(row)
        if rt is None or rt.num_chunks <= 1:
            continue
        payload = int(row.get("bytes") or 0)
        gs = int(row.get("group_size") or 1)
        quantum = rt.num_chunks * (gs if row.get("kind") == "reducescatter"
                                   else 1)
        if payload and payload % quantum:
            yield ctx.site_id(row), (
                f"num_chunks={rt.num_chunks} cannot evenly divide the "
                f"{payload}-byte payload"
                + (f" across {gs} shards" if quantum != rt.num_chunks else "")
                + "; the runtime will fall back to the monolithic "
                "collective")


@rule("LAG020", severity="error")
def _tier_mismatch(ctx):
    """An inter-pod site (``outer.*``, ``acc.*.ar_grads``, or an explicit
    ``tier="inter"`` row) in a plan with no topology provenance: its knobs
    were priced on the flat intra-pod fabric, which mis-provisions the
    much slower cross-pod tier."""
    if ctx.plan.topology.get("fingerprint"):
        return
    for row in ctx.sites:
        if ctx.site_tier(row) == "inter":
            yield ctx.site_id(row), (
                "inter-pod site in a flat-tuned plan (no topology "
                "provenance); cross-pod knobs priced on the island "
                "fabric are unsound — re-tune with tune(..., topology=)")


@rule("LAG021", severity="warning")
def _hierarchical_without_inter(ctx):
    """Topology provenance records multiple pods, yet no site spans the
    inter-pod tier — the slow fabric never carried a tuned collective, so
    the hierarchical tune bought nothing (or the workload lost its
    ``acc.*``/``outer.*`` sites)."""
    spec = ctx.plan.topology.get("spec") or {}
    if int(spec.get("pods") or 1) <= 1:
        return
    if not any(ctx.site_tier(row) == "inter" for row in ctx.sites):
        yield "", (
            f"topology provenance records {spec.get('pods')} pods but no "
            "site spans the inter-pod tier; the fabric-aware tune is "
            "unused")


@rule("LAG030", severity="error")
def _provenance_drift(ctx):
    """Provenance fields that disagree — internally (topology spec vs its
    recorded fingerprint/name) or with a given workload/topology: applying
    the plan would raise ``PlanMismatchError`` at runtime, or worse,
    silently tune the wrong program."""
    topo_meta = ctx.plan.topology
    if topo_meta.get("spec"):
        from repro_torch.core.topology import HierarchicalHardware

        try:
            rebuilt = HierarchicalHardware.from_dict(topo_meta["spec"])
        except (KeyError, TypeError, ValueError) as e:
            yield "", f"topology spec does not rebuild: {e}"
        else:
            if rebuilt.fingerprint() != topo_meta.get("fingerprint"):
                yield "", (
                    "recorded topology fingerprint does not match the "
                    "embedded spec — the artifact was hand-edited")
            elif ctx.plan.hardware != rebuilt.name:
                yield "", (
                    f"plan hardware {ctx.plan.hardware!r} disagrees with "
                    f"its topology name {rebuilt.name!r}")
    if ctx.workload is not None:
        from repro_torch.core.session import (structure_fingerprint,
                                              workload_fingerprint)

        if ctx.plan.fingerprint != workload_fingerprint(ctx.workload):
            yield "", (
                f"plan fingerprint {ctx.plan.fingerprint[:12]}… does not "
                f"match workload {ctx.workload.name!r} — structures "
                "differ; re-applying is unsound")
        elif (ctx.plan.structure
              and ctx.plan.structure != structure_fingerprint(ctx.workload)):
            yield "", (
                "plan structure fingerprint drifted from the workload "
                "(same payload hash, different site structure) — the "
                "artifact was hand-edited")
    if ctx.topology is not None:
        from repro_torch.core.session import PlanMismatchError

        try:
            ctx.plan.check_topology(ctx.topology)
        except PlanMismatchError as e:
            yield "", str(e)


@rule("LAG031", severity="warning")
def _band_unservable(ctx):
    """An entry tolerance-band resolution can never serve: banded lookups
    require a structure fingerprint and positive shape coordinates
    (``_shape_distance`` returns ``None`` otherwise), so this plan only
    ever resolves on an exact fingerprint hit."""
    if not ctx.plan.structure:
        yield "", ("no structure fingerprint recorded; tolerance-band "
                   "repository resolution will never consider this plan")
        return
    shape = ctx.plan.shape or {}
    bad = [k for k in ("seq", "global_batch")
           if not shape.get(k) or shape[k] <= 0]
    if bad:
        yield "", (
            f"shape coordinates {bad} missing or non-positive; banded "
            "shape distance is undefined for this plan")


@rule("LAG040", severity="error")
def _malformed_lineage(ctx):
    """Retune lineage a repository chain walk would quarantine: the
    ``retuned_from`` digest and ``chain`` list must agree (chain head ==
    parent, both present or both absent)."""
    lineage = ctx.plan.lineage or {}
    chain = lineage.get("chain", [])
    parent = lineage.get("retuned_from")
    malformed = (
        not isinstance(chain, list)
        or not all(isinstance(d, str) for d in chain)
        or (parent is not None and not isinstance(parent, str))
        or (chain and parent != chain[0])
        or (parent is not None and not chain)
    )
    if malformed:
        yield "", (f"lineage is malformed (retuned_from={parent!r}, "
                   f"chain={chain!r}); repository chain walks would "
                   "quarantine this entry")


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------

_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def lint_plan(plan, *, workload=None, topology=None,
              select: Optional[List[str]] = None) -> List[Finding]:
    """Run every registered rule (or the ``select`` subset of codes) on
    ``plan`` — a ``TunedPlan`` or a path to its JSON.  ``workload=`` and
    ``topology=`` unlock the cross-artifact provenance checks.  Returns
    findings sorted most severe first (then by code, then site)."""
    import os

    from repro_torch.core.session import TunedPlan

    if isinstance(plan, (str, os.PathLike)):
        plan = TunedPlan.load(plan)
    ctx = _LintContext(plan, workload=workload, topology=topology)
    findings: List[Finding] = []
    for code, r in _RULES.items():
        if select is not None and code not in select:
            continue
        for site, message in r.fn(ctx) or ():
            findings.append(Finding(code=code, severity=r.severity,
                                    site=site, message=message))
    findings.sort(key=lambda f: (_SEV_RANK[f.severity], f.code, f.site))
    return findings


def errors(findings: List[Finding]) -> List[Finding]:
    """The ERROR-severity subset (what refusal gates act on)."""
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: List[Finding], *, label: str = "") -> str:
    """The ``analysis:`` output line plus one line per finding."""
    n_err = len(errors(findings))
    n_warn = sum(1 for f in findings if f.severity == "warning")
    head = (f"analysis: {len(findings)} finding(s) "
            f"({n_err} error(s), {n_warn} warning(s))")
    if label:
        head += f" in {label}"
    return "\n".join([head] + [f"  {f.format()}" for f in findings])


class PlanLintError(ValueError):
    """A plan refused because lint found ERROR-level defects (the
    ``PlanBinding``/``tune``/``put`` refusal gates)."""

    def __init__(self, findings: List[Finding], *, label: str = "plan"):
        self.findings = findings
        bad = errors(findings)
        super().__init__(
            f"{label} has {len(bad)} ERROR-level lint finding(s): "
            + "; ".join(f.format() for f in bad)
            + " — fix the plan or override the lint gate (lint='off')")


def check_plan(plan, *, workload=None, topology=None,
               label: str = "plan") -> List[Finding]:
    """Lint and raise ``PlanLintError`` on any ERROR finding; returns the
    findings (warnings included) otherwise."""
    findings = lint_plan(plan, workload=workload, topology=topology)
    if errors(findings):
        raise PlanLintError(findings, label=label)
    return findings
