"""Launcher-side ``TunedPlan`` application (``--tuned-plan`` /
``--plan-repo``): the port's copy of ``repro.launch.plan``'s two entry
points, and its per-site audit table (``runtime_table``, what the dry
run's ``--tuned-plan`` prints).

"Co-tune once, deploy the plan": a plan saved by ``session.tune(...)``
(``plan.save("plan.json")``) — or auto-stored in a ``PlanRepository``
(``tune(..., repo=...)``) — is loaded at launch, lowered to per-site
collective runtime knobs via ``core.apply``, and installed process-wide
(``parallel.collectives.runtime_for``).

Reach: the knobs apply to every explicit chunked-collective call site —
``ring_ag_matmul`` / ``mm_reduce_scatter`` / ``chunked_all_to_all`` /
the pipeline's inter-stage transfers — addressed per SiteId, including
the plan-aware model-builder path (``models.dense.trunk_fwd(mesh=...)``
emits per-layer sites ``tp.layer{i}.mlp``), so one plan can change two
layers' issued chunk structure differently.  The unsited layer loop (no
mesh handed to the model) is untouched by a plan.

The launcher has no ``Workload`` object on the ``--tuned-plan`` path, so
the plan's structural fingerprint cannot be verified there (that guard
runs in ``TunedPlan.runtime_plan(wl)`` whenever the workload is in hand);
the model-name cross-check below is the launch-time proxy for it.  The
``--plan-repo`` path *does* rebuild the workload (arch × parallel spec ×
shape) and resolves by exact (fingerprint, hardware) key — a hit installs
the stored plan with zero tuning work, a miss warns and launches untuned.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

from repro_torch.core.apply import activate
from repro_torch.core.extract import (extract_decode_workload, extract_workload,
                                      parse_parallel)
from repro_torch.core.plan_repo import PlanRepoError, PlanRepository
from repro_torch.core.session import TunedPlan, workload_fingerprint

__all__ = ["apply_tuned_plan", "parse_parallel", "print_runtime_table",
           "resolve_plan_repo", "runtime_table"]


def apply_tuned_plan(path: str, *, expect_arch: Optional[str] = None,
                     quiet: bool = False) -> Dict:
    """Load, lower, and install a saved plan; returns the runtime plan
    (identical to ``TunedPlan.load(path).runtime_plan()``).  When
    ``expect_arch`` is given and does not match the model the plan was
    tuned on, a ``RuntimeWarning`` is emitted (the plan still applies —
    fallback knobs are coarse — but the tuning is unsound for a
    different model; re-tune)."""
    plan = TunedPlan.load(path)
    tuned_model = plan.workload.split(":")[0]
    if expect_arch is not None and tuned_model != expect_arch:
        warnings.warn(
            f"tuned plan {path} was tuned on workload {plan.workload!r} "
            f"but this launch runs arch {expect_arch!r} — site knobs "
            "may not correspond; re-tune for this model",
            RuntimeWarning, stacklevel=2)
    rt = activate(plan)
    if not quiet:
        classes = {k: v for k, v in rt.items() if "." not in k}
        knobs = ", ".join(f"{k}={v.strategy}/x{v.num_chunks}"
                          for k, v in sorted(classes.items()))
        print(f"tuned plan {path}: {plan.method}/{plan.mode} on "
              f"{plan.hardware} (workload {plan.workload}, "
              f"{plan.profile_count} profiles) -> {len(rt)} addressable "
              f"site entries; class fallbacks: {knobs}")
    return rt


# ---------------------------------------------------------------------------
# plan repository resolution (--plan-repo)
# ---------------------------------------------------------------------------

def resolve_plan_repo(repo_dir: str, cfg, *, parallel: str, hardware: str,
                      seq: int, global_batch: int, decode: bool = False,
                      serve: bool = False, band: float = 0.0,
                      pods: int = 1, accum_steps: int = 1,
                      outer_frags: int = 0,
                      quiet: bool = False) -> Optional[Dict]:
    """Rebuild the launch workload from (arch config × parallel spec ×
    shape), look it up in the repository by (structural fingerprint,
    hardware), and install a hit (returns the runtime plan).  A miss —
    unknown structure or stale hardware — warns and returns ``None``
    (launch proceeds untuned).

    ``serve=True`` builds the decode-shape workload with ``serve.*``
    SiteIds (``extract_decode_workload``) — the serving launcher's path —
    and ``band`` widens the lookup to tolerance-band resolution (nearest
    tuned shape with the same structure; see ``PlanRepository.resolve``).

    ``pods`` / ``accum_steps`` / ``outer_frags`` thread the hierarchical
    axes into the rebuilt workload so its fingerprint carries the
    ``acc.*`` / ``outer.*`` site classes a cross-pod tune emitted; pass
    the topology *name* (e.g. ``tpu-v5e-x2-dcn``) as ``hardware`` to hit
    plans stored under a hierarchical key."""
    import dataclasses

    pp = parse_parallel(parallel)
    if pods > 1 or accum_steps > 1 or outer_frags > 0:
        pp = dataclasses.replace(pp, pods=max(1, pods),
                                 accum_steps=max(1, accum_steps),
                                 outer_frags=max(0, outer_frags))
    if serve:
        wl = extract_decode_workload(cfg, pp, global_batch=global_batch,
                                     seq=seq)
    else:
        wl = extract_workload(cfg, pp, seq=seq, global_batch=global_batch,
                              decode=decode)
    repo = PlanRepository(repo_dir)
    try:
        plan, how = repo.resolve_explain(wl, hardware, band=band)
    except PlanRepoError as e:
        # a corrupt/misfiled entry must not brick the launch — treat it
        # as a miss, loudly
        warnings.warn(f"plan repository {repo_dir}: {e} — launching "
                      "untuned", RuntimeWarning, stacklevel=2)
        return None
    if plan is None:
        fp = workload_fingerprint(wl)
        warnings.warn(
            f"plan repository {repo_dir}: no plan for "
            f"(fingerprint {fp[:12]}…, {hardware}) — workload "
            f"{wl.name!r} launches untuned; run session.tune(..., "
            f"repo={repo_dir!r}) to populate it", RuntimeWarning,
            stacklevel=2)
        return None
    rt = activate(plan)
    if not quiet:
        shape = (f", banded hit: tuned shape {plan.shape} serves "
                 f"(seq={seq}, batch={global_batch})" if how == "banded"
                 else "")
        print(f"plan repository {repo_dir}: resolved "
              f"({plan.fingerprint[:12]}…, {plan.hardware}) -> "
              f"{plan.method}/{plan.mode} plan ({plan.profile_count} "
              f"profiles, zero tuning at launch); {len(rt)} addressable "
              f"site entries installed{shape}")
    return rt


# ---------------------------------------------------------------------------
# per-site audit table (launch/dryrun.py --tuned-plan)
# ---------------------------------------------------------------------------

# site classes with no legacy comm-name bucket: their comm *names*
# ("rs.grads.s0", "ar.grads.s0", "outer.sync.r0.f0") would otherwise fall
# into an unrelated class bucket ("rs"/"ar") owned by per-layer sites —
# these resolve by exact/prefix only, then XLA defaults
_CLASSLESS_SITES = frozenset({"acc", "outer"})


def runtime_table(plan: TunedPlan,
                  demoted=()) -> List[Tuple[str, str, int, str, str, str]]:
    """``(site_id, strategy, num_chunks, matched_plan_key, matched_tier,
    health)`` for every comm site the plan was tuned over, resolved against
    the *active* plan — what a launch with these knobs installed will
    actually hand each site.  ``matched_tier`` names the fallback level
    that supplied the knobs (``exact``/``prefix``/``class``/``default``,
    from ``collectives.resolve_runtime``).  ``demoted`` marks sites the
    fault-aware lifecycle (or an operator, via ``--demote``) has degraded
    to fallback knobs; everything else reads ``ok``."""
    from repro_torch.parallel import collectives

    demoted = set(demoted)
    rows = []
    for s in plan.sites:
        sid = s.get("site") or s["name"]
        cls = (None if collectives.site_class(sid) in _CLASSLESS_SITES
               else s["name"].split(".")[0])
        rt, src, how = collectives.resolve_runtime(sid, cls)
        health = "demoted" if sid in demoted else "ok"
        rows.append((sid, rt.strategy, rt.num_chunks, src or "<default>",
                     how, health))
    return rows


def print_runtime_table(plan: TunedPlan, demoted=()) -> None:
    """Operator audit: site id -> knobs -> which plan key supplied them and
    at which fallback tier (plus a health column when any site is
    demoted)."""
    rows = runtime_table(plan, demoted=demoted)
    wid = max([len(r[0]) for r in rows] + [len("site")])
    print(f"{'site':<{wid}}  {'strategy':<8} {'chunks':>6}  "
          f"{'health':<8} {'tier':<8} source")
    for sid, strat, nc, src, how, health in rows:
        print(f"{sid:<{wid}}  {strat:<8} {nc:>6}  {health:<8} {how:<8} {src}")
    n_dem = sum(1 for r in rows if r[5] == "demoted")
    print(f"({len(rows)} comm sites, {n_dem} demoted; 'tier' is the "
          "fallback level resolution matched at — exact site, dotted "
          "prefix, class bucket, or XLA default — and 'source' the plan "
          "key that supplied the knobs)")
