"""Map tuned ``CommConfig``s onto the port's collective runtime knobs (the
port of ``repro.core.apply``).

"Applying" a tuned config means choosing the chunked/ring implementations
in ``parallel.collectives`` and their chunk counts:

  chunk_kb  -> num_chunks = ceil(payload / chunk)
  algorithm -> strategy: ring -> explicit p2p ring, tree/bidir ->
               "chunked" loop of partial collectives, vendor default ->
               "xla" (the name the reference gives one unchunked collective)
  nc        -> no footprint in the lowered plan (channel concurrency);
               consumed by the simulator and recorded in the plan.

The lowered plan is **per-site**: every tunable comm site's stable dotted
SiteId (``fsdp.layer3.ag_params``, ``tp.layer1.mlp.ar.fwd.mb0``, ...)
maps to its own ``CollectiveRuntime``, and every dotted *prefix* of a
SiteId is registered as a fallback entry (first site wins), down to the
coarse class buckets (``"ag"``/``"rs"``/``"ar"``/``"a2a"``/``"p2p"``).
Call sites address the plan at whatever granularity they know
(``tp.layer1.mlp`` covers both the layer's ag and rs), and
``collectives.runtime_for`` walks the same hierarchy.  The arithmetic is
the reference's, so both packages lower one plan to equal knobs.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List

from repro_torch.core.comm_params import CommConfig
from repro_torch.core.workload import ConfigSet, Workload, comm_site_meta
from repro_torch.parallel.collectives import CollectiveRuntime

MAX_CHUNKS = 16      # scheduler-friendly cap: beyond this, per-chunk launch
                     # overhead dominates (same cliff as the paper's Fig. 3c)


def to_runtime(cfg: CommConfig, payload_bytes: float) -> CollectiveRuntime:
    chunks = max(1, math.ceil(payload_bytes / (cfg.chunk_kb * 1024.0)))
    chunks = min(MAX_CHUNKS, chunks)
    if cfg.algorithm == "ring":
        strategy = "ring"
    elif cfg.algorithm in ("tree", "bidir"):
        strategy = "chunked"
    else:
        strategy = "xla"
    return CollectiveRuntime(strategy=strategy, num_chunks=chunks)


def site_runtime_plan(sites: List[Dict],
                      configs: ConfigSet) -> Dict[str, CollectiveRuntime]:
    """Per-site runtime plan keyed by SiteId, with hierarchical fallback
    entries at every dotted prefix plus the class buckets; ``sites`` is
    ``workload.comm_site_meta`` metadata (live or deserialized from a
    ``TunedPlan``).  Sites without a tuned config are skipped.
    ``setdefault`` everywhere: the first site contributing to a prefix (or
    class) wins."""
    plan: Dict[str, CollectiveRuntime] = {}
    for s in sites:
        cfg = configs.get((s["group"], s["comm"]))
        if cfg is None:
            continue
        rt = to_runtime(cfg, s["bytes"])
        sid = s.get("site") or s["name"]
        parts = sid.split(".")
        for k in range(len(parts), 0, -1):
            plan.setdefault(".".join(parts[:k]), rt)
        plan.setdefault(s["name"].split(".")[0], rt)   # ag / rs / ar / a2a / p2p
    return plan


def plan_digest(rt: Dict[str, CollectiveRuntime]) -> tuple:
    """Hashable identity of a lowered runtime plan: every (SiteId,
    strategy, num_chunks), sorted.  Equal digests mean equal knobs at
    every site, so callers that cache per plan (a captured decode step,
    say) key on it."""
    return tuple(sorted((sid, r.strategy, r.num_chunks)
                        for sid, r in rt.items()))


def runtime_plan(wl: Workload, configs: ConfigSet) -> Dict[str, CollectiveRuntime]:
    """Per-site runtime plan (see ``site_runtime_plan``) for a live workload."""
    return site_runtime_plan(comm_site_meta(wl), configs)


def activate(plan) -> Dict[str, CollectiveRuntime]:
    """Lower a ``session.TunedPlan`` (object or path to its JSON) to runtime
    knobs and install them as the process-wide base plan
    (``parallel.collectives.runtime_for``).  Returns the runtime plan.
    For a scoped install, use ``TunedPlan.applied()`` instead."""
    from repro_torch.core.session import TunedPlan
    from repro_torch.parallel import collectives

    if isinstance(plan, (str, os.PathLike)):
        plan = TunedPlan.load(plan)
    rt = plan.runtime_plan()
    collectives.install_runtime_plan(rt)
    return rt
