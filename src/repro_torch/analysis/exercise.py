"""Synthetic per-site exercisers: verify a plan with no model required
(counterpart of ``repro.analysis.exercise``).

``overlap.trace_and_verify`` needs a program that consults the plan's
sites.  The real programs (trainer, serving engines) are heavy and
shape-constrained; this module instead runs, for every tuned site in a
plan, one call of the port's *production chunked helper* for the site's
collective kind at the site's exact SiteId — ``ring_ag_matmul`` for
allgather sites, ``mm_reduce_scatter`` for reducescatter,
``chunked_all_to_all`` for alltoall, ``psum_tree_chunked`` for allreduce,
the pipeline's ``_chunked_ppermute`` for permute — on this rank's shards of
the reference's shapes, sized so the plan's resolved chunk count divides
evenly.  Running that program under the plan and judging its record
answers "does this plan materialize when its sites are exercised?" for any
plan, which is what ``python -m repro_torch.analysis verify-overlap`` runs.

With no mesh given, the program runs over a fake world of 8 ranks
(``launch.mesh.fake_world``: the reference's 8 host devices, with no
devices) that it makes and tears down; on the card, over a real NCCL
group passed as ``mesh``.

A DEGRADED/ABSENT verdict here is therefore a property of the *plan and
resolution machinery* (shadowed entries, nc > MAX payload, plan not
installed), never of payload divisibility — the exerciser removes that
variable by construction.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.overlap import trace_and_verify
from repro_torch.launch.mesh import as_mesh, fake_world, make_mesh
from repro_torch.parallel import collectives as C

# Workload IR comm kind -> the site-class string its production helper
# resolves with (collectives.runtime_for's cls argument)
KIND_CLS = {"allgather": "ag", "reducescatter": "rs", "allreduce": None,
            "alltoall": "a2a", "permute": "p2p"}

FAKE_RANKS = 8


def _site_specs(plan) -> List[Tuple[str, str, int]]:
    """(site, kind, resolved nc) per unique tuned site, resolved exactly
    as the exercisers will resolve when they run."""
    rt = plan.runtime_plan()
    specs, seen = [], set()
    with C.use_runtime_plan(rt):
        for row in plan.sites:
            sid = row.get("site") or row["name"]
            if sid in seen or row["kind"] not in KIND_CLS:
                continue
            seen.add(sid)
            cls = KIND_CLS[row["kind"]] or C.site_class(sid)
            knobs, _key, tier = C.resolve_runtime(sid, cls)
            if tier == "default":
                continue       # untuned site: nothing to materialize
            specs.append((sid, row["kind"], knobs.num_chunks))
    return specs


def _exercise_one(mesh, sid: str, kind: str, nc: int, n: int, device):
    """One helper call at ``sid`` on this rank's shards of the reference's
    shapes, sized so the resolved ``nc`` divides them."""
    nc = max(1, nc)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    if kind == "allgather":
        # x (n*nc, 4) T-sharded, w (4, n*2) F-sharded: local shard nc rows
        return C.ring_ag_matmul(ones(nc, 4), ones(4, 2), mesh, site=sid)
    if kind == "reducescatter":
        # x (n*nc, n*4) F-sharded: scatter tiling n*nc rows over n shards
        return C.mm_reduce_scatter(ones(n * nc, 4), ones(4, 8), mesh, site=sid)
    if kind == "alltoall":
        # local (n, 2, nc): split axis 0 divisible by n, trailing by nc
        return C.chunked_all_to_all(ones(n, 2, nc), mesh, split_axis=0, concat_axis=1,
                                    site=sid)
    if kind == "allreduce":
        # leaf leading dim nc per rank: every chunk divides
        return C.psum_tree_chunked({"g": ones(nc, 4)}, mesh, site=sid)["g"]
    if kind == "permute":
        from repro_torch.parallel.pipeline import _chunked_ppermute

        # along the stages s -> s + 1 (no wrap-around: the port's pipeline's)
        m = as_mesh(mesh)
        x = ones(2, nc)
        rt = C.runtime_for(sid, "p2p")
        return _chunked_ppermute(x if m.rank < m.size - 1 else None, m,
                                 num_chunks=rt.num_chunks, site=sid,
                                 recv_like=x if m.rank > 0 else None)
    raise ValueError(f"no exerciser for comm kind {kind!r}")


def _device(m) -> torch.device:
    if m.group is not None and dist.get_backend(m.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def exercise_plan(plan, *, install: bool = True, mesh=None,
                  profile: bool = False):
    """Run one synthetic program exercising every tuned site of ``plan``
    (each through its production chunked helper, divisible payloads) and
    return the overlap verdicts (``(record, profile)`` reports with
    ``profile``).  ``install=False`` runs without the plan — the
    deliberate-ABSENT control.  ``mesh`` (a ``Mesh`` or a process group)
    defaults to a fake world of 8 ranks made for the call; with no
    ``mesh`` and a default process group already made, it refuses."""
    if mesh is None:
        if dist.is_available() and dist.is_initialized():
            raise RuntimeError("exercise_plan: a default process group exists; pass "
                               "mesh= to run over it (a fake world would replace it)")
        with fake_world(FAKE_RANKS):
            return exercise_plan(plan, install=install, mesh=make_mesh(),
                                 profile=profile)
    m = as_mesh(mesh)
    specs = _site_specs(plan)
    device = _device(m)

    def program():
        return [_exercise_one(m, sid, kind, nc, m.size, device)
                for sid, kind, nc in specs]

    return trace_and_verify(plan, program, install=install, profile=profile)


def exercise_and_report(plan, *, allow_degraded: bool = False,
                        label: str = "plan") -> Tuple[bool, str]:
    """(ok, printable report) — the verify-overlap CLI body."""
    report = exercise_plan(plan)
    ok = report.ok(allow_degraded=allow_degraded)
    text = report.format().replace("overlap[record]", f"overlap[{label}]", 1)
    return ok, text


__all__ = ["KIND_CLS", "exercise_and_report", "exercise_plan"]
