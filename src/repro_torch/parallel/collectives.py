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
``"chunked"``), so one plan lowers to equal knobs in both packages.

Execution half
--------------

The chunked collective matmuls that consume those knobs run over a torch
``ProcessGroup`` (a ``launch.mesh.Mesh``): ``ring_ag_matmul``,
``mm_reduce_scatter``, ``chunked_all_to_all`` and ``psum_tree_chunked``,
each with its dense oracle (``*_ref``).  Where the reference's
``shard_map`` takes global arrays and partition specs, these take this
rank's local shards; each docstring names the sharded dimension.  The
overlap is built in, since nothing schedules it for eager code: a ring
hop is in flight while the previous shard's matmul runs, and each chunk's
reduce-scatter or all-to-all is issued asynchronously before the next
chunk's work and waited for only where its result is needed.
``record_issued`` records what each call actually issued (chunks,
matmuls, collective calls), where the reference would count ``scan`` loops
in a jaxpr.
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh, as_mesh

TP_TRAINING = "the tensor-parallel training slice (ROADMAP.md, queue 1 item 7)"


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


# ---------------------------------------------------------------------------
# execution half: what each call issued
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Issued:
    """One call of a chunked helper, as it ran: ``num_chunks`` is the chunk
    count it used (1 when unchunked or degraded), ``matmuls`` the matrix
    products it launched and ``collectives`` the ``torch.distributed``
    calls it issued (one ring hop's ``batch_isend_irecv`` counts once)."""
    site: str
    op: str              # ring_ag_matmul | mm_reduce_scatter | all_to_all | psum
    num_chunks: int
    matmuls: int
    collectives: int


_ISSUED_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_issued_log", default=None)


@contextlib.contextmanager
def record_issued():
    """Record an ``Issued`` row for every helper call in the ``with`` block
    (in call order).  Nests like ``record_site_resolutions``."""
    rows: List[Issued] = []
    token = _ISSUED_LOG.set(rows)
    try:
        yield rows
    finally:
        _ISSUED_LOG.reset(token)


def _issued(site, op, num_chunks, matmuls, collectives) -> None:
    log = _ISSUED_LOG.get()
    if log is not None:
        log.append(Issued(site, op, num_chunks, matmuls, collectives))


# torch 2.13 deprecates the *_tensor names for *_single; older torch (the
# card's 2.11) may have only the former
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def axis_size(mesh) -> int:
    """The size of the mesh's axis (the reference's ``axis_size(axis)``)."""
    return as_mesh(mesh).size


def _refuse_grad(what: str, m: Mesh, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need this helper's backward: grad enabled,
    more than one rank and an input that needs a gradient.  The helpers
    issue their collectives into fresh tensors, which carry no graph, so
    the gradients would be detached or miss the other ranks' parts."""
    if m.size > 1 and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} at mesh size {m.size} has no backward: gradients through the "
            f"collectives arrive with {TP_TRAINING}")


def _peer(m: Mesh, r: int) -> int:
    """Global rank of rank ``r`` of the mesh's group (p2p ops take global
    ranks)."""
    return dist.get_global_rank(m.group, r)


def _tiled(y: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n·s, D) -> (n, ..., s, D) contiguous: dim -2 split into ``n``
    tiles moved to the front, where the flat collectives split and join."""
    lead, rows, d = y.shape[:-2], y.shape[-2], y.shape[-1]
    t = y.reshape(lead + (n, rows // n, d))
    return t.movedim(-3, 0).contiguous()


def all_gather_rows(y: torch.Tensor, mesh) -> torch.Tensor:
    """Gather a dim -2 sharded (..., s, D) into (..., n·s, D) on every rank,
    shards in rank order.  Not a plan site: the explicit form of the gather
    GSPMD inserts after the reference's sequence-sharded MLP output."""
    m = as_mesh(mesh)
    if m.size == 1:
        return y
    _refuse_grad("all_gather_rows", m, y)
    out = y.new_empty((m.size,) + tuple(y.shape))
    _all_gather(out.view(-1), y.contiguous().view(-1), group=m.group)
    return torch.cat(out.unbind(0), dim=-2)


# ---------------------------------------------------------------------------
# all-gather ∘ matmul  (column-parallel matmul with sequence-sharded input)
#   x: (..., Tl, D), this rank's sequence shard;  w: (D, F_local)
#   y = allgather_T(x) @ w   -> (..., n*Tl, F_local)
# ---------------------------------------------------------------------------

def ag_matmul_ref(x, w):
    return x @ w


def ring_ag_matmul(x, w, mesh, *, num_chunks: int | None = None,
                   site: str | None = None) -> torch.Tensor:
    """All-gather of the sequence shards ``x`` (..., Tl, D), dim -2 sharded
    over the mesh, times this rank's column shard ``w`` (D, F_local), as a
    ring: the shards rotate ``j -> j-1``, and step ``i`` multiplies the
    shard of rank ``(idx + i) % n`` while the next hop is in flight.  Each
    step's matmul is cut into ``num_chunks`` row blocks when ``Tl`` divides
    by it.  Returns (..., n·Tl, F_local)."""
    site = site or "ag"
    num_chunks = _resolve_chunks(num_chunks, site, "ag")
    m = as_mesh(mesh)
    _refuse_grad("ring_ag_matmul", m, x, w)
    n, idx = m.size, m.rank
    Tl = x.shape[-2]
    chunked = num_chunks > 1 and Tl % num_chunks == 0
    if num_chunks > 1 and not chunked:
        _warn_unchunked(site, num_chunks, f"the local sequence shard ({Tl})")
    nc = num_chunks if chunked else 1

    def chunked_mm(xs):
        if nc == 1:
            return xs @ w
        return torch.cat([b @ w for b in xs.chunk(nc, dim=-2)], dim=-2)

    parts: List[Optional[torch.Tensor]] = [None] * n
    cur = x.contiguous() if n > 1 else x
    for i in range(n):
        src = (idx + i) % n                  # whose shard we currently hold
        reqs, nxt = [], None
        if i < n - 1:                        # hop i+1 in flight during this matmul
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, _peer(m, (idx - 1) % n), m.group),
                dist.P2POp(dist.irecv, nxt, _peer(m, (idx + 1) % n), m.group)])
        parts[src] = chunked_mm(cur)
        for r in reqs:
            r.wait()
        cur = nxt
    _issued(site, "ring_ag_matmul", nc, n * nc, n - 1)
    return parts[0] if n == 1 else torch.cat(parts, dim=-2)


# ---------------------------------------------------------------------------
# matmul ∘ reduce-scatter  (row-parallel matmul)
#   x: (..., T, F_local), F sharded over the mesh; w: (F_local, D)
#   y = reduce_scatter_T( x @ w )  -> (..., T/n, D)
# ---------------------------------------------------------------------------

def mm_rs_ref(x, w):
    return x @ w


def _reduce_scatter_rows(y: torch.Tensor, m: Mesh):
    """Issue the sum-scatter of (..., n·s, D) over dim -2 asynchronously;
    returns (work or None, this rank's (..., s, D) tile)."""
    if m.group is None:
        return None, y
    t = _tiled(y.detach(), m.size)
    out = t.new_empty(t.shape[1:])
    # flat views: gloo splits dim 0, so it must be the whole tile
    work = _reduce_scatter(out.view(-1), t.view(-1), group=m.group, async_op=True)
    # at one rank the scatter is the identity: the collective is issued (a
    # plan's structure shows) and the local product is returned, which keeps
    # its autograd graph; the scattered sum of more ranks has none yet (the
    # tensor-parallel training slice, ROADMAP.md, queue 1 item 7)
    return work, (y if m.size == 1 else out)


def mm_reduce_scatter(x, w, mesh, *, num_chunks: int | None = None,
                      site: str | None = None) -> torch.Tensor:
    """``x`` (..., T, F_local), F sharded over the mesh, times this rank's
    row shard ``w`` (F_local, D), summed over the ranks and scattered over
    dim -2: returns this rank's (..., T/n, D).  With ``num_chunks`` > 1 and
    ``T`` divisible by ``num_chunks·n``, chunk ``i`` holds rows
    ``{j·T/n + i·s ...}`` (``s = T/(n·num_chunks)``) for every destination
    ``j``, so the chunks' scatters, joined, equal one scatter; each chunk's
    reduce-scatter is in flight during the next chunk's matmul."""
    site = site or "rs"
    num_chunks = _resolve_chunks(num_chunks, site, "rs")
    m = as_mesh(mesh)
    _refuse_grad("mm_reduce_scatter", m, x, w)
    n = m.size
    T = x.shape[-2]
    if num_chunks <= 1 or T % (num_chunks * n):
        if num_chunks > 1:
            _warn_unchunked(site, num_chunks,
                            f"the scatter tiling ({T} rows over {n} shards)")
        work, y = _reduce_scatter_rows(x @ w, m)
        if work is not None:
            work.wait()
        _issued(site, "mm_reduce_scatter", 1, 1, int(work is not None))
        return y
    s = T // (n * num_chunks)
    lead = x.shape[:-2]
    xr = x.reshape(lead + (n, num_chunks, s, x.shape[-1]))
    pending = []
    for i in range(num_chunks):
        b = xr.select(-3, i).reshape(lead + (n * s, x.shape[-1]))
        pending.append(_reduce_scatter_rows(b @ w, m))
    for work, _ in pending:
        if work is not None:
            work.wait()
    _issued(site, "mm_reduce_scatter", num_chunks, num_chunks,
            sum(work is not None for work, _ in pending))
    return torch.cat([y for _, y in pending], dim=-2)


# ---------------------------------------------------------------------------
# chunked all-to-all (MoE dispatch/combine)
# ---------------------------------------------------------------------------

def _all_to_all(xl: torch.Tensor, m: Mesh, split_axis: int):
    """Issue one tiled all-to-all asynchronously: ``xl``'s ``split_axis`` in
    ``n`` tiles, tile ``j`` to rank ``j``.  Returns (work or None, the
    received (n, ...) tiles, tile ``j`` from rank ``j``)."""
    t = xl.movedim(split_axis, 0)
    t = t.reshape((m.size, t.shape[0] // m.size) + tuple(t.shape[1:])).contiguous()
    if m.group is None:
        return None, t
    out = torch.empty_like(t)
    return dist.all_to_all_single(out, t, group=m.group, async_op=True), out


def _chunked_a2a_local(xl, mesh, *, split_axis: int, concat_axis: int,
                       num_chunks: int, site: str = "a2a"):
    """One all-to-all, or ``num_chunks`` all-to-alls over the trailing
    feature dim, all issued before the first is waited for."""
    m = as_mesh(mesh)
    sa, ca = split_axis % xl.ndim, concat_axis % xl.ndim
    if num_chunks <= 1 or xl.shape[-1] % num_chunks:
        if num_chunks > 1:
            _warn_unchunked(site, num_chunks,
                            f"the trailing feature dim ({xl.shape[-1]})")
        blocks = [xl]
    else:
        blocks = list(xl.chunk(num_chunks, dim=-1))
    pending = [_all_to_all(b, m, sa) for b in blocks]
    ys = []
    for work, tiles in pending:
        if work is not None:
            work.wait()
        ys.append(torch.cat([tl.movedim(0, sa) for tl in tiles.unbind(0)], dim=ca))
    _issued(site, "all_to_all", len(blocks), 0,
            sum(work is not None for work, _ in pending))
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)


def chunked_all_to_all(x, mesh, *, split_axis: int, concat_axis: int,
                       num_chunks: int | None = None,
                       site: str | None = None) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all`` of this rank's shard ``x``:
    ``split_axis`` cut into ``n`` tiles, tile ``j`` sent to rank ``j``, the
    tiles received joined along ``concat_axis`` in rank order; decomposed
    into ``num_chunks`` all-to-alls over the trailing feature dim.
    ``num_chunks=None`` defers to the active plan's knobs for ``site``
    (falling back to the ``a2a`` site class)."""
    site = site or "a2a"
    num_chunks = _resolve_chunks(num_chunks, site, "a2a")
    _refuse_grad("chunked_all_to_all", as_mesh(mesh), x)
    return _chunked_a2a_local(x, mesh, split_axis=split_axis,
                              concat_axis=concat_axis, num_chunks=num_chunks,
                              site=site)


# ---------------------------------------------------------------------------
# plain helpers used by the trainer (gradient sync in explicit-DP mode)
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _all_reduce(a: torch.Tensor, m: Mesh):
    """Issue the sum over ranks of a copy of ``a`` asynchronously."""
    out = a.clone(memory_format=torch.contiguous_format)
    if m.group is None:
        return None, out
    return dist.all_reduce(out, group=m.group, async_op=True), out


def psum_tree(tree, mesh):
    """Every leaf summed over the ranks (a new tree; the leaves are kept)."""
    m = as_mesh(mesh)

    def one(a):
        work, out = _all_reduce(a, m)
        if work is not None:
            work.wait()
        return out

    return _tree_map(one, tree)


class _Pending:
    """One leaf's issued all-reduces: (work or None, output) per chunk."""

    def __init__(self, parts):
        self.parts = parts


def psum_tree_chunked_issue(tree, mesh, *, num_chunks: int | None = None,
                            site: str = "acc"):
    """The issue half of ``psum_tree_chunked``: every leaf's chunk
    all-reduces are issued (asynchronously, on copies) and recorded, and a
    tree of pending results is returned for ``psum_tree_wait``.  What runs
    between the halves overlaps the reduce: the trainer's ACCO step issues
    microbatch k's gradients here before microbatch k+1's forward and waits
    after its backward."""
    num_chunks = _resolve_chunks(num_chunks, site, site_class(site))
    m = as_mesh(mesh)

    def one(a):
        if num_chunks <= 1 or a.ndim == 0 or a.shape[0] % num_chunks:
            if num_chunks > 1 and a.ndim and a.shape[0] % num_chunks:
                _warn_unchunked(site, num_chunks,
                                f"the leading dim ({a.shape[0]}) of a grad leaf")
            pending = [_all_reduce(a, m)]
        else:
            pending = [_all_reduce(b, m) for b in a.chunk(num_chunks, dim=0)]
        _issued(site, "psum", len(pending), 0,
                sum(work is not None for work, _ in pending))
        return _Pending(pending)

    return _tree_map(one, tree)


def psum_tree_wait(pending_tree):
    """The wait half of ``psum_tree_chunked``: waits for every issued chunk
    and returns the summed tree (chunks joined along the leading dim)."""
    def one(p: _Pending):
        for work, _ in p.parts:
            if work is not None:
                work.wait()
        outs = [o for _, o in p.parts]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    return _tree_map(one, pending_tree)


def psum_tree_chunked(tree, mesh, *, num_chunks: int | None = None,
                      site: str = "acc"):
    """``psum_tree`` decomposed into ``num_chunks`` all-reduces over each
    leaf's leading dim, all issued before the first is waited for (the
    ACCO gradient sync, ``acc.step{k}.rs_grads``, and the Streaming-DiLoCo
    outer sync).  ``num_chunks=None`` defers to the active plan's knobs for
    ``site`` (falling back to its class); leaves whose leading dim the
    count does not divide (scalars included) reduce whole.  The two halves,
    ``psum_tree_chunked_issue`` and ``psum_tree_wait``, called together."""
    return psum_tree_wait(psum_tree_chunked_issue(tree, mesh, num_chunks=num_chunks,
                                                  site=site))
