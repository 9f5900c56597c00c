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
in a jaxpr.  Each call's body, and each backward's, runs inside a
``span``: a ``torch.profiler.record_function`` range named
``repro_torch/{op}@{site}`` (what groups a profile's NCCL kernels by call,
``analysis.ir.graph_from_profile``), which also marks the call's start and
end for a listener in ``SPAN_LISTENERS`` (``analysis.ir.capture``).

Every helper is a ``torch.autograd.Function`` at every mesh size, so
tensor-parallel training runs one backward code path on one rank or many.
The backwards issue the transposed collectives: the ring all-gather
matmul's dx is a chunked reduce-scatter of ``dy·wᵀ`` and its dw a second
ring; the matmul reduce-scatter's backward all-gathers ``dy`` chunk by
chunk; the all-to-all's is the inverse all-to-all; ``shard_rows`` and
``all_gather_rows`` are each other's transposes, and so are ``copy_to`` and
``reduce_from``, the unchunked all-reduces of a column-then-row split
(attention's heads, the shared experts, the vocabulary, whose
cross-entropy is ``vocab_parallel_ce``).  A backward uses the
chunk count its forward resolved (saved on the autograd context: autograd
may run it on its own device thread, where the plan's context variables
are not set), keeps the forward's overlap (hop or chunk k+1 in flight
under product k), and logs an ``Issued`` row of its own (``op`` suffixed
``.bwd``).  The sequence-parallel pair keeps every rank's gradients of
the replicated parameters equal without an all-reduce.  ``gather_param``
is FSDP's gather on use: a parameter's slices all-gathered along the dim
the data axis splits, its gradient reduce-scattered back.
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

SPAN_PREFIX = "repro_torch/"

# Called as ``listener(op, site, opening)`` where a span opens (True) and
# closes (False).  A module list, not a context variable: a backward's span
# opens on autograd's thread, where the caller's context is not set.
SPAN_LISTENERS: List = []


@contextlib.contextmanager
def span(op: str, site: str):
    """One helper call's range: a profiler range ``repro_torch/{op}@{site}``
    and, for each listener, a mark where it opens and where it closes."""
    with torch.profiler.record_function(f"{SPAN_PREFIX}{op}@{site}"):
        for fn in SPAN_LISTENERS:
            fn(op, site, True)
        try:
            yield
        finally:
            for fn in SPAN_LISTENERS:
                fn(op, site, False)


@dataclass(frozen=True)
class Issued:
    """One call of a chunked helper, as it ran: ``num_chunks`` is the chunk
    count it used (1 when unchunked or degraded), ``matmuls`` the matrix
    products it launched and ``collectives`` the ``torch.distributed``
    calls it issued (one ring hop's ``batch_isend_irecv`` counts once).
    A backward pass logs its own row, ``op`` suffixed ``.bwd``."""
    site: str
    op: str              # ring_ag_matmul | mm_reduce_scatter | all_to_all | psum |
                         # all_gather (gather_param), or *.bwd
    num_chunks: int
    matmuls: int
    collectives: int


_ISSUED_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_issued_log", default=None)


@contextlib.contextmanager
def record_issued():
    """Record an ``Issued`` row for every helper call in the ``with`` block
    (in call order).  Nests like ``record_site_resolutions``.  A backward
    pass logs into the recorder that was active at its forward (autograd
    may run it on another thread, outside this context)."""
    rows: List[Issued] = []
    token = _ISSUED_LOG.set(rows)
    try:
        yield rows
    finally:
        _ISSUED_LOG.reset(token)


def _issued(site, op, num_chunks, matmuls, collectives, log=None) -> None:
    """Log a row into ``log``, the recorder a Function captured at its
    forward, or else into the recorder active here."""
    log = _ISSUED_LOG.get() if log is None else log
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


def _gather_tiles(y: torch.Tensor, m: Mesh):
    """Issue the all-gather of this rank's (..., s, D) asynchronously;
    returns (work or None, the (n, ..., s, D) tiles in rank order)."""
    if m.group is None:
        return None, y[None]
    out = y.new_empty((m.size,) + tuple(y.shape))
    return _all_gather(out.view(-1), y.contiguous().view(-1), group=m.group,
                       async_op=True), out


def _wait(work) -> None:
    if work is not None:
        work.wait()


def _ring(x: torch.Tensor, m: Mesh, step) -> int:
    """Rotate this rank's shard ``x`` around the ring ``j -> j-1``: step
    ``i`` calls ``step(src, shard)`` on the shard of rank ``src = (idx + i)
    % n`` while the next hop is in flight.  Returns the hops issued."""
    n, idx = m.size, m.rank
    cur = x.contiguous() if n > 1 else x
    for i in range(n):
        reqs, nxt = [], None
        if i < n - 1:                        # hop i+1 in flight during this step
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, _peer(m, (idx - 1) % n), m.group),
                dist.P2POp(dist.irecv, nxt, _peer(m, (idx + 1) % n), m.group)])
        step((idx + i) % n, cur)
        for r in reqs:
            r.wait()
        cur = nxt
    return n - 1


def _rows_mm(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``aᵀ·g`` over every leading dim and the rows: (..., R, P) and
    (..., R, Q) -> (P, Q), the weight gradient of ``a @ w``."""
    return a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])


# ---------------------------------------------------------------------------
# the sequence slice and its conjugate, the gather of the rows (Megatron's
# sequence-parallel f/g).  Not plan sites, and they log no ``Issued`` row.
# ---------------------------------------------------------------------------

class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        s = x.shape[-2] // m.size
        return x.narrow(-2, m.rank * s, s).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, dy):
        work, tiles = _gather_tiles(dy, ctx.m)
        _wait(work)
        return torch.cat(tiles.unbind(0), dim=-2), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m):
        ctx.m = m
        work, tiles = _gather_tiles(y, m)
        _wait(work)
        return torch.cat(tiles.unbind(0), dim=-2)

    @staticmethod
    def backward(ctx, dy):
        m = ctx.m
        s = dy.shape[-2] // m.size
        return dy.narrow(-2, m.rank * s, s), None


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a replicated (..., n·s, D) over dim -2, rank
    ``r`` taking rows ``r·s ... (r+1)·s``: the sequence shard at the entry
    of the tensor-parallel MLP.  Its backward all-gathers the slices'
    gradients, so every rank gets the whole input's gradient."""
    m = as_mesh(mesh)
    if m.size == 1:
        return x
    return _ShardRows.apply(x, m)


def all_gather_rows(y: torch.Tensor, mesh) -> torch.Tensor:
    """Gather a dim -2 sharded (..., s, D) into (..., n·s, D) on every rank,
    shards in rank order.  Not a plan site: the explicit form of the gather
    GSPMD inserts after the reference's sequence-sharded MLP output.  What
    follows it is replicated, so each rank's output gradient is the whole
    one: its backward takes this rank's slice."""
    m = as_mesh(mesh)
    if m.size == 1:
        return y
    return _AllGatherRows.apply(y, m)


# ---------------------------------------------------------------------------
# gather on use: a parameter split over the data axis (FSDP), gathered for
# the layer that uses it.  Not a plan site; each call logs an ``Issued`` row.
# ---------------------------------------------------------------------------

def _dim_gather(t: torch.Tensor, m: Mesh, dim: int) -> torch.Tensor:
    """All-gather of ``t`` over ``m`` along ``dim``, slices in rank order.
    The collectives split dim 0 of a flat buffer (gloo splits nothing
    else), so another ``dim`` goes through a contiguous buffer with it moved
    to the front; the result is that buffer's view, moved back."""
    s = t.movedim(dim, 0).contiguous()
    out = s.new_empty((m.size,) + tuple(s.shape))
    _all_gather(out.view(-1), s.view(-1), group=m.group)
    return out.view((-1,) + tuple(s.shape[1:])).movedim(0, dim)


def _dim_reduce_scatter(g: torch.Tensor, m: Mesh, dim: int) -> torch.Tensor:
    """The sum over ``m`` of ``g``, scattered along ``dim``: this rank's
    slice, contiguous."""
    s = g.movedim(dim, 0).contiguous()
    out = s.new_empty((s.shape[0] // m.size,) + tuple(s.shape[1:]))
    _reduce_scatter(out.view(-1), s.view(-1), group=m.group)
    return out.movedim(0, dim).contiguous()


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, m, dim, site, log):
        ctx.m, ctx.dim, ctx.site, ctx.log = m, dim, site, log
        one = m.size == 1
        with span("all_gather", site):
            _issued(site, "all_gather", 1, 0, 0 if one else 1, log)
            return w.view_as(w) if one else _dim_gather(w, m, dim)

    @staticmethod
    def backward(ctx, g):
        one = ctx.m.size == 1
        with span("all_gather.bwd", ctx.site):
            _issued(ctx.site, "all_gather.bwd", 1, 0, 0 if one else 1, ctx.log)
            dw = g if one else _dim_reduce_scatter(g, ctx.m, ctx.dim)
        return dw, None, None, None, None


def gather_param(w: torch.Tensor, mesh, dim: int, *, site: str = "fsdp.ag_params",
                 ) -> torch.Tensor:
    """The whole parameter of this rank's slice ``w``, split along ``dim``
    over the mesh (the data axis), slices in rank order.  Its backward
    reduce-scatters the whole gradient back to the slice: the sum over the
    ranks, each of which used the whole parameter on its own rows.  At mesh
    size 1 it is ``w`` and issues nothing.  Logs an ``Issued`` row at
    ``site`` (``fsdp.layer{i}.ag_params`` for a layer's weights) for the
    gather and one (``op`` ``all_gather.bwd``) for the reduce-scatter."""
    return _GatherParam.apply(w, as_mesh(mesh), dim % w.ndim, site, _ISSUED_LOG.get())


@torch.no_grad()
def gather_full(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """``gather_param`` without a gradient or a log row, contiguous."""
    m = as_mesh(mesh)
    return t if m.size == 1 else _dim_gather(t, m, dim).contiguous()


# ---------------------------------------------------------------------------
# all-gather ∘ matmul  (column-parallel matmul with sequence-sharded input)
#   x: (..., Tl, D), this rank's sequence shard;  w: (D, F_local)
#   y = allgather_T(x) @ w   -> (..., n*Tl, F_local)
# ---------------------------------------------------------------------------

def ag_matmul_ref(x, w):
    return x @ w


def _row_blocks(a: torch.Tensor, nc: int):
    return [a] if nc == 1 else list(a.chunk(nc, dim=-2))


class _RingAgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, m, nc, site, log):
        ctx.save_for_backward(x, w)
        ctx.m, ctx.nc, ctx.site, ctx.log = m, nc, site, log
        Tl = x.shape[-2]
        out = x.new_empty(x.shape[:-2] + (m.size * Tl, w.shape[-1]))

        def step(src, xs):
            for j, b in enumerate(_row_blocks(xs, nc)):
                r0 = src * Tl + j * b.shape[-2]
                out[..., r0:r0 + b.shape[-2], :] = b @ w

        with span("ring_ag_matmul", site):
            hops = _ring(x, m, step)
            _issued(site, "ring_ag_matmul", nc, m.size * nc, hops, log)
        return out

    @staticmethod
    def backward(ctx, dy):
        """dx: the reduce-scatter of ``dy·wᵀ`` (chunked as the forward, each
        chunk's scatter in flight under the next chunk's product and the
        weight gradient's ring); dw: ``gather(x)ᵀ·dy``, the shards rotating
        again, each hop in flight under the previous shard's products."""
        x, w = ctx.saved_tensors
        m, nc = ctx.m, ctx.nc
        with span("ring_ag_matmul.bwd", ctx.site):
            Tl = x.shape[-2]
            dx = dw = None
            matmuls = colls = 0
            if ctx.needs_input_grad[0]:
                pending = _mm_rs_issue(dy, w.T, m, nc)
                matmuls, colls = nc, sum(wk is not None for wk, _ in pending)
            if ctx.needs_input_grad[1]:
                acc = torch.zeros(w.shape, dtype=torch.promote_types(w.dtype, torch.float32),
                                  device=w.device)

                def step(src, xs):
                    g = dy[..., src * Tl:(src + 1) * Tl, :]
                    for xb, gb in zip(_row_blocks(xs, nc), _row_blocks(g, nc)):
                        acc.add_(_rows_mm(xb, gb))

                colls += _ring(x, m, step)
                matmuls += m.size * nc
                dw = acc.to(w.dtype)
            if ctx.needs_input_grad[0]:
                dx = _mm_rs_join(pending)
            _issued(ctx.site, "ring_ag_matmul.bwd", nc, matmuls, colls, ctx.log)
        return dx, dw, None, None, None, None


def ring_ag_matmul(x, w, mesh, *, num_chunks: int | None = None,
                   site: str | None = None) -> torch.Tensor:
    """All-gather of the sequence shards ``x`` (..., Tl, D), dim -2 sharded
    over the mesh, times this rank's column shard ``w`` (D, F_local), as a
    ring: the shards rotate ``j -> j-1``, and step ``i`` multiplies the
    shard of rank ``(idx + i) % n`` while the next hop is in flight.  Each
    step's matmul is cut into ``num_chunks`` row blocks when ``Tl`` divides
    by it.  Returns (..., n·Tl, F_local).  Differentiable: the backward
    (``_RingAgMatmul.backward``) uses the chunk count resolved here."""
    site = site or "ag"
    num_chunks = _resolve_chunks(num_chunks, site, "ag")
    m = as_mesh(mesh)
    Tl = x.shape[-2]
    chunked = num_chunks > 1 and Tl % num_chunks == 0
    if num_chunks > 1 and not chunked:
        _warn_unchunked(site, num_chunks, f"the local sequence shard ({Tl})")
    return _RingAgMatmul.apply(x, w, m, num_chunks if chunked else 1, site,
                               _ISSUED_LOG.get())


# ---------------------------------------------------------------------------
# matmul ∘ reduce-scatter  (row-parallel matmul)
#   x: (..., T, F_local), F sharded over the mesh; w: (F_local, D)
#   y = reduce_scatter_T( x @ w )  -> (..., T/n, D)
# ---------------------------------------------------------------------------

def mm_rs_ref(x, w):
    return x @ w


def _rs_chunks(x: torch.Tensor, n: int, nc: int) -> torch.Tensor:
    """(..., T, F) -> (..., n, nc, s, F) with ``s = T/(n·nc)``: chunk ``i``
    is ``[..., :, i]``, rows ``{j·T/n + i·s ...}`` for every destination
    ``j``, so the chunks' scatters, joined, equal one scatter."""
    T = x.shape[-2]
    return x.reshape(x.shape[:-2] + (n, nc, T // (n * nc), x.shape[-1]))


def _mm_rs_issue(x, w, m: Mesh, nc: int):
    """Each chunk's product ``b @ w`` and its sum-scatter over dim -2,
    issued asynchronously before the next chunk's product.  Returns
    [(work or None, this rank's tile)], one a chunk."""
    n = m.size
    xr = _rs_chunks(x, n, nc)
    pending = []
    for i in range(nc):
        b = xr.select(-3, i).reshape(x.shape[:-2] + (-1, x.shape[-1]))
        y = b @ w
        if m.group is None:
            pending.append((None, y))
            continue
        t = _tiled(y, n)
        out = t.new_empty(t.shape[1:])
        # flat views: gloo splits dim 0, so it must be the whole tile
        work = _reduce_scatter(out.view(-1), t.view(-1), group=m.group, async_op=True)
        # at one rank the scatter is the identity: it is issued (a plan's
        # structure shows) and the local product is returned
        pending.append((work, y if n == 1 else out))
    return pending


def _mm_rs_join(pending) -> torch.Tensor:
    for work, _ in pending:
        _wait(work)
    ys = [y for _, y in pending]
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-2)


class _MmReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, m, nc, site, log):
        ctx.save_for_backward(x, w)
        ctx.m, ctx.nc, ctx.site, ctx.log = m, nc, site, log
        with span("mm_reduce_scatter", site):
            pending = _mm_rs_issue(x, w, m, nc)
            _issued(site, "mm_reduce_scatter", nc, nc,
                    sum(work is not None for work, _ in pending), log)
            return _mm_rs_join(pending)

    @staticmethod
    def backward(ctx, dy):
        """Chunk ``i`` of ``dy`` is all-gathered (every chunk's gather
        issued before the first product), giving the output gradient at
        the forward's chunk ``i`` rows; then dx of those rows is ``g·wᵀ``
        and dw gains ``x_iᵀ·g``."""
        x, w = ctx.saved_tensors
        with span("mm_reduce_scatter.bwd", ctx.site):
            m, nc = ctx.m, ctx.nc
            n = m.size
            s = dy.shape[-2] // nc
            gathers = [_gather_tiles(dy[..., i * s:(i + 1) * s, :], m) for i in range(nc)]
            xr = _rs_chunks(x, n, nc)
            lead = x.shape[:-2]
            dxs, dw, matmuls = [], None, 0
            for i, (work, tiles) in enumerate(gathers):
                _wait(work)
                g = tiles.movedim(0, -3)                        # (..., n, s, D)
                if ctx.needs_input_grad[0]:
                    dxs.append(g @ w.T)
                    matmuls += 1
                if ctx.needs_input_grad[1]:
                    part = _rows_mm(xr.select(-3, i), g)
                    dw = part if dw is None else dw + part
                    matmuls += 1
            dx = None
            if dxs:
                dx = torch.stack(dxs, dim=-3).reshape(lead + (-1, x.shape[-1]))
            _issued(ctx.site, "mm_reduce_scatter.bwd", nc, matmuls,
                    sum(work is not None for work, _ in gathers), ctx.log)
            return dx, dw, None, None, None, None


def mm_reduce_scatter(x, w, mesh, *, num_chunks: int | None = None,
                      site: str | None = None) -> torch.Tensor:
    """``x`` (..., T, F_local), F sharded over the mesh, times this rank's
    row shard ``w`` (F_local, D), summed over the ranks and scattered over
    dim -2: returns this rank's (..., T/n, D).  With ``num_chunks`` > 1 and
    ``T`` divisible by ``num_chunks·n``, chunk ``i`` holds rows
    ``{j·T/n + i·s ...}`` (``s = T/(n·num_chunks)``) for every destination
    ``j``, so the chunks' scatters, joined, equal one scatter; each chunk's
    reduce-scatter is in flight during the next chunk's matmul.
    Differentiable: the backward all-gathers the output gradient chunk by
    chunk, with the chunk count resolved here."""
    site = site or "rs"
    num_chunks = _resolve_chunks(num_chunks, site, "rs")
    m = as_mesh(mesh)
    T = x.shape[-2]
    chunked = num_chunks > 1 and T % (num_chunks * m.size) == 0
    if num_chunks > 1 and not chunked:
        _warn_unchunked(site, num_chunks,
                        f"the scatter tiling ({T} rows over {m.size} shards)")
    return _MmReduceScatter.apply(x, w, m, num_chunks if chunked else 1, site,
                                  _ISSUED_LOG.get())


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


def _a2a(xl, m: Mesh, sa: int, ca: int, nc: int):
    """One all-to-all, or ``nc`` all-to-alls over the trailing feature dim,
    all issued before the first is waited for.  Returns (y, calls issued)."""
    blocks = [xl] if nc == 1 else list(xl.chunk(nc, dim=-1))
    pending = [_all_to_all(b, m, sa) for b in blocks]
    ys = []
    for work, tiles in pending:
        _wait(work)
        ys.append(torch.cat([tl.movedim(0, sa) for tl in tiles.unbind(0)], dim=ca))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
    return y, sum(work is not None for work, _ in pending)


class _ChunkedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, sa, ca, nc, site, log):
        ctx.m, ctx.sa, ctx.ca, ctx.nc, ctx.site, ctx.log = m, sa, ca, nc, site, log
        with span("all_to_all", site):
            y, calls = _a2a(x, m, sa, ca, nc)
            _issued(site, "all_to_all", nc, 0, calls, log)
        return y

    @staticmethod
    def backward(ctx, dy):
        """The inverse all-to-all: ``concat_axis`` split, ``split_axis``
        joined, in the forward's chunks."""
        with span("all_to_all.bwd", ctx.site):
            dx, calls = _a2a(dy, ctx.m, ctx.ca, ctx.sa, ctx.nc)
            _issued(ctx.site, "all_to_all.bwd", ctx.nc, 0, calls, ctx.log)
        return dx, None, None, None, None, None, None


def chunked_all_to_all(x, mesh, *, split_axis: int, concat_axis: int,
                       num_chunks: int | None = None,
                       site: str | None = None) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all`` of this rank's shard ``x``:
    ``split_axis`` cut into ``n`` tiles, tile ``j`` sent to rank ``j``, the
    tiles received joined along ``concat_axis`` in rank order; decomposed
    into ``num_chunks`` all-to-alls over the trailing feature dim.
    ``num_chunks=None`` defers to the active plan's knobs for ``site``
    (falling back to the ``a2a`` site class).  Differentiable: the
    backward is the inverse all-to-all in the same chunks."""
    site = site or "a2a"
    num_chunks = _resolve_chunks(num_chunks, site, "a2a")
    if num_chunks > 1 and x.shape[-1] % num_chunks:
        _warn_unchunked(site, num_chunks, f"the trailing feature dim ({x.shape[-1]})")
        num_chunks = 1
    return _ChunkedAllToAll.apply(x, as_mesh(mesh), split_axis % x.ndim,
                                  concat_axis % x.ndim, max(1, num_chunks), site,
                                  _ISSUED_LOG.get())


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


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, m):
        ctx.m = m
        work, out = _all_reduce(a, m)
        _wait(work)
        return out

    @staticmethod
    def backward(ctx, g):
        work, out = _all_reduce(g, ctx.m)
        _wait(work)
        return out, None


def sum_over(a: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``a`` over the mesh's ranks, differentiable, where every
    rank then computes the same loss from the sum (the MoE router's
    load-balancing statistics over the data axis).  Its backward sums the
    ranks' gradients: with the trainer's mean over those ranks, each
    rank's ``a`` gets the gradient of the one global loss.  At mesh size 1
    it is ``a``.  Not a plan site; it logs no ``Issued`` row."""
    m = as_mesh(mesh)
    return a if m.size == 1 else _SumOver.apply(a, m)


# ---------------------------------------------------------------------------
# the conjugate pair of a column-then-row split over ``model`` (Megatron's f
# and g): attention's heads, the shared experts, the vocabulary.  Each is one
# unchunked all-reduce, as GSPMD's implicit one in the reference, which takes
# no plan either: neither calls ``runtime_for``, so a plan's
# ``tp.layer{i}.attn.ar.*`` entries change nothing here (plan-binding them is
# a departure from the reference, ROADMAP queue 1 item 9).  Each logs an
# ``Issued`` row where it issues its all-reduce; at mesh size 1 neither
# issues nor logs anything.
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, site, log):
        ctx.m, ctx.site, ctx.log = m, site, log
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with span("all_reduce.bwd", ctx.site):
            work, out = _all_reduce(g, ctx.m)
            _wait(work)
            _issued(ctx.site, "all_reduce.bwd", 1, 0, int(work is not None), ctx.log)
        return out, None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, site, log):
        with span("all_reduce", site):
            work, out = _all_reduce(x, m)
            _wait(work)
            _issued(site, "all_reduce", 1, 0, int(work is not None), log)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def copy_to(x: torch.Tensor, mesh, *, site: str = "tp.ar.bwd") -> torch.Tensor:
    """``x``, replicated over the mesh, entering work that each rank does on
    its own columns (heads, hidden units, vocabulary rows): the identity
    forward; the backward sums the ranks' partial gradients, so every rank
    gets the whole one (logged at ``site``, op ``all_reduce.bwd``)."""
    m = as_mesh(mesh)
    return x if m.size == 1 else _CopyTo.apply(x, m, site, _ISSUED_LOG.get())


def reduce_from(x: torch.Tensor, mesh, *, site: str = "tp.ar") -> torch.Tensor:
    """The sum over the mesh of each rank's partial ``x`` (a row-parallel
    product's output), logged at ``site`` (op ``all_reduce``); what follows
    is replicated, so the backward is the identity.  Not ``sum_over``, whose
    backward sums the cotangent again: here that would give m times the
    gradient."""
    m = as_mesh(mesh)
    return x if m.size == 1 else _ReduceFrom.apply(x, m, site, _ISSUED_LOG.get())


class _VocabCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mask, m, v0, site, log):
        with span("vocab_ce", site):
            Vl = logits.shape[-1]
            mx = logits.amax(-1)
            if m.group is not None:
                dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=m.group)
            e = torch.exp(logits - mx[..., None])
            local = (targets >= v0) & (targets < v0 + Vl)
            idx = (targets - v0).clamp(0, Vl - 1)
            tgt = logits.gather(-1, idx[..., None])[..., 0] * local
            work, both = _all_reduce(torch.stack([e.sum(-1), tgt]), m)
            _wait(work)
            _issued(site, "vocab_ce", 1, 0, 2 * int(work is not None), log)
            se, tgt = both.unbind(0)
            ctx.save_for_backward(e, se, idx, local, mask)
            return ((mx + torch.log(se) - tgt) * mask).sum()

    @staticmethod
    def backward(ctx, g):
        e, se, idx, local, mask = ctx.saved_tensors
        grad = e / se[..., None]
        grad.scatter_add_(-1, idx[..., None], -local[..., None].to(grad.dtype))
        return grad * (mask * g)[..., None], None, None, None, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                      mesh, *, site: str = "tp.ce.ar") -> torch.Tensor:
    """The masked sum of cross-entropies of ``logits`` (..., V/m) fp32, this
    rank's contiguous block of the vocabulary (rank ``r`` holding ids
    ``r·V/m ...``), against ``targets`` (...) of the whole vocabulary: the
    max over the mesh (it carries no gradient: the lse does not move with
    it), then the sums of the exponentials and of the target logit (from
    the rank that holds it) in one all-reduce; the result is equal on every
    rank.  Its backward is softmax minus one-hot on the local columns,
    scaled by the mask; the logits' input must enter through ``copy_to``.
    Logs one row at ``site`` (op ``vocab_ce``, 2 collectives).  At mesh size
    1 it is the plain masked cross-entropy's sum."""
    m = as_mesh(mesh)
    if m.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        return ((lse - torch.gather(logits, -1, targets[..., None])[..., 0]) * mask).sum()
    return _VocabCE.apply(logits, targets, mask, m, m.rank * logits.shape[-1], site,
                          _ISSUED_LOG.get())


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
            parts = [a]
        else:
            parts = a.chunk(num_chunks, dim=0)
        with span("psum", site):
            pending = [_all_reduce(b, m) for b in parts]
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
