"""Collective/compute op graphs of what a program issued (counterpart of
``repro.analysis.ir``).

The mechanical layer of ``repro_torch.analysis``: it answers "which
collectives did this run issue, in which helper calls, with how many
chunks, next to which products", and knows nothing of plans.  The
overlap verifier (``analysis.overlap``) attributes that structure back to
SiteIds through the resolution log of ``collectives.record_site_resolutions``;
the dry run (``launch.dryrun``) reports its bytes (``collective_bytes``).

Torch has neither a jaxpr nor post-SPMD HLO, so the reference's two
artifacts become two records of one eager run:

``record`` (the jaxpr's counterpart)
    What the program issued on the host, in order: the ``c10d`` ops and the
    matrix products, seen by a ``TorchDispatchMode`` (``capture``).
``profile`` (the post-SPMD HLO's counterpart)
    What the card ran: a ``torch.profiler`` trace, whose collectives are
    NCCL's kernels and copies, grouped by ``ProcessGroupNCCL``'s own
    ``nccl:*`` range around each collective it issues (one collective a
    range) or, launched outside one, one collective each.  A range that ran
    nothing on the card (at one rank, an in-place all-reduce) is no
    collective: the record already holds what was issued.

In both, a *loop* is one call of a chunked helper: each opens a span
(``collectives.span``, a ``record_function`` range named
``repro_torch/{op}@{site}``) around its body, and what the span holds is
that call.  Its trip is the chunks it issued, its kinds and
``n_collectives`` the collectives of one chunk, as the reference's scan
body.  The ring all-gather matmul is a compute-only loop of ``nc``
product chunks (its hops, ``permute``s, are the ring's), as the
reference's ``lax.map`` inside its ``ppermute`` ring.

The op table (:data:`COLLECTIVE_OPS`) maps the canonical comm kinds to
their spellings in each artifact, and to the reference's HLO opcode under
which ``collective_bytes`` reports them:

=================  ==========================================  ==================
kind               record (``c10d`` op)                        profile
=================  ==========================================  ==================
``allgather``      ``_allgather_base_``, ``allgather_``        ``nccl:*all*gather*``, ``AllGather``
``allreduce``      ``allreduce_``                              ``nccl:all_reduce``, ``AllReduce``
``reducescatter``  ``_reduce_scatter_base_``, ``reduce_scatter_``  ``nccl:*reduce_scatter*``, ``ReduceScatter``
``alltoall``       ``alltoall_base_``, ``alltoall_``           ``nccl:all_to_all``, ``SendRecv`` [#]_
``permute``        ``send``, ``recv_``                         ``nccl:send``/``recv``, ``SendRecv``
=================  ==========================================  ==================

.. [#] NCCL has no all-to-all kernel: it groups sends and receives, so a
   ``SendRecv`` kernel inside an ``all_to_all`` span is an all-to-all.

A ring hop or a pipeline transfer is one ``batch_isend_irecv``: a send and
a receive in the record, counted as one ``permute`` (the larger of the two
payloads), as the ``Issued`` row counts it.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel import collectives as C

COLLECTIVE_OPS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "allgather": {"record": ("_allgather_base_", "allgather_",
                             "allgather_into_tensor_coalesced_"),
                  "profile": ("AllGather",), "hlo": ("all-gather",)},
    "allreduce": {"record": ("allreduce_", "allreduce_coalesced_"),
                  "profile": ("AllReduce",), "hlo": ("all-reduce",)},
    "reducescatter": {"record": ("_reduce_scatter_base_", "reduce_scatter_",
                                 "reduce_scatter_tensor_coalesced_"),
                      "profile": ("ReduceScatter",), "hlo": ("reduce-scatter",)},
    "alltoall": {"record": ("alltoall_base_", "alltoall_"), "profile": (),
                 "hlo": ("all-to-all",)},
    "permute": {"record": ("send", "recv_"), "profile": ("SendRecv",),
                "hlo": ("collective-permute",)},
}

RECORD_COLLECTIVE_KIND: Dict[str, str] = {
    op: kind for kind, spec in COLLECTIVE_OPS.items() for op in spec["record"]}
PROFILE_COLLECTIVE_KIND: Dict[str, str] = {
    op: kind for kind, spec in COLLECTIVE_OPS.items() for op in spec["profile"]}
HLO_NAME: Dict[str, str] = {kind: spec["hlo"][0] for kind, spec in COLLECTIVE_OPS.items()}

# the overlap-eligible compute: matrix products (record) and GEMM kernels
RECORD_COMPUTE_OPS = ("mm", "bmm", "addmm", "baddbmm", "matmul")
_GEMM_KERNEL = re.compile(r"gemm|gemv|nvjet", re.I)
_NCCL_KERNEL = re.compile(r"^nccl(?:Dev)?Kernel_([A-Za-z]+)")

# how a call's trip (its chunks) shows in an artifact: the count of one kind
# of collective; the ring all-gather matmul's forward shows it as products a
# ring step instead (``_trip``); ``vocab_ce`` issues two all-reduces (the max
# and the sums) of one unchunked call
_TRIP_KIND = {
    "mm_reduce_scatter": "reducescatter", "mm_reduce_scatter.bwd": "allgather",
    "ring_ag_matmul.bwd": "reducescatter",
    "all_to_all": "alltoall", "all_to_all.bwd": "alltoall",
    "psum": "allreduce", "all_reduce": "allreduce", "all_reduce.bwd": "allreduce",
    "ppermute": "permute", "ppermute.bwd": "permute",
    "all_gather": "allgather", "all_gather.bwd": "reducescatter",
}
_RING = "ring_ag_matmul"


@dataclass(frozen=True)
class CollectiveOp:
    """One collective the artifact issued."""

    kind: str        # canonical kind (COLLECTIVE_OPS key)
    raw: str         # op or kernel as spelled in the artifact
    bytes: float = 0.0   # payload bytes (the record; 0.0 in a profile)
    trip: int = 1    # trip of the call it was issued in (1 = no call)
    depth: int = 0   # 1 inside a helper call, else 0


@dataclass(frozen=True)
class ChunkLoop:
    """One helper call, summarized by what one chunk of it issued — the
    shape the overlap verifier matches tuned chunk counts against."""

    trip: int                    # chunks; 0 = not visible in the artifact
    kinds: Tuple[str, ...]       # collective kinds of a chunk (sorted)
    n_collectives: int           # collectives a chunk
    has_compute: bool            # products interleaved (see the module doc)
    depth: int                   # nesting depth of the call
    source: str = "call"         # the helper's op (``mm_reduce_scatter``, ...)


@dataclass
class OpGraph:
    """The extracted collective/compute structure of one artifact."""

    source: str                          # "record" | "profile"
    collectives: List[CollectiveOp] = field(default_factory=list)
    loops: List[ChunkLoop] = field(default_factory=list)
    compute_ops: int = 0

    def count(self, kind: str) -> int:
        """Number of collective ops of ``kind``."""
        return sum(1 for c in self.collectives if c.kind == kind)

    def chunk_loops(self, kind: Optional[str], *, trip: Optional[int] = None,
                    has_compute: Optional[bool] = None) -> List[ChunkLoop]:
        """Loops whose body contains a ``kind`` collective (``kind=None``:
        compute-only loops with no collective at all), optionally filtered
        by exact ``trip`` and by whether the body also computes."""
        out = []
        for lp in self.loops:
            if kind is None:
                if lp.kinds or not lp.has_compute:
                    continue
            elif kind not in lp.kinds:
                continue
            if trip is not None and lp.trip != trip:
                continue
            if has_compute is not None and lp.has_compute != has_compute:
                continue
            out.append(lp)
        return out


# ---------------------------------------------------------------------------
# one call's loop, from the ordered events of either artifact
# ---------------------------------------------------------------------------

def _pairs(events) -> List[Tuple[str, str, float]]:
    """The call's collectives with each send paired to a receive, in
    order: (kind, raw, bytes)."""
    sends = [e for e in events if e[0] == "coll" and e[2].startswith("send")]
    recvs = [e for e in events if e[0] == "coll" and e[2].startswith("recv")]
    out = [(e[1], e[2], e[3]) for e in events
           if e[0] == "coll" and not e[2].startswith(("send", "recv"))]
    for s, r in itertools.zip_longest(sends, recvs):
        out.append(("permute", "send/recv" if s and r else (s or r)[2],
                    max((s or r)[3], (r or s)[3])))
    return out


def _trip(op: str, n: Counter, products: int) -> Optional[int]:
    """The call's chunks as the artifact shows them, or None where it does
    not show them."""
    if op == _RING:
        steps = n["permute"] + 1
        return products // steps if products % steps == 0 else None
    kind = _TRIP_KIND.get(op)
    return n[kind] if kind and n[kind] else None


def _interleaved(seq: List[str]) -> bool:
    """Whether a product ("mm") comes between two collectives in ``seq``."""
    first = seq.index("coll") if "coll" in seq else len(seq)
    rest = seq[first + 1:]
    return "mm" in rest and "coll" in rest[rest.index("mm"):]


def _loop(op: str, colls, seq: List[str], products: int, trip: Optional[int],
          source: str) -> ChunkLoop:
    kinds = Counter(k for k, _, _ in colls)
    if op == _RING:           # compute-only: the hops are the ring's
        return ChunkLoop(trip=trip or 0, kinds=(), n_collectives=0,
                         has_compute=products > 0, depth=1, source=op)
    return ChunkLoop(trip=trip or 0, kinds=tuple(sorted(kinds)),
                     n_collectives=len(colls) // max(1, trip or 1) if kinds else 0,
                     has_compute=(_interleaved(seq) if source == "record"
                                  else products > 0),
                     depth=1, source=op)


# ---------------------------------------------------------------------------
# the record: a dispatch mode over one run
# ---------------------------------------------------------------------------

@dataclass
class Call:
    """One helper call seen by ``capture``: its op, site, ordered events
    and its ``Issued`` row."""
    op: str
    site: str
    events: list = field(default_factory=list)
    issued: Optional[C.Issued] = None
    rows_at_open: int = 0


def _nbytes(a) -> float:
    if isinstance(a, torch.Tensor):
        return float(a.numel() * a.element_size())
    if isinstance(a, (list, tuple)):
        return sum(_nbytes(b) for b in a)
    return 0.0


class _RecordMode(TorchDispatchMode):
    def __init__(self, cap: "Capture"):
        super().__init__()
        self.cap = cap

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = getattr(func, "_schema", None)        # None: a higher-order op
        if schema is None:
            return out
        ns, _, name = schema.name.partition("::")
        if ns == "c10d" and name in RECORD_COLLECTIVE_KIND:
            # the first argument is the result buffer (or the tensors reduced
            # or sent in place): the reference's HLO counts result bytes
            self.cap.event(("coll", RECORD_COLLECTIVE_KIND[name], name,
                            _nbytes(args[0] if args else None)))
        elif ns == "aten" and name in RECORD_COMPUTE_OPS:
            self.cap.event(("mm", name))
        return out


class Capture:
    """The record of one run (``capture``): ``events`` in issue order,
    each ``("coll", kind, op, bytes)``, ``("mm", op)`` or ``("call",
    Call)``, a call holding the events of its span."""

    def __init__(self):
        self.events: list = []
        self.rows: List[C.Issued] = []
        self._open: List[Call] = []

    def event(self, ev) -> None:
        (self._open[-1].events if self._open else self.events).append(ev)

    def _span(self, op: str, site: str, opening: bool) -> None:
        if opening:
            self._open.append(Call(op, site, rows_at_open=len(self.rows)))
            return
        call = self._open.pop()
        for row in reversed(self.rows[call.rows_at_open:]):
            if (row.site, row.op) == (site, op):
                call.issued = row
                break
        self.event(("call", call))


class capture:
    """``with capture() as cap:`` records what the block issues: every
    ``c10d`` collective and matrix product (a ``TorchDispatchMode``), each
    helper call's span, and its ``Issued`` row (``record_issued``).  Not
    reentrant; a backward run inside the block is recorded too."""

    def __enter__(self) -> Capture:
        self.cap = Capture()
        self._issued = C.record_issued()
        self.cap.rows = self._issued.__enter__()
        C.SPAN_LISTENERS.append(self.cap._span)
        self._mode = _RecordMode(self.cap)
        self._mode.__enter__()
        return self.cap

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            C.SPAN_LISTENERS.remove(self.cap._span)
            self._issued.__exit__(*exc)
        return False


def graph_from_record(cap: Capture) -> OpGraph:
    """The op graph of a capture: one ``ChunkLoop`` for each helper call,
    every collective (those outside any call at trip 1).  A call's loop is
    checked against its ``Issued`` row: where the record shows its chunks
    they must be the row's, and its collectives (a send and a receive
    counted once) the row's, or ``ValueError`` is raised."""
    g = OpGraph(source="record")

    def walk(events, trip: int, depth: int) -> None:
        for ev in events:
            if ev[0] == "mm":
                g.compute_ops += 1
        for kind, raw, nbytes in _pairs([e for e in events if e[0] == "coll"]):
            g.collectives.append(CollectiveOp(kind=kind, raw=raw, bytes=nbytes,
                                              trip=trip, depth=depth))
        for ev in events:
            if ev[0] != "call":
                continue
            call = ev[1]
            own = [e for e in call.events if e[0] != "call"]
            colls = _pairs([e for e in own if e[0] == "coll"])
            products = sum(1 for e in own if e[0] == "mm")
            seq = [e[0] for e in own]
            trip_seen = _trip(call.op, Counter(k for k, _, _ in colls), products)
            row = call.issued
            if row is not None:
                if trip_seen is not None and trip_seen != row.num_chunks:
                    raise ValueError(
                        f"{call.op} at {call.site}: the record shows {trip_seen} "
                        f"chunk(s), its Issued row {row.num_chunks}")
                if len(colls) != row.collectives:
                    raise ValueError(
                        f"{call.op} at {call.site}: the record shows {len(colls)} "
                        f"collective(s), its Issued row {row.collectives}")
            trip = trip_seen or (row.num_chunks if row is not None else 1)
            g.loops.append(_loop(call.op, colls, seq, products, trip, "record"))
            walk(call.events, max(1, trip), depth + 1)

    walk(cap.events, 1, 0)
    return g


def collective_bytes(cap: Capture) -> Dict[str, float]:
    """Payload bytes of every collective the capture issued, summed by the
    reference's HLO opcode (each call counted once: a ring hop's send and
    receive once), with their number under ``"count"``."""
    out: Dict[str, float] = {name: 0.0 for name in HLO_NAME.values()}
    out["count"] = 0
    for op in graph_from_record(cap).collectives:
        out[HLO_NAME[op.kind]] += op.bytes
        out["count"] += 1
    return out


# ---------------------------------------------------------------------------
# the profile: a torch.profiler chrome trace
# ---------------------------------------------------------------------------

def load_trace(trace) -> dict:
    """A chrome trace as a dict, from a dict, a path, or a finished
    ``torch.profiler.profile`` (exported to a temporary file)."""
    if isinstance(trace, dict):
        return trace
    if hasattr(trace, "export_chrome_trace"):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            trace.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.unlink(path)
    with open(trace) as f:
        return json.load(f)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# ProcessGroupNCCL's own range around each collective it issues
_NCCL_RANGE = "nccl:"
_RANGE_KINDS = (("reduce_scatter", "reducescatter"), ("allgather", "allgather"),
                ("all_gather", "allgather"), ("all_reduce", "allreduce"),
                ("allreduce", "allreduce"), ("all_to_all", "alltoall"),
                ("alltoall", "alltoall"), ("send", "permute"), ("recv", "permute"))


@dataclass
class _Device:
    """One kernel, copy or set the card ran."""
    name: str
    ts: float
    dur: float
    span: Optional[int]          # the innermost helper span its launch was in
    coll: Optional[int] = None   # the collective it belongs to (index), if any


@dataclass
class _Coll:
    """One collective the process group issued: a ``nccl:*`` range, or an
    NCCL kernel launched outside one."""
    kind: str
    raw: str
    span: Optional[int]


def _range_kind(name: str) -> Optional[str]:
    rest = name[len(_NCCL_RANGE):]
    for key, kind in _RANGE_KINDS:
        if key in rest:
            return kind
    return None


def _profile_parts(trace):
    """(spans [(tid, t0, t1, op, site)], collectives [_Coll], device events
    [_Device]) of a trace."""
    evs = load_trace(trace).get("traceEvents", [])
    spans, ranges = [], []
    for e in evs:
        name = e.get("name", "")
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0))
        if name.startswith(C.SPAN_PREFIX):
            op, _, site = name[len(C.SPAN_PREFIX):].partition("@")
            spans.append((e.get("tid"), t0, t1, op, site))
        elif name.startswith(_NCCL_RANGE):
            ranges.append((e.get("tid"), t0, t1, name))

    def inner(items, tid, t):
        best = None
        for i, it in enumerate(items):
            if it[0] == tid and it[1] <= t <= it[2] and (best is None or it[1] >= items[best][1]):
                best = i
        return best

    colls: List[_Coll] = []
    by_range: Dict[int, int] = {}
    for r, (tid, t0, _, name) in enumerate(ranges):
        sp = inner(spans, tid, t0)
        kind = _range_kind(name)
        if kind:
            by_range[r] = len(colls)
            colls.append(_Coll(kind, name[len(_NCCL_RANGE):], sp))
    launches = {}
    for e in evs:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = (e.get("tid"), float(e["ts"]))
    # a device event launched inside a ``nccl:`` range is that collective's
    # only on a stream no compute kernel runs on: an asynchronous
    # collective's range stays open until its work completes, over the
    # launches of the products that follow it
    found = []
    for e in evs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        where = launches.get((e.get("args") or {}).get("correlation"))
        sp = rg = None
        if where is not None:
            sp, rg = inner(spans, *where), inner(ranges, *where)
        found.append((e, sp, rg))
    if launches and not found:
        raise ValueError("the trace holds kernel launches but no device activity: the "
                         "profiler lost the card's events")
    compute = {(e.get("args") or {}).get("stream") for e, _, rg in found
               if not _NCCL_KERNEL.match(e.get("name", ""))
               and (rg is None or _GEMM_KERNEL.search(e.get("name", "")))}
    devices = []
    for e, sp, rg in found:
        d = _Device(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)), sp)
        m = _NCCL_KERNEL.match(d.name)
        if rg in by_range and (m or (e.get("args") or {}).get("stream") not in compute):
            d.coll = by_range[rg]
        elif m:
            kind = _kernel_kind(d.name, spans[sp][3] if sp is not None else "")
            if kind:
                d.coll = len(colls)
                colls.append(_Coll(kind, m.group(1), sp))
        devices.append(d)
    # a collective is what the card ran: a range none of whose kernels or
    # copies ran (an in-place all-reduce at one rank) issued nothing there
    ran = sorted({d.coll for d in devices if d.coll is not None})
    index = {old: new for new, old in enumerate(ran)}
    for d in devices:
        if d.coll is not None:
            d.coll = index[d.coll]
    return spans, [colls[i] for i in ran], devices


def _kernel_kind(name: str, op: str) -> Optional[str]:
    m = _NCCL_KERNEL.match(name)
    if not m:
        return None
    if m.group(1) == "SendRecv" and op.startswith("all_to_all"):
        return "alltoall"
    return PROFILE_COLLECTIVE_KIND.get(m.group(1))


def graph_from_profile(trace) -> OpGraph:
    """The op graph of a profile (a chrome trace: ``load_trace``).  A
    collective is a ``nccl:*`` range of ``ProcessGroupNCCL`` in which an
    NCCL kernel or copy ran (at one rank NCCL may run a copy for it, or
    nothing) or an NCCL kernel launched outside one; it belongs to the helper call whose
    span holds it, one ``ChunkLoop`` a span.  ``has_compute`` means a GEMM
    kernel was launched inside the span.  A call's trip is what its
    collectives show (0, not visible, where they do not)."""
    spans, colls, devices = _profile_parts(trace)
    g = OpGraph(source="profile")
    for i, (_, _, _, op, _) in enumerate(spans):
        mine = _pairs([("coll", c.kind, c.raw, 0.0) for c in colls if c.span == i])
        products = sum(1 for d in devices
                       if d.span == i and d.coll is None and _GEMM_KERNEL.search(d.name))
        trip = _trip(op, Counter(k for k, _, _ in mine), products)
        g.loops.append(_loop(op, mine, [], products, trip, "profile"))
        g.compute_ops += products
        for kind, raw, _ in mine:
            g.collectives.append(CollectiveOp(kind=kind, raw=raw, trip=max(1, trip or 1),
                                              depth=1))
    for kind, raw, _ in _pairs([("coll", c.kind, c.raw, 0.0) for c in colls
                                if c.span is None]):
        g.collectives.append(CollectiveOp(kind=kind, raw=raw))
    g.compute_ops += sum(1 for d in devices if d.span is None and d.coll is None
                         and _GEMM_KERNEL.search(d.name))
    return g


def nccl_overlap(trace) -> List[Dict]:
    """For each helper call that issued collectives: its op and site, the
    device ms of its collectives (NCCL's kernels and copies), and the ms of
    them during which another kernel ran (on any stream).  Measurements:
    no verdict reads them."""
    spans, colls, devices = _profile_parts(trace)
    busy = sorted((d.ts, d.ts + d.dur) for d in devices
                  if d.coll is None and not d.name.startswith("Memcpy")
                  and not d.name.startswith("Memset"))
    merged: List[List[float]] = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])

    def covered(a: float, b: float) -> float:
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged if x < b and y > a)

    rows: Dict[int, Dict] = {}
    for c in colls:
        if c.span is not None:
            _, _, _, op, site = spans[c.span]
            r = rows.setdefault(c.span, {"op": op, "site": site, "collectives": 0,
                                         "device_events": 0, "nccl_ms": 0.0,
                                         "under_compute_ms": 0.0})
            r["collectives"] += 1
    for d in devices:
        if d.coll is None or colls[d.coll].span is None:
            continue
        r = rows[colls[d.coll].span]
        r["device_events"] += 1
        r["nccl_ms"] += d.dur / 1e3
        r["under_compute_ms"] += covered(d.ts, d.ts + d.dur) / 1e3
    return [rows[i] for i in sorted(rows)]


__all__ = ["COLLECTIVE_OPS", "Capture", "ChunkLoop", "CollectiveOp", "OpGraph",
           "capture", "collective_bytes", "graph_from_profile", "graph_from_record",
           "load_trace", "nccl_overlap"]
