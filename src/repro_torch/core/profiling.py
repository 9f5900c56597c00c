"""The port's own copy of ``repro.core.profiling``.

Batched profiling engine — vectorized ProfileTime for the tuner hot path.

DESIGN
======
``Simulator.run_group`` is an event-driven loop: two serialized streams
(computation / communication) advance in continuous time, and between any
two head-completion events both heads progress *linearly* at rates fixed by
the pair ``(ci, ki)`` of current stream heads.  That piecewise-linear shape
admits a closed-form segment computation built from two small rate tables:

  * ``comp_dur[i, k]`` — duration of comp op i under comm config k, for
    k in ``0..N`` (column N = no active comm, i.e. ``comp_time_alone``);
  * ``comm_dur[k, active?]`` — duration of comm op k with/without an active
    computation stealing bandwidth.

The tables come from the vectorized ``contention.comp_time_v`` /
``comm_time_v`` kernels, which keep the scalar functions' exact float64
operation order — engine measurements equal the sequential event loop
BIT-FOR-BIT (tests/test_profiling.py asserts ``==``, never approx).

Two advance strategies share the tables:

  1. **Column-cached replay** (batches below ``_VECTOR_MIN``): each table
     column depends only on ``(group structure, comm slot, that slot's
     config)``, so columns are LRU-cached and a candidate's table is
     assembled by lookup; the remaining per-candidate replay is a handful
     of float ops per event.  This is what the tuner's 3–5-candidate
     batches hit, and it is valid in BOTH noise modes because jitter
     multiplies the cached rates after assembly.
  2. **Lock-step array advance** (batches of ``_VECTOR_MIN`` or more): all
     candidates' streams advance together with NumPy array ops — per
     iteration, gather every candidate's current-head durations, take the
     per-candidate ``min`` segment, retire heads.  The Python-level loop
     runs at most ~M+N times regardless of batch size, so interpreter cost
     amortizes across the candidate set.  The advance is HETEROGENEOUS:
     candidates may come from *different* overlap groups (the cross-group
     scheduler's round-robin batches) — each candidate carries its own
     (M, N) and its tables are padded to the batch maxima; padding entries
     are never selected by the masked gathers.  Table assembly is
     GATHER-BASED: every cached column also lives in append-only id-indexed
     stores (flat comm-duration arrays; one stacked comp matrix per group
     structure), so a batch's padded tables are built with a handful of
     fancy-index reads per distinct structure instead of per-candidate
     row copies — per-candidate assembly was a large share of the fixed
     cost that used to push the lock-step break-even near ~100 candidates
     (see ``_VECTOR_MIN``).  The stores are append-only while batches are
     in flight — gather ids must stay stable — and a key->id map that
     survives LRU eviction lets a column recomputed after eviction reuse
     its original rows (column values are deterministic functions of the
     key).  When eviction churn grows the stores past twice the cache
     bound they are compacted from the live cache at the next engine-call
     boundary (``_maybe_compact_stores``), so ``cache_size`` keeps its
     memory-cap contract.

``measure_many_grouped`` is the scheduler's entry point: a list of
``(group, cfg_lists)`` requests evaluated in one pass, sharing the
rate-column cache across requests and deduplicating identical
``(fingerprint, configs)`` candidates *within* the call — the engine
computes each unique point once and fans the shared measurement out.
(The scheduler's deterministic trajectory sharing already collapses
identical groups *before* submission, so in-tree the dedup mainly guards
duplicate candidate lists inside one ``profile_many`` batch and direct
``run_interleaved`` users that skip sharing.)

Noise-mode semantics: every noisy candidate is one *submission* holding a
counter-based ticket from the simulator's ``core.noise`` model (tickets
issued in flat submission order: requests in order, candidates within a
request in list order).  Jitter multipliers — one lognormal per comp then
per comm — are a pure function of the ticket, so the engine draws a whole
batch in one vectorized Philox read while the ``batched=False`` reference
path re-derives bit-identical values per ``run_group`` call.  In CRN mode
tickets are keyed per structural fingerprint and indexed per group
trajectory (``core.noise`` docstring), which the cross-group scheduler
exploits for trajectory sharing; the engine itself only forwards group
identity to the ticket issue.  Noisy mode never deduplicates: every
submitted candidate is its own submission.

Cache-key semantics: the measurement-level LRU ``ProfileCache`` keys on a
*structural* fingerprint of the group (op shapes/bytes; names excluded —
a transformer stack of structurally identical layers shares one entry per
config) plus the tuple of configs with the ``done`` flag normalized away
(it never enters the math).  Hits return a shared measurement object whose
``name`` is the first structurally-identical group measured — measurements
are immutable value objects and nothing reads ``.name`` programmatically,
so structural sharing stays observable only as speed.  **Noisy mode
bypasses the measurement cache entirely** (both lookup and fill): jittered
measurements are draws, not values, and replaying one would both break
RNG-stream reproducibility and let a tuner overfit a lucky sample.  The
rate-column cache is deterministic pre-jitter math and is shared by both
modes.  ``Simulator.profile_count`` counts *logical* ProfileTime
invocations — cache hits increment it — so Fig. 8c tuning-efficiency
accounting is unchanged by the engine.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import contention as C
from repro_torch.core.comm_params import CommConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.workload import OverlapGroup

_TINY = 1e-12                       # head-completion epsilon (matches run_group)


def group_fingerprint(g: OverlapGroup) -> Tuple:
    """Structural identity of a group for caching: everything the contention
    model reads, nothing it doesn't (names excluded).  A comm's fabric tier
    joins the key only when set — it selects the pricing hardware under a
    hierarchical topology — so pre-topology fingerprints stay stable."""
    return (
        tuple((c.flops, c.bytes_rw, c.threadblocks, c.tb_per_slot,
               c.bytes_per_tb) for c in g.comps),
        tuple((c.kind, c.bytes, c.group_size) + ((c.tier,) if c.tier else ())
              for c in g.comms),
    )


def _cfg_key(cfg: CommConfig) -> Tuple:
    # ``done`` is a tuner bookkeeping flag with no effect on measurements.
    return (cfg.algorithm, cfg.protocol, cfg.transport,
            cfg.nc, cfg.nt, cfg.chunk_kb)


class ProfileCache:
    """Generic LRU keyed on hashable tuples (measurements / rate columns)."""

    def __init__(self, maxsize: int = 131072):
        self.maxsize = maxsize
        self._d: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> Dict[str, int]:
        return dict(size=len(self._d), hits=self.hits, misses=self.misses,
                    evictions=self.evictions)


class _GrowStore:
    """Amortized-O(1) append + O(1) read view: a capacity-doubling ndarray
    (1-D for scalars, 2-D for fixed-width rows).  Backs the gather stores
    so registering a column never triggers a full-store rebuild — the
    reallocation cost is amortized across appends, and ``view()`` is a
    slice of the live buffer (taken fresh per batch; a view captured
    before a reallocating append still reads correct values for every id
    that existed when it was taken)."""

    def __init__(self, width: Optional[int] = None):
        self.n = 0
        shape = (16,) if width is None else (16, width)
        self._buf = np.empty(shape)

    def append(self, row) -> int:
        if self.n == len(self._buf):
            grown = np.empty((2 * len(self._buf),) + self._buf.shape[1:])
            grown[:self.n] = self._buf
            self._buf = grown
        self._buf[self.n] = row
        self.n += 1
        return self.n - 1

    def view(self) -> np.ndarray:
        return self._buf[:self.n]


class _GroupKernel:
    """Per-(group structure, hardware) static arrays for the batched math."""

    def __init__(self, g: OverlapGroup, hw: Hardware):
        self.M = len(g.comps)
        self.N = len(g.comms)
        self.comms = list(g.comms)
        lam = hw.num_slots
        # theta_base keeps the scalar expression order of contention.comp_time
        self.threadblocks = np.array([c.threadblocks for c in g.comps],
                                     dtype=np.int64)
        self.tb_per_slot = np.array([c.tb_per_slot for c in g.comps],
                                    dtype=np.int64)
        self.bytes_per_tb = np.array([c.bytes_per_tb for c in g.comps],
                                     dtype=np.float64)
        self.theta_base = np.array(
            [c.flops / c.threadblocks * c.tb_per_slot * lam / hw.achieved_flops
             for c in g.comps], dtype=np.float64)

    def comp_column(self, cfg, V, hw: Hardware) -> Tuple[float, ...]:
        """Durations of every comp op under one comm config (nc=chunk=V=0
        reproduces ``comp_time_alone`` exactly)."""
        nc = cfg.nc if cfg is not None else 0
        chunk = cfg.chunk_kb if cfg is not None else 0
        col = C.comp_time_v(self.theta_base, self.threadblocks,
                            self.tb_per_slot, self.bytes_per_tb,
                            nc, chunk, V, hw)
        return tuple(col.tolist()) if self.M else ()


class BatchSimulator:
    """Vectorized + cached ProfileTime.  One engine per ``Simulator`` —
    it shares the simulator's hardware profile, noise setting, and RNG."""

    # Batch size at which the lock-step array advance beats the scalar
    # column-cached replay.  The replay is a handful of float ops per event,
    # so NumPy's per-op dispatch only amortizes across a batch.  Gather-based
    # table assembly (id stores, no per-candidate row copies) plus the
    # saturating-head advance roughly halved the lock-step fixed cost, moving
    # the measured CPU break-even from ~96 candidates (PR 2) to the ~48-64
    # range across group shapes and load conditions; below it the flat
    # replay loop still wins on per-op overhead.
    _VECTOR_MIN = 48

    def __init__(self, sim, cache_size: int = 131072):
        self.sim = sim
        self.cache = ProfileCache(cache_size)      # measurements (noise-free)
        self.columns = ProfileCache(cache_size)    # rate columns (both modes)
        self._kernels: Dict[int, _GroupKernel] = {}
        self._fp_ids: Dict[Tuple, int] = {}        # fingerprint -> intern id
        self._groups: Dict[int, Tuple] = {}        # id(group) -> (group, fpi)
        self._alone: Dict[int, Tuple] = {}         # fpi -> alone comp column
        self.dedup_shared = 0   # within-call duplicate candidates fanned out
        # append-only gather stores backing the lock-step table assembly
        # (module docstring): kid indexes the flat comm-duration arrays,
        # rid the per-structure comp matrix.  kid 0 is a padding sentinel
        # (1.0 durations, never selected by the masked gathers).
        self._act = _GrowStore()
        self._idle = _GrowStore()
        self._act.append(1.0)
        self._idle.append(1.0)
        self._comp: Dict[int, _GrowStore] = {}          # fpi -> comp rows
        self._col_ids: Dict[Tuple, Tuple[int, int]] = {}    # permanent id map

    # -- public API ------------------------------------------------------
    #
    # Cache hits return a SHARED GroupMeasurement object (constructed once
    # at fill time, ``name`` taken from the first structurally-identical
    # group measured).  Measurements are value objects — callers must not
    # mutate them; nothing in the tree reads ``.name`` programmatically.

    def measure_one(self, g: OverlapGroup, cfgs: Sequence[CommConfig]):
        """Single-candidate ProfileTime — the cache-hit fast path (most
        logical profiles of a structurally repeated workload are hits)."""
        from repro_torch.core.simulator import GroupMeasurement

        self._maybe_compact_stores()
        fpi, kern = self._resolve(g)
        if self.sim.noise:
            jit = self.sim._noise.draw(g, 1, kern.M + kern.N)[0]
            p = self._measure_one(kern, fpi, cfgs, True, jit=jit)
            return GroupMeasurement(g.name, p[0], p[1], p[2],
                                    list(p[3]), list(p[4]))
        key = (fpi, tuple(map(_cfg_key, cfgs)))
        gm = self.cache.get(key)
        if gm is None:
            p = self._measure_one(kern, fpi, cfgs, False)
            gm = GroupMeasurement(g.name, p[0], p[1], p[2],
                                  list(p[3]), list(p[4]))
            self.cache.put(key, gm)
        return gm

    def measure_many(self, g: OverlapGroup,
                     cfg_lists: Sequence[Sequence[CommConfig]]) -> List:
        """Measure every candidate config list for one group.  Does NOT
        touch ``profile_count`` — the Simulator wrappers own accounting."""
        if not cfg_lists:
            return []
        if len(cfg_lists) == 1:
            return [self.measure_one(g, cfg_lists[0])]
        return self.measure_many_grouped([(g, cfg_lists)])[0]

    def measure_many_grouped(
            self, requests: Sequence[Tuple[OverlapGroup,
                                           Sequence[Sequence[CommConfig]]]]
    ) -> List[List]:
        """Heterogeneous batched ProfileTime: each request is ``(group,
        cfg_lists)`` and the returned list of measurement lists aligns with
        the requests.  All requests' misses advance in ONE lock-step pass,
        sharing the per-group rate-column cache; identical noise-free
        candidates are computed once per call (within-call dedup).  Jitter
        draw order is the flat submission order (module docstring)."""
        from repro_torch.core.simulator import GroupMeasurement  # cycle-free late import

        self._maybe_compact_stores()
        noisy = bool(self.sim.noise)
        cache = self.cache
        results: List[List] = [[None] * len(cfg_lists)
                               for _, cfg_lists in requests]
        todo: List[Tuple] = []      # (kern, fpi, cfgs) in submission order
        keys: List = []             # cache key per todo entry (None if noisy)
        sinks: List[List] = []      # (request, slot) fan-outs per todo entry
        names: List[str] = []       # group name of the first submitter
        specs: List[Tuple] = []     # noise ticket runs (key, first, n, M+N)
        spans: List[Tuple] = []     # per run: (todo start, n, M, N)
        first: Dict[Tuple, int] = {}
        for ri, (g, cfg_lists) in enumerate(requests):
            if not cfg_lists:
                continue
            fpi, kern = self._resolve(g)
            if noisy:                       # every candidate is a submission
                key, start = self.sim._noise.reserve(g, len(cfg_lists))
                specs.append((key, start, len(cfg_lists), kern.M + kern.N))
                spans.append((len(todo), len(cfg_lists), kern.M, kern.N))
                for li, cfgs in enumerate(cfg_lists):
                    todo.append((kern, fpi, cfgs))
                    keys.append(None)
                    sinks.append([(ri, li)])
                    names.append(g.name)
                continue
            for li, cfgs in enumerate(cfg_lists):
                key = (fpi, tuple(map(_cfg_key, cfgs)))
                gm = cache.get(key)
                if gm is not None:
                    results[ri][li] = gm
                    continue
                ti = first.get(key)
                if ti is not None:          # duplicate within this call
                    sinks[ti].append((ri, li))
                    self.dedup_shared += 1
                    continue
                first[key] = len(todo)
                todo.append((kern, fpi, cfgs))
                keys.append(key)
                sinks.append([(ri, li)])
                names.append(g.name)
        if todo:
            # all runs' jitters in one pass — contiguous tickets (the whole
            # batch, in default mode) come from a single vectorized draw
            jit_mats = self.sim._noise.draw_reserved(specs) if noisy else None
            cols_list = self._gather_columns(todo)
            if len(todo) >= self._VECTOR_MIN:
                payloads = self._measure_lockstep(
                    todo, noisy, cols_list,
                    noise_blocks=(spans, jit_mats) if noisy else None)
            else:
                jrows: List = [None] * len(todo)
                if noisy:
                    for (t0, cnt, _, _), mat in zip(spans, jit_mats):
                        for i in range(cnt):
                            jrows[t0 + i] = mat[i]
                payloads = [self._measure_one(kern, fpi, cfgs, noisy, cols,
                                              jit=jrow)
                            for (kern, fpi, cfgs), cols, jrow
                            in zip(todo, cols_list, jrows)]
            for p, key, outs, name in zip(payloads, keys, sinks, names):
                gm = GroupMeasurement(name, p[0], p[1], p[2],
                                      list(p[3]), list(p[4]))
                if key is not None:
                    cache.put(key, gm)
                for ri, li in outs:
                    results[ri][li] = gm
        return results

    def cache_stats(self) -> Dict:
        """Hit/miss/eviction counters for both LRUs plus the within-call
        dedup fan-out count (benchmark telemetry)."""
        return {"measurements": self.cache.stats(),
                "columns": self.columns.stats(),
                "dedup_shared": self.dedup_shared}

    _GROUP_MEMO_MAX = 4096      # id-memo bound: ephemeral groups must not pin

    # -- group / column resolution ---------------------------------------
    def _resolve(self, g: OverlapGroup) -> Tuple[int, _GroupKernel]:
        ent = self._groups.get(id(g))
        if ent is not None and ent[0] is g:        # strong ref pins the id
            return ent[1], self._kernels[ent[1]]
        fp = group_fingerprint(g)
        fpi = self._fp_ids.setdefault(fp, len(self._fp_ids))
        if len(self._groups) >= self._GROUP_MEMO_MAX:
            self._groups.clear()    # drop pins; fingerprints just recompute
        self._groups[id(g)] = (g, fpi)
        if fpi not in self._kernels:
            self._kernels[fpi] = _GroupKernel(g, self.sim.hw)
        return fpi, self._kernels[fpi]

    def _alone_column(self, fpi: int, kern: _GroupKernel) -> Tuple:
        col = self._alone.get(fpi)
        if col is None:
            col = (kern.comp_column(None, 0.0, self.sim.hw),)
            col = col + (np.array(col[0], dtype=np.float64),)
            self._alone[fpi] = col
        return col

    def _register_column(self, key: Tuple, fpi: int, act: float, idle: float,
                         col_arr: np.ndarray) -> Tuple[int, int]:
        """Append a freshly computed column to the gather stores; returns
        its ``(kid, rid)`` ids.  Stores are append-only within an engine
        call so ids stay valid for every in-flight batch (module
        docstring).  The id map outlives LRU eviction of the cache entry,
        so a column recomputed after eviction reuses its original rows
        (column values are deterministic functions of the key); the
        eviction-churn growth this implies is bounded by
        ``_maybe_compact_stores`` at call boundaries."""
        ids = self._col_ids.get(key)
        if ids is not None:
            return ids
        kid = self._act.append(act)
        self._idle.append(idle)
        store = self._comp.get(fpi)
        if store is None:
            store = self._comp[fpi] = _GrowStore(width=col_arr.shape[0])
        rid = store.append(col_arr)
        self._col_ids[key] = (kid, rid)
        return kid, rid

    def _maybe_compact_stores(self) -> None:
        """Rebuild the gather stores from the LIVE column cache once
        eviction churn has grown them past twice the cache bound, so
        ``cache_size`` keeps its memory-cap contract.  Ids are remapped,
        which is only safe BETWEEN engine calls (per-batch ``cols_list``
        snapshots hold ids) — the public measure paths call this before
        resolving any column."""
        if self._act.n <= 2 * self.columns.maxsize:
            return
        self._act = _GrowStore()
        self._idle = _GrowStore()
        self._act.append(1.0)
        self._idle.append(1.0)
        self._comp = {}
        self._col_ids = {}
        live = self.columns._d
        for key in list(live):
            col, act, idle, col_arr = live[key][:4]
            kid, rid = self._register_column(key, key[0], act, idle, col_arr)
            live[key] = (col, act, idle, col_arr, kid, rid)

    def _comm_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._act.view(), self._idle.view()

    def _comp_matrix(self, fpi: int) -> np.ndarray:
        return self._comp[fpi].view()

    def _column(self, fpi: int, kern: _GroupKernel, k: int, cfg: CommConfig):
        """(comp durations under cfg, comm-op-k duration active/idle, comp
        durations as ndarray, comm store id, comp store row id) —
        everything the replay needs about slot k running ``cfg``.  Computed
        with the vectorized contention kernels (bit-identical to the scalar
        model; tests assert ``==``).  The tuple form feeds the scalar
        replay (tuple indexing is cheap in Python); the ndarray twin and
        the ids feed gather-based lock-step table assembly."""
        key = (fpi, k, _cfg_key(cfg))
        v = self.columns.get(key)
        if v is None:
            hw = self.sim.hw
            op = kern.comms[k]
            ceil_, cmult = C.PROTO_PARAMS[cfg.protocol]
            tmult = C.TRANSPORT_MULT[cfg.transport]
            wb = C.wire_bytes(op, cfg.algorithm)
            ns = C.comm_steps(op, cfg.algorithm)
            V = float(C.comm_bandwidth_draw_v(cfg.nc, cfg.chunk_kb,
                                              ceil_, tmult, hw))
            args = (op.bytes, wb, ns, cfg.nc, cfg.nt, cfg.chunk_kb,
                    ceil_, cmult, tmult)
            col = kern.comp_column(cfg, V, hw)
            act = float(C.comm_time_v(*args, hw, compute_active=True))
            idle = float(C.comm_time_v(*args, hw, compute_active=False))
            col_arr = np.array(col, dtype=np.float64)
            kid, rid = self._register_column(key, fpi, act, idle,
                                              col_arr)
            v = (col, act, idle, col_arr, kid, rid)
            self.columns.put(key, v)
        return v

    def _gather_columns(self, todo: Sequence[Tuple]) -> List[List]:
        """Resolve every candidate's rate columns for a batch, computing all
        misses in one vectorized pass (``_compute_columns``).  Keys are
        built ONCE per (candidate, slot) — the returned per-candidate column
        lists feed both replay strategies, so no second cache walk
        happens."""
        out: List[List] = []
        need: Dict[Tuple, Tuple] = {}   # key -> (kern, k, cfg), deduped
        holes: List[Tuple] = []         # (cols, k, key) to patch post-compute
        get = self.columns.get
        for kern, fpi, cfgs in todo:
            cols: List = [None] * len(cfgs)
            for k, cfg in enumerate(cfgs):
                key = (fpi, k, _cfg_key(cfg))
                v = get(key)
                if v is None:
                    need.setdefault(key, (kern, k, cfg))
                    holes.append((cols, k, key))
                else:
                    cols[k] = v
            out.append(cols)
        if need:
            computed = self._compute_columns(need)
            for cols, k, key in holes:
                cols[k] = computed[key]
        return out

    def _compute_columns(self, need: Dict[Tuple, Tuple]) -> Dict[Tuple, Tuple]:
        """Batch-compute missing rate columns: ONE vectorized
        ``comm_time_v`` pass for all comm columns across all groups/slots,
        and one broadcast ``comp_time_v`` per distinct group structure —
        instead of per-column kernel calls from inside the replay.
        Elementwise float64 ops are identical whether batched or scalar, so
        the cached values are bit-equal to what ``_column`` would have
        computed lazily."""
        hw = self.sim.hw
        need_keys = list(need.keys())
        need_vals = list(need.values())
        need_fpi = [key[0] for key in need_keys]
        K = len(need_keys)
        cols = np.empty((9, K))
        for i, (kern, k, cfg) in enumerate(need_vals):
            op = kern.comms[k]
            pc, pm = C.PROTO_PARAMS[cfg.protocol]
            cols[:, i] = (op.bytes, C.wire_bytes(op, cfg.algorithm),
                          C.comm_steps(op, cfg.algorithm), cfg.nc, cfg.nt,
                          cfg.chunk_kb, pc, pm,
                          C.TRANSPORT_MULT[cfg.transport])
        ob, wb, ns, nc, nt, ck, ceil_, cmult, tmult = cols
        act = C.comm_time_v(ob, wb, ns, nc, nt, ck, ceil_, cmult, tmult,
                            hw, compute_active=True).tolist()
        idle = C.comm_time_v(ob, wb, ns, nc, nt, ck, ceil_, cmult, tmult,
                             hw, compute_active=False).tolist()
        V = C.comm_bandwidth_draw_v(nc, ck, ceil_, tmult, hw)
        by_fpi: Dict[int, List[int]] = {}
        for i, fpi in enumerate(need_fpi):
            by_fpi.setdefault(fpi, []).append(i)
        comp: List = [None] * K
        for fpi, idx in by_fpi.items():
            kern = self._kernels[fpi]
            if kern.M:
                ii = np.array(idx)
                mat = C.comp_time_v(kern.theta_base, kern.threadblocks,
                                    kern.tb_per_slot, kern.bytes_per_tb,
                                    nc[ii][:, None], ck[ii][:, None],
                                    V[ii][:, None], hw)
                for r, i in enumerate(idx):
                    comp[i] = np.ascontiguousarray(mat[r])
            else:
                empty = np.empty(0)
                for i in idx:
                    comp[i] = empty
        out: Dict[Tuple, Tuple] = {}
        for i, key in enumerate(need_keys):
            kid, rid = self._register_column(key, need_fpi[i], act[i],
                                              idle[i], comp[i])
            v = (tuple(comp[i].tolist()), act[i], idle[i], comp[i], kid, rid)
            self.columns.put(key, v)
            out[key] = v
        return out

    # -- single-candidate replay over cached rate columns -----------------
    def _measure_one(self, kern: _GroupKernel, fpi: int,
                     cfgs: Sequence[CommConfig], noisy: bool,
                     cols: Optional[List] = None,
                     jit: Optional[np.ndarray] = None) -> Tuple:
        M, N = kern.M, kern.N
        alone = self._alone_column(fpi, kern)[0]
        if cols is None:
            cols = [self._column(fpi, kern, k, cfg)
                    for k, cfg in enumerate(cfgs)]
        if noisy:
            # ``jit`` is this submission's ticket draw (M comp then N comm)
            row = jit.tolist()
            jc = row[:M]
            jk = row[M:]
        else:
            jc = [1.0] * M
            jk = [1.0] * N

        ci = ki = 0
        cur_comp = cur_comm = 1.0
        t = comp_busy = comm_busy = 0.0
        comp_meas = [0.0] * M
        comm_meas = [0.0] * N
        d_comp = d_comm = math.inf
        guard = 0
        while ci < M or ki < N:
            guard += 1
            if guard > 100000:
                raise RuntimeError("simulator did not converge")
            comp_on = ci < M
            comm_on = ki < N
            if comp_on:
                base = cols[ki][0][ci] if comm_on else alone[ci]
                d_comp = base * jc[ci]
            if comm_on:
                d_comm = (cols[ki][1] if comp_on else cols[ki][2]) * jk[ki]
            rc = cur_comp * d_comp if comp_on else math.inf
            rk = cur_comm * d_comm if comm_on else math.inf
            dt = rc if rc <= rk else rk
            t += dt
            if comp_on:
                comp_busy += dt
                comp_meas[ci] += dt
                cur_comp -= dt / d_comp
                if cur_comp <= _TINY:
                    ci += 1
                    cur_comp = 1.0
            if comm_on:
                comm_busy += dt
                comm_meas[ki] += dt
                cur_comm -= dt / d_comm
                if cur_comm <= _TINY:
                    ki += 1
                    cur_comm = 1.0
        return (t, comm_busy, comp_busy, tuple(comm_meas), tuple(comp_meas))

    # -- lock-step array advance for large batches ------------------------
    def _measure_lockstep(self, entries: Sequence[Tuple], noisy: bool,
                          cols_list: Optional[List[List]] = None,
                          noise_blocks: Optional[Tuple] = None) -> List[Tuple]:
        """Advance a heterogeneous candidate batch in lock step.  Each entry
        is ``(kern, fpi, cfgs)`` — candidates may belong to different groups.
        Per-candidate tables are padded to the batch-wide (max M, max N);
        padding cells hold 1.0 and are never selected: the gathers clip
        indices to each candidate's own (M, N) and the ``where`` masks zero
        any contribution from finished streams.  Tables are assembled by
        gathering from the append-only id stores — a few fancy-index reads
        per distinct group structure, no per-candidate row copies.  In
        noisy mode ``noise_blocks`` carries the batch's pre-drawn ticket
        jitters as ``(spans, matrices)`` with one ``(count, M + N)`` matrix
        per contiguous same-group run."""
        Cn = len(entries)
        if cols_list is None:
            cols_list = self._gather_columns(entries)
        Ms = np.array([e[0].M for e in entries], dtype=np.int64)
        Ns = np.array([e[0].N for e in entries], dtype=np.int64)
        maxM, maxN = int(Ms.max()), int(Ns.max())
        # Tables carry one SATURATION row/column past the batch maxima so
        # head indices never need clipping: a head that retires its last op
        # stops at its own (M, N) — a valid index whose cells hold 1.0 (the
        # kid-0 sentinel / the np.ones fill) and whose contributions are
        # zeroed by the masks, while comm column N doubles as the alone
        # column.  This removes per-iteration clip/where traffic and the
        # M==0 / N==0 special cases from the advance loop.
        pad = [0] * (maxN + 1)          # kid 0 = 1.0 sentinel
        kid = np.array([[col[4] for col in cols] + pad[len(cols):]
                        for cols in cols_list], dtype=np.intp)
        act_arr, idle_arr = self._comm_arrays()
        comm_act = act_arr[kid]
        comm_idle = idle_arr[kid]
        comp_dur = np.ones((Cn, maxM + 1, maxN + 1))
        by_fpi: Dict[int, List[int]] = {}
        for c, (kern, fpi, cfgs) in enumerate(entries):
            if kern.M:
                by_fpi.setdefault(fpi, []).append(c)
        for fpi, idx in by_fpi.items():
            kern = self._kernels[fpi]
            M, N = kern.M, kern.N
            ii = np.array(idx, dtype=np.intp)
            if N:
                rid = np.array([[col[5] for col in cols_list[c]]
                                for c in idx], dtype=np.intp)
                # (n, N, M) gather -> (n, M, N) table block
                comp_dur[ii, :M, :N] = \
                    self._comp_matrix(fpi)[rid].transpose(0, 2, 1)
            # column N = this structure's alone rates
            comp_dur[ii, :M, N] = self._alone_column(fpi, kern)[1]
        if noisy:
            spans, mats = noise_blocks
            jc = np.ones((Cn, maxM + 1))
            jk = np.ones((Cn, maxN + 1))
            for (t0, cnt, M, N), mat in zip(spans, mats):
                if M:
                    jc[t0:t0 + cnt, :M] = mat[:, :M]
                if N:
                    jk[t0:t0 + cnt, :N] = mat[:, M:]
            comp_dur = comp_dur * jc[:, :, None]
            comm_act = comm_act * jk
            comm_idle = comm_idle * jk

        ar = np.arange(Cn)
        ci = np.zeros(Cn, dtype=np.int64)
        ki = np.zeros(Cn, dtype=np.int64)
        cur_comp = np.ones(Cn)
        cur_comm = np.ones(Cn)
        t = np.zeros(Cn)
        comp_busy = np.zeros(Cn)
        comm_busy = np.zeros(Cn)
        comp_meas = np.zeros((Cn, maxM + 1))
        comm_meas = np.zeros((Cn, maxN + 1))

        guard = 0
        while True:
            comp_on = ci < Ms
            comm_on = ki < Ns
            alive = comp_on | comm_on
            if not alive.any():
                break
            guard += 1
            if guard > 4 * (maxM + maxN) + 16:
                raise RuntimeError("batched simulator did not converge")

            # ki == N selects the alone column / a 1.0 pad cell; retired
            # heads gather 1.0 durations so the masked updates divide by 1
            d_comp = comp_dur[ar, ci, ki]
            d_comm = np.where(comp_on, comm_act[ar, ki], comm_idle[ar, ki])
            rem_comp = np.where(comp_on, cur_comp * d_comp, np.inf)
            rem_comm = np.where(comm_on, cur_comm * d_comm, np.inf)
            dt = np.where(alive, np.minimum(rem_comp, rem_comm), 0.0)
            t += dt

            dtc = np.where(comp_on, dt, 0.0)
            comp_busy += dtc
            comp_meas[ar, ci] += dtc
            cur_comp = cur_comp - dtc / d_comp
            fin = comp_on & (cur_comp <= _TINY)
            ci = ci + fin
            cur_comp = np.where(fin, 1.0, cur_comp)

            dtk = np.where(comm_on, dt, 0.0)
            comm_busy += dtk
            comm_meas[ar, ki] += dtk
            cur_comm = cur_comm - dtk / d_comm
            fin = comm_on & (cur_comm <= _TINY)
            ki = ki + fin
            cur_comm = np.where(fin, 1.0, cur_comm)

        tl, xb, yb = t.tolist(), comm_busy.tolist(), comp_busy.tolist()
        km, cm = comm_meas.tolist(), comp_meas.tolist()
        return [(tl[c], xb[c], yb[c], tuple(km[c][:e[0].N]),
                 tuple(cm[c][:e[0].M]))
                for c, e in enumerate(entries)]
