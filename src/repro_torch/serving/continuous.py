"""Continuous batching of the port (counterpart of
``repro.serving.continuous``): per-slot caches and a request queue.

The fixed-batch Engine decodes one batch of prompts in lockstep until the
last is done.  Here every slot is refilled as it frees: the slots are the
batch rows of one set of caches whose ``pos`` is a (slots,) tensor, and
one decode call advances them all (the reference vmaps its
single-sequence decode over a slot axis).  Finished slots are refilled
from the queue without disturbing the others.  A MoE model's experts
route each slot's tokens alone, with its own capacity, at admit and at
every step (``route_rows``), as the reference's vmap over slots routes
each sequence alone: a batch-wide routing would let the slots, idle ones
included, take each other's capacity.

Admits prefill fresh caches at position 0 through the same cached-prefill
path as the fixed engine (flash attention on the card), mark the right-pad
slots dead, and copy the rows into their slots: the copy overwrites every
row of a slot's caches, so a reused slot is reset before it serves again
(the port's caches change in place, where the reference's are
functional).  The recurrent families need equal-length prompts in one
admit (a state absorbs padding): ragged admits raise ``ValueError``.  The
engine is decoder-only, as the reference's: an audio model raises
``ValueError`` (serve it with the fixed engine).  A vlm model is served
on text, an MLA model with its compressed cache, each slot at its own
position.

Plan-aware serving: with ``repo=`` the engine re-resolves the tuned plan
at admit time as the in-flight batch shape drifts (the repository's
tolerance band picks the plan for the current shape); with ``plan=`` the
plan is pinned and ``set_plan`` hot-swaps it between ticks.  Each plan's
steps are kept per plan digest.  Fault-aware serving mirrors the
fixed-batch engine: a flagged site is re-tuned or demoted between ticks.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.serving.engine import (PlannedEngine, _invalidate_pad_slots,
                                        _with_pos, check_equal_lengths)
from repro_torch.serving.plans import DEFAULT_BAND
from repro_torch.serving.types import Request

__all__ = ["ContinuousEngine", "Request"]


def _leaves(tree, path=()):
    """(path, tensor) for every tensor leaf of a cache tree."""
    for name, a in tree.items():
        if isinstance(a, dict):
            yield from _leaves(a, path + (name,))
        elif torch.is_tensor(a):
            yield path + (name,), a


def _slot_axes(cfg, max_seq: int) -> Dict[tuple, int]:
    """Each cache leaf's batch axis, from the shapes of caches for one and
    for two sequences (on the meta device: nothing is allocated)."""
    one = dict(_leaves(M.init_caches(cfg, 1, max_seq, device="meta")))
    two = dict(_leaves(M.init_caches(cfg, 2, max_seq, device="meta")))
    return {path: next(i for i, (a, b) in enumerate(zip(one[path].shape, two[path].shape))
                       if a != b)
            for path in one}


class ContinuousEngine(PlannedEngine):
    """``slots`` independent sequences decoded as one batch."""

    route_rows = True

    def __init__(self, cfg, params, *, slots: int, max_seq: int,
                 eos_id: Optional[int] = None, backend: Optional[str] = None,
                 plan=None, repo=None, plan_hardware: str = "h100-sxm",
                 plan_parallel=None, plan_band: float = DEFAULT_BAND, mesh=None,
                 fault_schedule=None, health_window: int = 3,
                 health_tolerance: float = 0.25, retune=None,
                 plan_lint: str = "error"):
        if cfg.family == "audio":
            raise ValueError("the continuous engine is decoder-only: serve an audio "
                             "model with the fixed engine")
        self.slots = slots
        self.eos_id = eos_id
        self._bind_plan(cfg, params, max_seq=max_seq, backend=backend, plan=plan,
                        repo=repo, plan_hardware=plan_hardware,
                        plan_parallel=plan_parallel, plan_band=plan_band, mesh=mesh,
                        fault_schedule=fault_schedule, health_window=health_window,
                        health_tolerance=health_tolerance, retune=retune,
                        plan_lint=plan_lint)
        self.caches = M.init_caches(cfg, slots, max_seq, device=self.device)
        self._axes = _slot_axes(cfg, max_seq)
        self._pos = np.zeros(slots, np.int64)          # each slot's position
        self._active: Dict[int, Request] = {}          # slot -> request
        self._queue: List[Request] = []
        self._cur = torch.zeros((slots,), dtype=torch.int64, device=self.device)
        self._resolved_n: Optional[int] = None         # batch size last resolved

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _admit(self, prefill) -> None:
        free = [s for s in range(self.slots) if s not in self._active]
        n = min(len(free), len(self._queue))
        if not n:
            return
        lens = [len(r.prompt) for r in self._queue[:n]]
        check_equal_lengths(self.cfg, lens)
        admits = [(free[i], self._queue.pop(0)) for i in range(n)]
        for slot, req in admits:
            self._active[slot] = req
        toks = np.zeros((n, max(lens)), np.int64)
        for i, (_, r) in enumerate(admits):
            toks[i, :len(r.prompt)] = r.prompt
        fresh = M.init_caches(self.cfg, n, self.max_seq, device=self.device)
        filled = prefill({"tokens": torch.as_tensor(toks, device=self.device)}, fresh)
        _invalidate_pad_slots(filled, torch.as_tensor(lens, device=self.device))
        # copy the admitted rows over their slots' whole rows (a reset)
        slots = [s for s, _ in admits]
        ids = torch.as_tensor(slots, device=self.device)
        new = dict(_leaves(filled["trunk"]))
        for path, leaf in _leaves(self.caches["trunk"]):
            leaf.index_copy_(self._axes[("trunk",) + path], ids, new[path])
        self._pos[slots] = lens
        last = [int(r.prompt[-1]) for _, r in admits]
        self._cur[ids] = torch.as_tensor(last, device=self.device)

    # ------------------------------------------------------------------
    def run(self, *, max_ticks: int = 1000) -> List[Request]:
        """Drive until queue + active slots drain; returns finished requests."""
        done: List[Request] = []
        with torch.inference_mode():
            for _ in range(max_ticks):
                if not self._active and not self._queue:
                    break
                # admissions change the in-flight shape, so re-resolve the
                # plan (repo-bound engines may land on a different banded
                # hit); an unchanged batch size keeps its plan.
                n_after = max(1, min(self.slots, len(self._active) + len(self._queue)))
                if n_after != self._resolved_n:
                    self._binding.resolve(n_after)
                    self._resolved_n = n_after
                step, prefill = self._compiled(self._binding.current)
                self._admit(prefill)
                if not self._active:
                    break
                pos = torch.as_tensor(self._pos, device=self.device)
                t0 = time.perf_counter()
                nxt, caches = step(self._cur[:, None], _with_pos(self.caches, pos))
                row = nxt[:, 0].tolist()                 # device sync
                dt = time.perf_counter() - t0
                self.caches = _with_pos(caches, 0)
                self._after_step(dt)
                self._cur = nxt[:, 0]
                finished = []
                for slot, req in self._active.items():
                    t = int(row[slot])
                    req.out.append(t)
                    if len(req.out) >= req.max_new or t == self.eos_id:
                        finished.append(slot)
                for slot in finished:
                    done.append(self._active.pop(slot))
                # active slots advance; idle ones stay at position 0 (they
                # decode a token that is thrown away, written over at admit)
                live = np.zeros(self.slots, bool)
                live[list(self._active)] = True
                self._pos = np.where(live, self._pos + 1, 0)
        return done
