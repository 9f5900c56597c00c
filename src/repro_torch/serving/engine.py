"""Fixed-batch serving engine of the port (PyTorch counterpart of
``repro.serving.engine``): prefill right-padded prompts into the caches in
one pass, then decode greedily in lockstep.

On the card the prefill and every decode step run the port's CUDA kernels
(``kernels.ops`` counts the launches): RMSNorm and, at prefill, flash
attention for the dense and hybrid families, the SSD scan for zamba2's
Mamba2 layers and the WKV6 scan for rwkv6.  The recurrent families
(``ssm``, ``hybrid``) need equal-length prompts, as in the reference: a
recurrent state would absorb the right padding, so ragged prompts raise
``ValueError`` (the reference asserts).  The reference's plan surface
(``plan=``, ``repo=``, ``mesh=``, fault schedules, online re-tuning) binds
collectives across chips; those keywords raise ``NotImplementedError``
until the port's tensor-parallel serving slice.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.layers import SERVING_SLICE
from repro_torch.serving.types import Request

__all__ = ["Engine", "Request", "make_serve_step"]

# the reference Engine's plan, fault and re-tune keywords
PLAN_KEYWORDS = ("plan", "repo", "plan_hardware", "plan_parallel", "plan_band", "mesh",
                 "fault_schedule", "health_window", "health_tolerance", "retune",
                 "plan_lint")
RECURRENT = ("ssm", "hybrid")      # families whose caches carry recurrent states


def make_serve_step(cfg, *, backend: Optional[str] = None, mesh=None):
    """serve_step(params, tokens (B,1), caches[, pos_offset (B,)]) ->
    (next (B,1), caches)."""
    if mesh is not None:
        raise NotImplementedError(f"the sited decode path (mesh=) arrives with {SERVING_SLICE}")

    def serve_step(params, tokens, caches, pos_offset=None):
        logits, caches = M.decode_step(cfg, params, tokens, caches, backend=backend,
                                       pos_offset=pos_offset)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], caches
    return serve_step


def _invalidate_pad_slots(caches, lens: torch.Tensor):
    """Mark right-pad KV slots dead per row: ``slot_pos`` leaves are
    (..., B, W); slots at index >= the row's true length get -1 so decode
    never attends to them.  In place."""
    for name, leaf in caches.items():
        if isinstance(leaf, dict):
            _invalidate_pad_slots(leaf, lens)
        elif name == "slot_pos":
            idx = torch.arange(leaf.shape[-1], device=leaf.device)
            leaf.masked_fill_(idx[None, :] >= lens[:, None], -1)
    return caches


class Engine:
    """Fixed-batch decode engine."""

    def __init__(self, cfg, params, *, batch_size: int, max_seq: int,
                 backend: Optional[str] = None, **plan_kw):
        unknown = sorted(set(plan_kw) - set(PLAN_KEYWORDS))
        if unknown:
            raise TypeError(f"Engine got unexpected keyword arguments {unknown}")
        given = sorted(k for k, v in plan_kw.items() if v is not None)
        if given:
            raise NotImplementedError(f"{given}: plans, fault-aware serving and online "
                                      f"re-tuning arrive with {SERVING_SLICE}")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.backend = backend
        self.device = next(params.parameters()).device
        self._step = make_serve_step(cfg, backend=backend)
        # wall times of the last generate(): prefill, and each decode step
        self.last_timing: Dict[str, object] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, prompts: List[np.ndarray]):
        """Right-pad and prefill the prompts; returns (caches, first decode
        input (B,1), per-row position offsets (B,))."""
        if len(prompts) != self.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of {self.batch}")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, plen), np.int64)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        if self.cfg.family in RECURRENT and len(set(lens.tolist())) > 1:
            raise ValueError(f"{self.cfg.family} serving needs equal-length prompts "
                             f"(a recurrent state absorbs right padding); got lengths "
                             f"{sorted(set(lens.tolist()))}")
        for i, p in enumerate(prompts):    # right-pad; causal mask + per-row
            toks[i, :len(p)] = p           # slot_pos invalidation keep pads out
        caches = M.init_caches(self.cfg, self.batch, self.max_seq, device=self.device)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        caches = self._prefill_ragged(batch, caches, lens)
        # decode each row from its true last token; the shared position
        # counter sits at plen, so subtract each row's pad gap.
        cur = torch.as_tensor(toks[np.arange(self.batch), lens - 1][:, None],
                              device=self.device)
        offs = torch.as_tensor(plen - lens, device=self.device)
        return caches, cur, offs

    def _prefill_ragged(self, batch, caches, lens: np.ndarray):
        caches = M.forward_hidden(self.cfg, self.params, batch, caches,
                                  backend=self.backend)[1]
        if self.cfg.family in RECURRENT:    # equal lengths: no pad slot to mark
            return caches
        return _invalidate_pad_slots(caches, torch.as_tensor(lens, device=self.device))

    # ------------------------------------------------------------------
    def generate(self, prompts: List[np.ndarray], *, max_new: int = 32) -> List[List[int]]:
        with torch.inference_mode():
            t0 = time.perf_counter()
            caches, cur, offs = self._start(prompts)
            self._sync()
            prefill_s = time.perf_counter() - t0
            outs: List[List[int]] = [[] for _ in range(self.batch)]
            steps = []
            for _ in range(max_new):
                t0 = time.perf_counter()
                cur, caches = self._step(self.params, cur, caches, offs)
                row = cur[:, 0].tolist()             # device sync
                steps.append(time.perf_counter() - t0)
                for i, t in enumerate(row):
                    outs[i].append(int(t))
        self.last_timing = {"prefill_s": prefill_s, "decode_s": steps}
        return outs

    def teacher_forced_logits(self, prompts: List[np.ndarray],
                              tokens: List[List[int]]) -> torch.Tensor:
        """The logits of ``generate``'s decode steps with the emitted tokens
        forced to ``tokens``: (B, T, vocab), fp32.  Step j's logits are the
        ones whose argmax ``generate`` emits as token j."""
        forced = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        out = []
        with torch.inference_mode():
            caches, cur, offs = self._start(prompts)
            for j in range(forced.shape[1]):
                logits, caches = M.decode_step(self.cfg, self.params, cur, caches,
                                               backend=self.backend, pos_offset=offs)
                out.append(logits[:, -1].float())
                cur = forced[:, j:j + 1]
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    def throughput_probe(self, *, steps: int = 8) -> Dict[str, float]:
        with torch.inference_mode():
            caches = M.init_caches(self.cfg, self.batch, self.max_seq, device=self.device)
            cur = torch.zeros((self.batch, 1), dtype=torch.int64, device=self.device)
            offs = torch.zeros((self.batch,), dtype=torch.int64, device=self.device)
            cur, caches = self._step(self.params, cur, caches, offs)   # warm-up
            self._sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                cur, caches = self._step(self.params, cur, caches, offs)
            self._sync()
        dt = (time.perf_counter() - t0) / steps
        return {"s_per_token": dt, "tokens_per_s": self.batch / dt}
