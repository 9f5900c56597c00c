"""Fixed-batch serving engine of the port (PyTorch counterpart of
``repro.serving.engine``): prefill right-padded prompts into the caches in
one pass, then decode greedily in lockstep, each row at its true position
(a (B,) ``pos``, as the continuous engine's slots: the reference's shared
padded counter would cut a windowed row's window short by its pad gap).

On the card the prefill and every decode step run the port's CUDA kernels
(``kernels.ops`` counts the launches): RMSNorm (``qk_norm``'s and MLA's
latent norm included) and, at prefill, flash attention for the dense,
moe, vlm and hybrid families, the SSD scan for zamba2's Mamba2 layers and
the WKV6 scan for rwkv6; whisper (``audio``) runs flash in its encoder
and cross-attention, prefill and decode alike.  An audio model's
``generate`` takes each row's ``frames`` (B, encoder_seq, D), which go
into the prefill batch with the prompts; the encoder's memory then stays
in the caches for decode.  (The reference's engine puts the frames into
the caches' memory and prefills without them, which fails: ROADMAP.md,
queue 3.)  The recurrent families
(``ssm``, ``hybrid``) need equal-length prompts, as in the reference: a
recurrent state would absorb the right padding, so ragged prompts raise
``ValueError`` (the reference asserts).

Plan-aware serving: pass ``plan=`` (a ``TunedPlan``, its JSON path or a
runtime dict) or ``repo=`` (a ``PlanRepository``) and a dense or MoE
model decodes under that plan's per-site knobs at the
``serve.layer{i}.mlp.*`` and ``serve.layer{i}.moe.*`` SiteIds, through the
sited trunk over ``mesh`` (by default
``launch.mesh.make_mesh()``: the initialised process group, or a size-1
mesh that issues no collective).  Each plan's prefill and decode step are
kept per plan digest and run under that plan's scope, so a ``set_plan``
hot-swap between batches takes effect and the ambient plan is restored on
every exit path.

Fault-aware serving: ``fault_schedule=`` arms per-site drift detection
(``serving.health``); each decoded token advances the batch clock, and a
site whose observed cost drifts past ``health_tolerance`` for
``health_window`` consecutive batches is re-tuned online (``retune=``) or
demoted mid-generate to its fallback knobs by a transactional plan swap.
``health_events`` / ``health_report()`` expose the structured log.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import dense, model as M
from repro_torch.serving.plans import DEFAULT_BAND, PlanBinding
from repro_torch.serving.types import Request

__all__ = ["Engine", "Request", "make_serve_step"]

RECURRENT = ("ssm", "hybrid")      # families whose caches carry recurrent states


def _make_retune(binding, retune):
    """Lower the engines' ``retune=`` kwarg to a ``core.retune``
    ``RetuneService``: ``None``/``False`` off, ``True`` defaults, a dict
    of service kwargs, or an already-built service."""
    if not retune:
        return None
    from repro_torch.core.retune import RetuneService

    if isinstance(retune, RetuneService):
        return retune
    opts = {} if retune is True else dict(retune)
    return RetuneService(binding, **opts)


def make_serve_step(cfg, *, backend: Optional[str] = None, mesh=None, shards=None,
                    route_rows: bool = False):
    """serve_step(params, tokens (B,1), caches) -> (next (B,1), caches).
    ``mesh`` opts the dense and moe families into the sited decode path
    (``serve.layer{i}.*``), with ``shards`` this rank's feed-forward shards
    (``models.dense.shard_trunk``); ``route_rows`` routes each row alone
    through the experts."""
    def serve_step(params, tokens, caches):
        logits, caches = M.decode_step(cfg, params, tokens, caches, backend=backend,
                                       mesh=mesh, shards=shards, route_rows=route_rows)
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


def _with_pos(tree, pos):
    """The cache tree with every ``pos`` entry set to ``pos``."""
    return {name: (_with_pos(a, pos) if isinstance(a, dict) else
                   pos if name == "pos" else a)
            for name, a in tree.items()}


def check_equal_lengths(cfg, lens) -> None:
    """The recurrent families need equal-length prompts in one prefill."""
    if cfg.family in RECURRENT and len(set(lens)) > 1:
        raise ValueError(f"{cfg.family} serving needs equal-length prompts "
                         f"(a recurrent state absorbs right padding); got lengths "
                         f"{sorted(set(lens))}")


class PlannedEngine:
    """The plan surface both engines share: the ``PlanBinding``, the fault
    and re-tune lifecycle, the mesh and this rank's feed-forward shards,
    and the per-plan steps keyed on the plan digest.  ``route_rows``: the
    experts route each row alone (the continuous engine's slots)."""

    route_rows = False

    def _bind_plan(self, cfg, params, *, max_seq: int, backend, plan, repo,
                   plan_hardware, plan_parallel, plan_band, mesh, fault_schedule,
                   health_window, health_tolerance, retune, plan_lint) -> None:
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.backend = backend
        self.device = next(params.parameters()).device
        self._binding = PlanBinding(cfg, plan=plan, repo=repo, hardware=plan_hardware,
                                    parallel=plan_parallel, band=plan_band,
                                    max_seq=max_seq, lint=plan_lint)
        if fault_schedule is not None:
            self._binding.attach_faults(fault_schedule, tolerance=health_tolerance,
                                        window=health_window)
        self.retune_service = _make_retune(self._binding, retune)
        if mesh is None and self._binding.bound and cfg.family in ("dense", "moe", "vlm"):
            mesh = make_mesh()
        self.mesh = mesh
        # this rank's feed-forward shards, made once (at mesh size 1: the
        # weights themselves)
        self._shards = (dense.shard_trunk(params.trunk, mesh)
                        if mesh is not None and cfg.family in M.DECODER else None)
        self._fns: Dict[tuple, Tuple[Callable, Callable]] = {}   # plan digest -> steps

    # ------------------------------------------------------------------
    def set_plan(self, plan) -> None:
        """Hot-swap the tuned plan between batches (TunedPlan, path to its
        JSON, runtime dict, or None to unpin)."""
        self._binding.set_plan(plan)

    @property
    def plan_stats(self) -> Dict[str, int]:
        return dict(self._binding.stats)

    @property
    def health_events(self) -> List[Dict]:
        """Structured degradation log: drift detections, demotions (with
        rollback status), re-tunes and band-widening events, in order."""
        return list(self._binding.events)

    def health_report(self) -> str:
        return self._binding.health_report()

    @property
    def telemetry(self):
        """The binding's live ``SiteTelemetry`` ring buffer (one row of
        observed per-site costs per served batch)."""
        return self._binding.telemetry

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _compiled(self, rt) -> Tuple[Callable, Callable]:
        """The (step, prefill) pair of plan ``rt``, kept per plan digest.
        Each runs under ``rt``'s scope, where the sited trunk's sites
        resolve their knobs."""
        key = self._binding.digest(rt)
        if key not in self._fns:
            scope = self._binding.scope
            serve_step = make_serve_step(self.cfg, backend=self.backend, mesh=self.mesh,
                                         shards=self._shards, route_rows=self.route_rows)

            def step(tokens, caches):
                with scope(rt):
                    return serve_step(self.params, tokens, caches)

            def prefill(batch, caches):
                with scope(rt):
                    return M.forward_hidden(self.cfg, self.params, batch, caches,
                                            backend=self.backend, mesh=self.mesh,
                                            shards=self._shards,
                                            route_rows=self.route_rows)[1]

            self._fns[key] = (step, prefill)
        return self._fns[key]

    def _after_step(self, dt: float) -> bool:
        """Advance the health clock by one served batch; on drift, re-tune
        online first and demote when the service declines (the swap
        prepares the new plan's steps before it commits).  True when the
        plan changed."""
        drifted = self._binding.health_tick(dt)
        if not drifted:
            return False
        retuned = (self.retune_service.handle(drifted)
                   if self.retune_service is not None else None)
        if retuned is None:
            self._binding.demote(drifted, apply=self._compiled)
        return True


class Engine(PlannedEngine):
    """Fixed-batch decode engine."""

    def __init__(self, cfg, params, *, batch_size: int, max_seq: int,
                 backend: Optional[str] = None, plan=None, repo=None,
                 plan_hardware: str = "h100-sxm", plan_parallel=None,
                 plan_band: float = DEFAULT_BAND, mesh=None,
                 fault_schedule=None, health_window: int = 3,
                 health_tolerance: float = 0.25, retune=None,
                 plan_lint: str = "error"):
        self.batch = batch_size
        self._bind_plan(cfg, params, max_seq=max_seq, backend=backend, plan=plan,
                        repo=repo, plan_hardware=plan_hardware,
                        plan_parallel=plan_parallel, plan_band=plan_band, mesh=mesh,
                        fault_schedule=fault_schedule, health_window=health_window,
                        health_tolerance=health_tolerance, retune=retune,
                        plan_lint=plan_lint)
        # wall times of the last generate(): prefill, and each decode step
        self.last_timing: Dict[str, object] = {}

    def _start(self, prompts: List[np.ndarray], prefill, frames=None):
        """Right-pad and prefill the prompts (with an audio model's
        ``frames``); returns (caches, first decode input (B,1)).  Each row
        decodes from its true last token at its true position: ``pos``
        becomes the (B,) prompt lengths, so RoPE, the window, ALiBi's
        distances, learned positions and a ring's slots are each row's own
        (the right-pad slots are marked dead and overwritten as it goes)."""
        if len(prompts) != self.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of {self.batch}")
        if (frames is None) != (self.cfg.family != "audio"):
            raise ValueError("an audio model is served with its frames (B, encoder_seq, D), "
                             "and only an audio model")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, plen), np.int64)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        check_equal_lengths(self.cfg, lens.tolist())
        for i, p in enumerate(prompts):    # right-pad; causal mask + per-row
            toks[i, :len(p)] = p           # slot_pos invalidation keep pads out
        caches = M.init_caches(self.cfg, self.batch, self.max_seq, device=self.device)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        if frames is not None:
            batch["frames"] = torch.as_tensor(np.asarray(frames), device=self.device)
        caches = prefill(batch, caches)
        if self.cfg.family not in RECURRENT:    # equal lengths: no pad slot to mark
            rows = torch.as_tensor(lens, device=self.device)
            caches = _with_pos(_invalidate_pad_slots(caches, rows), rows)
        cur = torch.as_tensor(toks[np.arange(self.batch), lens - 1][:, None],
                              device=self.device)
        return caches, cur

    # ------------------------------------------------------------------
    def generate(self, prompts: List[np.ndarray], *, max_new: int = 32,
                 frames=None) -> List[List[int]]:
        """Greedy tokens, ``max_new`` a row; ``frames`` (B, encoder_seq, D)
        for an audio model, else None."""
        rt = self._binding.resolve(self.batch)
        step, prefill = self._compiled(rt)
        with torch.inference_mode():
            t0 = time.perf_counter()
            caches, cur = self._start(prompts, prefill, frames)
            self._sync()
            prefill_s = time.perf_counter() - t0
            outs: List[List[int]] = [[] for _ in range(self.batch)]
            steps = []
            for _ in range(max_new):
                t0 = time.perf_counter()
                cur, caches = step(cur, caches)
                row = cur[:, 0].tolist()             # device sync
                dt = time.perf_counter() - t0
                steps.append(dt)
                for i, t in enumerate(row):
                    outs[i].append(int(t))
                if self._after_step(dt):
                    step, _ = self._compiled(self._binding.current)
        self.last_timing = {"prefill_s": prefill_s, "decode_s": steps}
        return outs

    def teacher_forced_logits(self, prompts: List[np.ndarray], tokens: List[List[int]],
                              *, frames=None) -> torch.Tensor:
        """The logits of ``generate``'s decode steps with the emitted tokens
        forced to ``tokens``: (B, T, vocab), fp32, under the engine's
        current plan.  Step j's logits are the ones whose argmax
        ``generate`` emits as token j."""
        forced = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        rt = self._binding.current
        _, prefill = self._compiled(rt)
        out = []
        with torch.inference_mode():
            caches, cur = self._start(prompts, prefill, frames)
            with self._binding.scope(rt):
                for j in range(forced.shape[1]):
                    logits, caches = M.decode_step(self.cfg, self.params, cur, caches,
                                                   backend=self.backend, mesh=self.mesh,
                                                   shards=self._shards)
                    out.append(logits[:, -1].float())
                    cur = forced[:, j:j + 1]
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    def throughput_probe(self, *, steps: int = 8) -> Dict[str, float]:
        rt = self._binding.resolve(self.batch)
        step, _ = self._compiled(rt)
        with torch.inference_mode():
            caches = M.init_caches(self.cfg, self.batch, self.max_seq, device=self.device)
            cur = torch.zeros((self.batch, 1), dtype=torch.int64, device=self.device)
            cur, caches = step(cur, caches)   # warm-up
            self._sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                cur, caches = step(cur, caches)
            self._sync()
        dt = (time.perf_counter() - t0) / steps
        return {"s_per_token": dt, "tokens_per_s": self.batch / dt}
