"""Training step and loop, the port of ``repro.train.trainer``.

``make_train_step`` returns ``train_step(model, opt_state, batch, step) ->
(model, opt_state, metrics)``: the loss is ``models.model.loss_and_metrics``
(chunked cross-entropy, per-layer remat), the gradients come from
``torch.autograd.grad``, and ``optim.adamw.apply_updates`` updates the
model's parameters and the optimizer state in place.  The four modes split
the batch exactly as the reference does:

* plain: one forward and backward over the whole batch;
* ``grad_accum`` > 1: contiguous microbatches (``reshape(n, B/n, ...)``),
  gradients summed in fp32, the last microbatch's metrics;
* ``microbatches`` > 1: strided microbatches (``a[i::n]``), gradients summed;
* ACCO, ``grad_accum`` > 1 with ``accum_axis`` (a ``launch.mesh.Mesh`` or a
  ``ProcessGroup`` over the data-parallel ranks): strided microbatches;
  microbatch k's gradients are summed over the ranks by
  ``parallel.collectives.psum_tree_chunked`` at site
  ``acc.step{k}.rs_grads`` (chunk counts from the active plan) and divided
  by ``n · mesh.size``.  The reference unrolls the loop and leaves the
  overlap of k's reduce with k+1's compute to XLA's scheduler; eager code
  orders it by hand: k's chunked all-reduces are issued
  (``psum_tree_chunked_issue``) before microbatch k+1's forward and waited
  for (``psum_tree_wait``) only after its backward.

Tensor parallelism: ``sited_mesh`` runs the dense trunk's MLPs over the
explicit chunked collectives at ``tp.layer{i}.mlp.ag|rs``, whose backwards
issue the transposed collectives.  At more than one rank the model is
sharded in place first (``models.model.shard_``): each rank holds its
shards of attention's heads, the MLPs, the experts and the vocabulary as
parameters, AdamW's moments are the shards', and the global norm sums the
shards' squares over the model group.  The norms and the other whole
leaves are replicated, and their gradients come out equal on every rank
(the placement's ``copy_to`` sums each rank's share of them).

Data parallelism: ``data_axis`` (a ``Mesh`` or ``ProcessGroup`` over the
ranks that hold the other slices of the global batch) averages the
gradients, the loss and its metrics over that group after the backward:
the reduction that GSPMD inserts implicitly in the reference.  An ACCO
step reduces over its ``accum_axis`` instead, which is then that group.

FSDP placements: on a model placed over ``data`` (``models.model.shard_``
with a data mesh of more than one rank, which must be ``data_axis``), each
data-split weight is gathered for its use and its gradient comes back
reduce-scattered, the sum over the data ranks: it is only divided by the
data size.  The leaves that stay whole are summed over ``data_axis`` as
above.  In the microbatch modes each microbatch's backward reduce-scatters,
which sums as the accumulation does.  ACCO on such a model raises
``NotImplementedError``: the reference's GSPMD launcher does not combine
them either.  Each microbatch's activations run under
``constraints.microbatches(n)``, so the constraint checks (installed by the
launcher) expect this rank's share of one microbatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.optim import adamw, schedules
from repro_torch.parallel import collectives, constraints as CT
from repro_torch.train import metrics as MET


@dataclass
class TrainConfig:
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    schedule: str = "warmup_cosine"
    warmup: int = 100
    total_steps: int = 10_000
    remat: bool = True
    microbatches: int = 1      # >1: dual-batch interleave (strided split)
    grad_accum: int = 1        # sequential microbatches (contiguous split)
    accum_axis: Optional[Any] = None   # ACCO: with grad_accum > 1, reduce
                                       # microbatch k's grads over this data-
                                       # parallel Mesh (or ProcessGroup) at
                                       # site acc.step{k}.rs_grads while
                                       # k+1's compute runs
    backend: Optional[str] = None      # kernel backend override
    sited_mesh: Optional[Any] = None   # plan-aware explicit collectives in the
                                       # dense trunk (tp.layer{i}.mlp sites)
    data_axis: Optional[Any] = None    # data-parallel Mesh (or ProcessGroup):
                                       # gradient and loss mean over it


def _split(batch: Dict[str, torch.Tensor], n: int, strided: bool):
    rows = batch["tokens"].shape[0]
    if rows % n:
        raise ValueError(f"the batch of {rows} rows (this rank's) does not split into {n} "
                         "microbatches")
    if strided:
        return [{k: a[i::n] for k, a in batch.items()} for i in range(n)]
    return [{k: a.reshape((n, a.shape[0] // n) + a.shape[1:])[i] for k, a in batch.items()}
            for i in range(n)]


def _add(acc: Optional[Dict[str, torch.Tensor]], g: Dict[str, torch.Tensor], *, fp32: bool):
    """acc + g leaf by leaf (in place into acc), g cast to fp32 if ``fp32``."""
    if fp32:
        g = {k: v.float() for k, v in g.items()}
    if acc is None:
        return g
    for k, v in g.items():
        acc[k].add_(v)
    return acc


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(model, opt_state, batch, step) -> (model,
    opt_state, metrics); ``batch`` holds tensors on the model's device."""
    sched = getattr(schedules, tcfg.schedule)

    def value_and_grad(model, params, b, n=1):
        with CT.microbatches(n):
            loss, m = M.loss_and_metrics(cfg, model, b, remat=tcfg.remat,
                                         backend=tcfg.backend, mesh=tcfg.sited_mesh)
            grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in m.items()}, dict(zip(params, grads))

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        place = model.placement
        split = {k for k in params if place is not None and "data" in place.axes(k)}
        acco = tcfg.grad_accum > 1 and tcfg.accum_axis is not None
        if acco and place is not None and "data" in place.meshes:
            raise NotImplementedError(
                "ACCO (accum_axis) on a model placed over data: the reference's GSPMD "
                "launcher does not combine them either")
        if split and (tcfg.data_axis is None or collectives.axis_size(tcfg.data_axis)
                       != place.meshes["data"].size):
            raise ValueError("a model placed over data trains with data_axis= its data "
                             f"mesh (size {place.meshes['data'].size})")
        if acco:
            n = tcfg.grad_accum
            mesh = tcfg.accum_axis
            gsum, pending, tot_loss, metrics = None, None, 0.0, None
            for k, b in enumerate(_split(batch, n, strided=True)):
                l, metrics, g = value_and_grad(model, params, b, n)
                if pending is not None:          # k-1's reduce ran under k's compute
                    gsum = _add(gsum, collectives.psum_tree_wait(pending), fp32=True)
                pending = collectives.psum_tree_chunked_issue(
                    g, mesh, site=f"acc.step{k}.rs_grads")
                del g
                tot_loss = tot_loss + l
            gsum = _add(gsum, collectives.psum_tree_wait(pending), fp32=True)
            scale = n * collectives.axis_size(mesh)
            grads = {k: a / scale for k, a in gsum.items()}
            loss = tot_loss / n
        elif tcfg.grad_accum > 1:
            n = tcfg.grad_accum
            gsum, tot_loss, metrics = None, 0.0, None
            for b in _split(batch, n, strided=False):
                l, metrics, g = value_and_grad(model, params, b, n)
                gsum = _add(gsum, g, fp32=True)
                tot_loss = tot_loss + l
            grads = {k: a / n for k, a in gsum.items()}
            loss = tot_loss / n
        elif tcfg.microbatches > 1:
            n = tcfg.microbatches
            gsum, tot_loss, metrics = None, 0.0, None
            for b in _split(batch, n, strided=True):
                l, metrics, g = value_and_grad(model, params, b, n)
                gsum = _add(gsum, g, fp32=False)
                tot_loss = tot_loss + l
            grads = {k: a / n for k, a in gsum.items()}
            loss = tot_loss / n
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        if tcfg.data_axis is not None and not acco:
            # a data-split leaf's gradient arrived reduce-scattered (the sum
            # over the data ranks); the others are summed here
            d = collectives.axis_size(tcfg.data_axis)
            whole, mean = collectives.psum_tree(
                ({k: a for k, a in grads.items() if k not in split},
                 dict(metrics, loss=loss)), tcfg.data_axis)
            grads = {k: (a if k in split else whole[k]) / d for k, a in grads.items()}
            metrics = {k: a / d for k, a in mean.items()}
            loss = metrics.pop("loss")
        lr_scale = sched(step, warmup=tcfg.warmup, total=tcfg.total_steps)
        opt_metrics = adamw.apply_updates(params, grads, opt_state, tcfg.opt, lr_scale,
                                          placement=place)
        return model, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step


def train_loop(cfg, tcfg: TrainConfig, data_iter, *, steps: int, seed: int = 0,
               model=None, device="cuda", log_every: int = 10, callback=None
               ) -> Tuple[Any, Dict[str, list]]:
    """Single-process training driver (examples and tests).  Without a
    ``model`` it makes one from ``seed`` (a ``torch.Generator``; no global
    RNG state is read) on ``device``.  Returns the trained model and
    ``history`` with each step's ``loss``, ``step_time`` (host seconds,
    after the loss reached the host) and ``mfu`` (against the H100's bf16
    peak, ``train.metrics``).  The log line shows the routers'
    load-balancing loss ``aux`` beside the loss (0 without experts)."""
    if model is None:
        model = M.init_params(cfg, seed, device=device)
    dev = next(model.parameters()).device
    opt_state = adamw.init_state(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, tcfg)
    history: Dict[str, list] = {"loss": [], "step_time": [], "mfu": []}
    tracker = None
    t_prev = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data_iter).items()}
        model, opt_state, metrics = step_fn(model, opt_state, batch, step)
        loss = float(metrics["loss"])
        t_now = time.perf_counter()
        if tracker is None:
            tokens = int(batch["tokens"].shape[0] * batch["tokens"].shape[1])
            tracker = MET.Tracker(cfg, tokens)
        m = tracker.update(t_now - t_prev)
        history["loss"].append(loss)
        history["step_time"].append(t_now - t_prev)
        history["mfu"].append(m["mfu"])
        t_prev = t_now
        if callback:
            callback(step, metrics)
        if log_every and step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  aux {float(metrics['aux']):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}  "
                  f"tok/s {m['tokens_per_s']:.0f}")
    return model, history
