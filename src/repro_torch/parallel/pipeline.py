"""GPipe pipeline parallelism over a ``stage`` mesh axis (counterpart of
``repro.parallel.pipeline``).

Each rank of the stage group holds one stage; microbatches flow from stage
``s`` to stage ``s + 1`` by point-to-point transfers over the group
(``dist.batch_isend_irecv``).  Fill and drain: ``S + M − 1`` ticks for S
stages and M microbatches; at tick ``t`` stage ``s`` works on microbatch
``t − s`` when ``0 <= t − s < M``, and the last stage emits microbatch
``t − (S − 1)``.  The transfers are the "permute" CommOps the Lagom tuner
prices (``core.extract`` kind ``"pp"``, sites ``pp.tick{t}.p2p.{fwd|bwd}``):
a tuned ``p2p`` chunk count cuts each transfer into that many feature-dim
blocks, one ``batch_isend_irecv`` each, all issued before the first is
waited for.

Where the reference departs from this schedule only because one SPMD
program runs on every device, the port does not follow it: the reference
runs the stage function on zeros at each stage's idle ticks and sends the
last stage's output round to stage 0; neither reaches its outputs nor
carries a gradient.  The port computes only the ``M`` microbatches of its
stage (at S = M = 4, 3 idle ticks of each stage's 7 are skipped) and
sends only along ``s -> s + 1``.

The backward is an explicit reverse schedule (one ``torch.autograd.Function``
over the whole call), never autograd reaching across ranks: both sides of
a transfer must post it in the same order, which autograd's engine does
not promise across processes.  Walking the ticks from the last to the
first, each stage takes its output's cotangent for microbatch ``t − s``
(from stage ``s + 1``, or on the last stage from its own output), runs
``torch.autograd.grad`` through that microbatch's graph, and sends the
input's cotangent to stage ``s − 1`` with the forward's chunk count.
Three invariants hold, as in the reference's transpose:

1. the cotangent is taken once, on the last stage: every rank computes the
   same loss from the replicated outputs, and the other ranks' output
   cotangents are not used (summing them would give S times the gradient);
2. the input's gradient is stage 0's, broadcast to every rank (the
   reference's replicated ``x`` gets stage 0's cotangent, summed over the
   stage axis, where the other stages' are zero);
3. a rank's parameter gradients are its own stage's only.

``Issued`` rows (``parallel.collectives.record_issued``): rank ``s`` logs
one row ``(site, "ppermute", chunks, 0, chunks)`` for each forward tick at
which it sends (``s < S − 1`` and ``0 <= t − s < M``) or receives
(``s > 0`` and ``0 <= t − (s − 1) < M``), and one ``"ppermute.bwd"`` row
for each backward tick at which it does either: M rows a pass on the
first and the last stage, M + 1 on each stage between.  At S = 1 nothing
is issued and no row is logged.  The output's broadcast from the last
stage and the input gradient's from stage 0 (the reference's psum over
the stage axis) are not plan sites and log no row.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch.mesh import Mesh, as_mesh
from repro_torch.parallel.collectives import (_ISSUED_LOG, _issued, _peer, _tree_map,
                                              _wait, _warn_unchunked, runtime_for, span)


def _chunks(d: int, num_chunks: int, site: str) -> int:
    """The chunk count a transfer of trailing dim ``d`` uses: ``num_chunks``
    where it divides ``d``, else 1, with the degradation warning."""
    if num_chunks > 1 and d % num_chunks:
        _warn_unchunked(site, num_chunks, f"the trailing activation dim ({d})")
        return 1
    return max(1, num_chunks)


def _chunked_ppermute(x: Optional[torch.Tensor], mesh, *, direction: int = 1,
                      num_chunks: int, site: str, recv_like: Optional[torch.Tensor] = None,
                      op: str = "ppermute", log=None) -> Optional[torch.Tensor]:
    """Send ``x`` to stage ``rank + direction`` and receive, into a tensor
    shaped like ``recv_like``, what stage ``rank − direction`` sends (the
    reference's ``lax.ppermute`` along ``s -> s + direction``, without the
    wrap-around).  ``x = None`` sends nothing, ``recv_like = None`` receives
    nothing.  The trailing dim is cut into ``num_chunks`` blocks (each made
    contiguous: neither NCCL nor gloo sends a strided slice), one
    ``batch_isend_irecv`` a block, all issued before the first is waited
    for; where ``num_chunks`` does not divide it the tensor goes whole, with
    one warning naming ``site``.  Returns the received tensor (or None).
    Logs one ``Issued`` row where anything is sent or received."""
    m = as_mesh(mesh)
    ref = x if x is not None else recv_like
    if ref is None or m.size == 1:
        return None
    nc = _chunks(ref.shape[-1], num_chunks, site)
    send_to = _peer(m, m.rank + direction) if x is not None else None
    recv_from = _peer(m, m.rank - direction) if recv_like is not None else None
    sends = [] if x is None else [b.contiguous() for b in x.chunk(nc, dim=-1)]
    recvs = [] if recv_like is None else [
        recv_like.new_empty(recv_like.shape[:-1] + (recv_like.shape[-1] // nc,))
        for _ in range(nc)]
    works = []
    with span(op, site):
        for k in range(nc):
            ops = []
            if sends:
                ops.append(dist.P2POp(dist.isend, sends[k], send_to, m.group))
            if recvs:
                ops.append(dist.P2POp(dist.irecv, recvs[k], recv_from, m.group))
            works += dist.batch_isend_irecv(ops)
        for w in works:
            _wait(w)
        _issued(site, op, nc, 0, nc, log)
    if not recvs:
        return None
    return recvs[0] if nc == 1 else torch.cat(recvs, dim=-1)


# ---------------------------------------------------------------------------
# the stage's parameters
# ---------------------------------------------------------------------------

def _tensor_tree(tree) -> bool:
    """Whether ``tree`` is a dict / list / tuple nest of tensors only."""
    if torch.is_tensor(tree):
        return True
    if isinstance(tree, dict):
        return all(_tensor_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return len(tree) > 0 and all(_tensor_tree(v) for v in tree)
    return False


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``: its leaves, or a module's parameters."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _local_stage(stage_params, m: Mesh):
    """This rank's stage: row ``m.rank`` of the reference's stacked tree
    (every leaf's leading dim S), row 0 of a tree whose leading dims are 1
    (this rank's own, as shard_map hands it), or any other object as it is
    (a list of ``Layer``s, say)."""
    if not _tensor_tree(stage_params):
        return stage_params
    lead = {a.shape[0] if a.ndim else None for a in _leaves(stage_params)}
    if lead == {m.size}:
        row = m.rank
    elif lead == {1}:
        row = 0
    else:
        raise ValueError(f"stage_params: leading dims {sorted(lead, key=str)}, expected the "
                         f"{m.size} stages or 1 (this rank's stage)")
    return _tree_map(lambda a: a[row], stage_params)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _active(t: int, s: int, M: int) -> bool:
    """Whether stage ``s`` works at tick ``t`` (on microbatch ``t − s``)."""
    return 0 <= t - s < M


def transfer_ticks(stages: int, microbatches: int, stage: int) -> List[int]:
    """The forward ticks at which ``stage`` sends (its output, to the next
    stage) or receives (its next input): the ticks of its ``Issued`` rows,
    in order; the backward's rows are at the same ticks, in reverse."""
    S, M, s = stages, microbatches, stage
    return [t for t in range(S + M - 1)
            if (s < S - 1 and _active(t, s, M)) or (s > 0 and _active(t + 1, s, M))]


def _forward(fn, local, x_mb, m: Mesh, nc: int, site: str, log, keep: bool,
             x_grad: bool = False):
    """The fill-and-drain forward on this rank.  Returns (the last stage's
    outputs (M, mb, ...) or None, [(microbatch, input leaf, output)] kept
    for the backward when ``keep``; stage 0's inputs need a gradient where
    ``x_grad``, every other stage's do)."""
    S, s, M = m.size, m.rank, x_mb.shape[0]
    ys = x_mb.new_empty(x_mb.shape) if s == S - 1 else None
    kept, buf = [], None
    for t in range(S + M - 1):
        out = None
        if _active(t, s, M):
            inp = x_mb[t] if s == 0 else buf
            if keep:
                inp = inp.detach().requires_grad_(x_grad or s > 0)
                with torch.enable_grad():
                    out = fn(local, inp)
                kept.append((t - s, inp, out))
            else:
                out = fn(local, inp)
            if out.shape != inp.shape or out.dtype != inp.dtype:
                raise ValueError(f"the stage function maps {tuple(inp.shape)} {inp.dtype} "
                                 f"to {tuple(out.shape)} {out.dtype}: a pipeline stage "
                                 "keeps its input's shape and dtype")
            if s == S - 1:
                ys[t - s] = out.detach()
        send = out.detach() if out is not None and s < S - 1 else None
        recv = x_mb[0] if s > 0 and _active(t + 1, s, M) else None
        buf = _chunked_ppermute(send, m, direction=1, num_chunks=nc, site=site,
                                recv_like=recv, log=log)
    return ys, kept


def _replicate(t: Optional[torch.Tensor], like: torch.Tensor, m: Mesh, src: int):
    """``t`` on stage ``src``, broadcast to every stage."""
    if m.size == 1:
        return t
    out = t if m.rank == src else like.new_empty(like.shape)
    dist.broadcast(out, _peer(m, src), group=m.group)
    return out


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_mb, fn, local, m, nc, site, log, *params):
        ys, kept = _forward(fn, local, x_mb, m, nc, site, log, keep=True,
                            x_grad=ctx.needs_input_grad[0])
        ctx.fn_state = (kept, m, nc, site, log, params, x_mb)
        return _replicate(ys, x_mb, m, m.size - 1)

    @staticmethod
    def backward(ctx, gy):
        kept, m, nc, site, log, params, x_mb = ctx.fn_state
        del ctx.fn_state
        S, s, M = m.size, m.rank, x_mb.shape[0]
        need_x = s > 0 or ctx.needs_input_grad[0]
        want = [p for p in params if p.requires_grad]
        # the microbatches' parameter gradients accumulate in .grad (in place:
        # one copy of them), the caller's .grad set aside meanwhile
        stash = [p.grad for p in want]
        for p in want:
            p.grad = None
        dx = x_mb.new_zeros(x_mb.shape) if s == 0 and need_x else None
        by_mb = {i: (inp, out) for i, inp, out in kept}
        del kept
        buf = None
        try:
            for t in range(S + M - 2, -1, -1):
                send = None
                if _active(t, s, M):
                    i = t - s
                    inp, out = by_mb.pop(i)
                    g = gy[i] if s == S - 1 else buf       # invariant 1: the last stage's own
                    if out.requires_grad:
                        torch.autograd.backward(out, g, inputs=([inp] if need_x else []) + want)
                    if need_x:
                        gin = inp.grad if inp.grad is not None else torch.zeros_like(inp)
                        if s > 0:
                            send = gin
                        else:
                            dx[i] = gin
                    del inp, out, g
                recv = x_mb[0] if s < S - 1 and _active(t - 1, s, M) else None
                buf = _chunked_ppermute(send, m, direction=-1, num_chunks=nc, site=site,
                                        recv_like=recv, op="ppermute.bwd", log=log)
            grads = iter([p.grad for p in want])
        finally:
            for p, g in zip(want, stash):
                p.grad = g
        dx_all = None
        if ctx.needs_input_grad[0]:
            dx_all = _replicate(dx, x_mb, m, 0)          # invariant 2
        out = [next(grads) if p.requires_grad else None for p in params]
        return (dx_all, None, None, None, None, None, None, *out)


def pipeline_apply(fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                   axis: str = "stage", microbatches: int,
                   site: Optional[str] = None) -> torch.Tensor:
    """Run ``fn(stage_params_i, x)`` through an S-stage pipeline over the
    mesh's ``axis`` (a ``Mesh``, or ``{axis: Mesh}`` as
    ``launch.mesh.make_mesh`` returns).

    ``stage_params``: the reference's tree with a leading stage dim of S
    (this rank takes row ``mesh.rank``), or this rank's own stage (a
    leading dim of 1, or any object ``fn`` takes, such as a list of
    ``Layer``s).  ``x``: the (M·mb, ...) global batch, the same on every
    rank, cut into M microbatches; ``fn`` keeps a microbatch's shape and
    dtype.  Returns the (M·mb, ...) outputs on every rank, equal to the
    stages applied in sequence.  ``site`` addresses the transfers in the
    active plan (default the ``p2p`` site class), read once per call: a
    tuned chunk count cuts each transfer into feature-dim blocks.

    With grad enabled and ``x`` or a parameter needing a gradient, the
    call is one ``autograd.Function`` whose backward walks the ticks in
    reverse (module docstring); on CUDA tensors ``fn`` runs on the card
    and the transfers over the stage group, and a failed transfer raises."""
    m = as_mesh(mesh[axis] if isinstance(mesh, dict) else mesh)
    M, B = microbatches, x.shape[0]
    if M < 1 or B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    site = site or "p2p"
    nc = _chunks(x.shape[-1], runtime_for(site, "p2p").num_chunks, site)
    x_mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    local = _local_stage(stage_params, m)
    params = _leaves(stage_params)
    log = _ISSUED_LOG.get()
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        y = _Pipeline.apply(x_mb, fn, local, m, nc, site, log, *params)
    else:
        ys, _ = _forward(fn, local, x_mb, m, nc, site, log, keep=False)
        y = _replicate(ys, x_mb, m, m.size - 1)
    return y.reshape(x.shape)
