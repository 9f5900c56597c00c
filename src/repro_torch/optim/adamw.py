"""AdamW with global-norm clipping, the port of ``repro.optim.adamw``.

The state is ``{"mu": {name: fp32 tensor}, "nu": {...}, "count": int64
tensor}``, keyed by the model's state-dict names (the reference mirrors
its parameter tree).  Moments are fp32 whatever the parameter's dtype.
Where the reference returns new arrays, the port updates the parameters
and the state in place under ``torch.no_grad()``: at llama3-8b's width a
second copy of parameters and moments would not fit the card.

On a placed model (``models.model.shard_``) a leaf is this rank's slice
of a tensor split over none, one or both of the ``data`` and ``model``
axes (``parallel.sharding.Placement``): the global norm sums each leaf's
squares over the groups of exactly the axes that split it and counts a
leaf no axis splits once, so every rank clips by the same factor, to the
bit, and the replicated parameters stay equal across ranks.  The moments
of a slice are the slice's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch

from repro_torch.parallel import collectives


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Zero moments for ``params`` (name -> tensor, e.g.
    ``dict(model.named_parameters())``), on the parameters' devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(iter(params.values()))
    return {"mu": {n: zeros(p) for n, p in params.items()},
            "nu": {n: zeros(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int64, device=first.device)}


def global_norm(tree: Mapping[str, torch.Tensor], *, placement=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x²), in fp32 (each leaf's norm
    without an fp32 copy of the leaf).  With ``placement``, a leaf split
    over some axes is this rank's slice: the squares of the leaves split
    over the same axes are summed, then over each of those axes' groups;
    the groups' sums are added in one order on every rank."""
    def sq(x):
        return torch.linalg.vector_norm(x, dtype=torch.float32).square()

    groups: Dict[tuple, list] = {}
    for k, x in tree.items():
        groups.setdefault(placement.axes(k) if placement is not None else (), []).append(sq(x))
    total = None
    for axes in sorted(groups, key=lambda a: (len(a), a)):
        part = torch.sum(torch.stack(groups[axes]))
        for axis in axes:
            part = collectives.psum_tree(part, placement.meshes[axis])
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                  state: Dict[str, object], cfg: AdamWConfig, lr_scale=1.0, *,
                  placement=None) -> Dict[str, torch.Tensor]:
    """One AdamW step: ``params``, ``state["mu"]``, ``state["nu"]`` and
    ``state["count"]`` are updated in place.  Gradients are clipped by the
    pre-clip global norm (``global_norm``, over ``placement``'s groups),
    which is returned as ``grad_norm`` with the step's ``lr`` (the
    reference's metrics)."""
    gnorm = global_norm(grads, placement=placement)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"]
    count += 1
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * (lr_scale.to(gnorm.device) if torch.is_tensor(lr_scale) else lr_scale)
    mu, nu = state["mu"], state["nu"]
    for name, p in params.items():
        # (m / c1) / (sqrt(v / c2) + eps), then p - lr·(step + wd·p): the
        # reference's operations in its order, each into a buffer of the
        # step, so no more than two leaf-sized temporaries live at once (an
        # fp32 leaf of 1.25 B weights, qwen2-vl-72b's embedding, is 5 GB)
        g = grads[name].float() * scale
        m, v = mu[name], nu[name]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        den = torch.div(v, c2).sqrt_().add_(cfg.eps)
        step = torch.div(m, c1).div_(den)
        del den
        pf = p.float()                   # p itself where p is fp32
        step.add_(torch.mul(pf, cfg.weight_decay)).mul_(lr)
        pf.sub_(step)
        if pf is not p:
            p.copy_(pf)
    return {"grad_norm": gnorm, "lr": torch.as_tensor(lr, dtype=torch.float32)}
