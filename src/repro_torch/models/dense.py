"""Dense decoder trunk of the port (PyTorch counterpart of
``repro.models.dense``).

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; eager PyTorch has nothing to trace, so the port keeps one
``Layer`` module per layer in an ``nn.ModuleList`` and loops over it.  The
KV caches keep the reference's stacked layout (a leading layer axis), and
each layer reads and writes its slice in place.

Plan-aware (sited) path: ``trunk_fwd(mesh=...)`` runs every layer's MLP
over the explicit chunked collectives of ``parallel.collectives``
(``ring_ag_matmul`` for gate and up, ``mm_reduce_scatter`` for down), each
addressed by its SiteId: ``tp.layer{i}.mlp.ag|rs`` without a cache,
``serve.layer{i}.mlp.ag|rs`` with one (global layer indices, as
``core.extract.extract_decode_workload`` names them).  Each site resolves
its knobs against the active plan when it runs, so one plan can drive two
layers to different chunk structure.  Attention stays replicated on every
rank; each rank holds a column shard of ``gate``/``up`` and a row shard of
``down`` (``shard_trunk``), and the sequence-sharded MLP output is gathered
back explicitly (``collectives.all_gather_rows``) where GSPMD gathers it
implicitly in the reference.

Training: ``trunk_fwd(remat=True)`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), so the backward recomputes a
layer from its input, as the reference's ``jax.checkpoint`` per layer does;
on the sited path the recompute issues the layer's forward collectives
again, on every rank in the same order (backward layer order).  Every
collective helper has a backward (``parallel.collectives``), so the sited
trunk trains at any mesh size.  For training, ``models.model.shard_``
places the model in place: each layer's MLP weights become this rank's
shards over ``model`` (under the same state-dict names), which the sited
trunk runs (``Trunk.mlp_mesh``); serving keeps the whole MLPs and hands
``trunk_fwd`` copies (``shard_trunk``).  On a model placed over ``data``
(FSDP) each layer's weights are this rank's slices and ``trunk_fwd``'s
``gather`` gathers them inside the layer's checkpoint.

Not ported here, and raising ``NotImplementedError`` naming the slice that
brings them: MoE feed-forwards, MLA, sliding windows, ALiBi, ``qk_norm``
and ``parallel_block``.
"""
from __future__ import annotations

import contextvars
import warnings
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import as_mesh
from repro_torch.models import layers as L
from repro_torch.parallel import constraints as CT
from repro_torch.parallel.collectives import (all_gather_rows, mm_reduce_scatter,
                                              ring_ag_matmul, shard_rows)

Caches = Dict[str, Dict[str, object]]

MOE_SLICE = "the port's pipeline-and-MoE slice (ROADMAP.md, queue 1)"


def check_supported(cfg) -> None:
    """Raise for the parts of the dense/moe/vlm trunk that are not ported yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} arrives with a later slice of the port "
            "(ROADMAP.md, queue 1)")
    if cfg.is_moe:
        raise NotImplementedError(f"MoE feed-forwards arrive with {MOE_SLICE}")
    if cfg.parallel_block:
        raise NotImplementedError(f"parallel_block arrives with {L.OTHER_FAMILIES}")
    L.check_attention_supported(cfg)


class Layer(nn.Module):
    """One pre-norm decoder layer: ln1 -> attention, ln2 -> SwiGLU MLP."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(cfg.d_model, cfg.norm_kind, **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg.d_model, cfg.norm_kind, **kw)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)


# ---------------------------------------------------------------------------
# the plan-aware MLP
# ---------------------------------------------------------------------------

def tp_mlp(p: L.MLP, x: torch.Tensor, kind: str, mesh, *,
           site: str = "tp.mlp") -> torch.Tensor:
    """Explicit tensor-parallel MLP over ``mesh``: ``p`` holds this rank's
    shards (``shard_mlp``), ``x`` (B, S, D) is replicated.  It enters
    through this rank's sequence shard of ``x`` (``shard_rows``); the up
    projections are ring AllGather∘matmul over it (site ``{site}.ag``), the
    down projection matmul∘ReduceScatter (site ``{site}.rs``), each site's
    chunk structure resolved against the active plan; the sequence-sharded
    output leaves gathered back to (B, S, D) (``all_gather_rows``).
    Numerically ``layers.mlp``, and differentiable."""
    if kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {kind!r} arrives with {L.OTHER_FAMILIES}")
    m = as_mesh(mesh)
    xl = shard_rows(x, m)
    h = (F.silu(ring_ag_matmul(xl, p.gate.weight.T, m, site=f"{site}.ag"))
         * ring_ag_matmul(xl, p.up.weight.T, m, site=f"{site}.ag"))
    y = mm_reduce_scatter(h, p.down.weight.T, m, site=f"{site}.rs")
    return all_gather_rows(y, m)


def serve_mlp(p: L.MLP, x: torch.Tensor, kind: str, mesh, *,
              site: str = "serve.mlp") -> torch.Tensor:
    """Decode-shape plan-aware MLP.  ``tp_mlp`` chunks the sequence axis,
    which is length 1 at decode, so the in-flight batch is re-laid as that
    axis, (B, S, D) -> (1, B·S, D): the plan's chunk counts then decompose
    the collectives over the sequences in flight.  Position-wise MLP, so
    this is numerically the identity transform."""
    B, S, D = x.shape
    y = tp_mlp(p, x.reshape(1, B * S, D), kind, mesh, site=site)
    return y.reshape(B, S, D)


def shard_mlp(p: L.MLP, mesh) -> L.MLP:
    """This rank's MLP shard: contiguous column shards of ``gate`` and
    ``up`` and a row shard of ``down`` (in ``nn.Linear`` layout, rows of
    ``gate``/``up`` and columns of ``down``).  At mesh size 1 the shard is
    ``p`` itself: no copy."""
    m = as_mesh(mesh)
    if m.size == 1:
        return p
    d_ff, d_model = p.gate.weight.shape
    f = d_ff // m.size
    cols = slice(m.rank * f, (m.rank + 1) * f)
    w = p.gate.weight
    shard = L.MLP(d_model, f, "swiglu", device=w.device, dtype=w.dtype)
    with torch.no_grad():
        shard.gate.weight.copy_(p.gate.weight[cols])
        shard.up.weight.copy_(p.up.weight[cols])
        shard.down.weight.copy_(p.down.weight[:, cols])
    return shard


def shard_trunk(p: "Trunk", mesh) -> List[L.MLP]:
    """Every layer's ``shard_mlp``: what an engine makes once, at
    construction, and hands to ``trunk_fwd(shards=...)``."""
    return [shard_mlp(lp.mlp, mesh) for lp in p.dense_layers]


def layer_fwd(p: Layer, cfg, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, object]], *, backend: Optional[str] = None,
              mesh=None, site: str = "", serve: bool = False,
              mlp: Optional[L.MLP] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, object]]]:
    """One decoder layer.  Returns (x, updated cache or None).  ``mesh``
    switches the MLP onto the explicit plan-aware collectives, with ``mlp``
    this rank's shard (default ``p.mlp``, the whole MLP), ``site`` the
    layer's SiteId prefix and ``serve`` marking the decode-shape layout."""
    x = CT.btd(x)
    h = L.norm(p.ln1, x, cfg.norm_kind, backend=backend)
    attn_out, new_cache = L.attention(p.attn, cfg, h, positions, cache=cache,
                                      backend=backend)
    x = x + attn_out
    h2 = L.norm(p.ln2, x, cfg.norm_kind, backend=backend)
    if mesh is None:
        return x + L.mlp(p.mlp, h2, cfg.mlp_kind), new_cache
    mlp = p.mlp if mlp is None else mlp
    if serve:
        ff = serve_mlp(mlp, h2, cfg.mlp_kind, mesh, site=site or "serve.mlp")
    else:
        ff = tp_mlp(mlp, h2, cfg.mlp_kind, mesh, site=site or "tp.mlp")
    return x + ff, new_cache


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

class Trunk(nn.Module):
    """``dense_layers``: the per-layer stack (state-dict keys
    ``dense_layers.{i}.*``, the reference's ``dense_layers`` unstacked)."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        self.dense_layers = nn.ModuleList(
            Layer(cfg, device=device, dtype=dtype) for _ in range(cfg.num_layers))
        self.mlp_mesh = None     # the mesh of the MLP shards, once placed (model.shard_)


def init_trunk(cfg, *, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, device=device, dtype=dtype)


def _sited_applicable(cfg, x, mesh) -> Tuple[bool, str]:
    """Shape preconditions of the explicit collective helpers (the sequence
    and ``d_ff`` must split over the mesh; otherwise the unsited loop)."""
    n = as_mesh(mesh).size
    if x.shape[1] % n:
        return False, f"sequence length {x.shape[1]} not divisible by {n}"
    if cfg.d_ff and cfg.d_ff % n:
        return False, f"d_ff {cfg.d_ff} not divisible by {n}"
    return True, ""


def _sited_applicable_serve(cfg, x, mesh) -> Tuple[bool, str]:
    """Decode-shape variant: ``serve_mlp`` re-lays (B, S, D) as
    (1, B·S, D), so the divisible axis is the whole in-flight token count,
    not the per-sequence length."""
    n = as_mesh(mesh).size
    if (x.shape[0] * x.shape[1]) % n:
        return False, (f"in-flight tokens {x.shape[0] * x.shape[1]} not "
                       f"divisible by {n}")
    if cfg.d_ff and cfg.d_ff % n:
        return False, f"d_ff {cfg.d_ff} not divisible by {n}"
    return True, ""


def trunk_fwd(p: Trunk, cfg, x: torch.Tensor, positions: torch.Tensor,
              caches: Optional[Caches] = None, *, backend: Optional[str] = None,
              mesh=None, shards: Optional[List[L.MLP]] = None, remat: bool = False,
              gather=None) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """caches: None | {"dense_layers": stacked cache}.  Returns (x, caches,
    aux); aux is the MoE load-balancing loss, zero for the dense trunk.

    ``mesh`` opts into the plan-aware sited path (module docstring): layer
    ``i``'s MLP runs at ``tp.layer{i}.mlp`` without caches and at
    ``serve.layer{i}.mlp`` with them.  A trunk sharded in place
    (``models.model.shard_``) runs its own MLPs, the shards, and needs its mesh;
    otherwise ``shards`` are this rank's MLP shards (default
    ``shard_trunk(p, mesh)``, copies made anew for the call, which carry no
    gradient to ``p``; engines make them once).  Shapes the explicit helpers
    cannot split fall back to the unsited loop with a ``RuntimeWarning``,
    as the reference falls back to its scan (a sharded trunk raises).
    ``remat`` (without caches) recomputes each layer in the backward.

    ``gather(i, lp)`` (a placed model's, ``models.model``) gives layer
    ``i`` as it runs, its data-split weights gathered whole; it is called
    inside the layer's checkpoint, so remat's recompute gathers them again
    and no gathered layer outlives its use."""
    seg = caches["dense_layers"] if caches is not None else None
    kind = "tp" if caches is None else "serve"
    if p.mlp_mesh is not None and (mesh is None or as_mesh(mesh) != p.mlp_mesh
                                   or shards is not None):
        raise ValueError(f"the trunk's MLPs are this rank's shards over {p.mlp_mesh}: "
                         "run it on that mesh, without other shards")
    if mesh is not None:
        check = _sited_applicable if caches is None else _sited_applicable_serve
        ok, why = check(cfg, x, mesh)
        if not ok and p.mlp_mesh is not None:
            raise ValueError(f"sharded trunk: {why}")
        if not ok:
            warnings.warn(f"plan-aware trunk disabled: {why}; using the "
                          "unsited layer loop", RuntimeWarning, stacklevel=2)
            mesh = None
        elif shards is None and p.mlp_mesh is None:
            if as_mesh(mesh).size > 1 and torch.is_grad_enabled() and any(
                    q.requires_grad for q in p.dense_layers[0].mlp.parameters()):
                raise ValueError(
                    f"training at mesh size {as_mesh(mesh).size} needs the MLP shards "
                    "as parameters: shard the trunk in place first (models.model.shard_)")
            shards = shard_trunk(p, mesh)
    for i, lp in enumerate(p.dense_layers):
        lc = None
        if seg is not None:
            lc = {"k": seg["k"][i], "v": seg["v"][i], "slot_pos": seg["slot_pos"][i],
                  "pos": seg["pos"]}

        def fl(x, lp=lp, lc=lc, i=i):
            lq = lp if gather is None else gather(i, lp)
            mlp = None
            if mesh is not None:
                mlp = lq.mlp if p.mlp_mesh is not None else shards[i]
            return layer_fwd(lq, cfg, x, positions, lc, backend=backend, mesh=mesh,
                             site=f"{kind}.layer{i}.mlp", serve=seg is not None,
                             mlp=mlp)[0]

        if remat and seg is None:
            # the backward may recompute the layer on autograd's device
            # thread: run it in this context (the plan scopes and issued-
            # collective logs are context variables) both times
            x = checkpoint(contextvars.copy_context().run, fl, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fl(x)
    new_caches = None
    if seg is not None:
        new_caches = {"dense_layers": dict(seg, pos=seg["pos"] + x.shape[1])}
    return x, new_caches, torch.zeros((), dtype=torch.float32, device=x.device)


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    """Stacked decode caches: k, v (L,B,W,Hkv,h), slot_pos (L,B,W), and one
    ``pos`` for all layers (the reference stacks a per-layer copy): a
    Python int, or a (B,) tensor of per-row positions (the continuous
    engine's slots)."""
    check_supported(cfg)
    n = cfg.num_layers
    one = L.init_kv_cache(cfg, batch, seq_len, dtype=dtype, device=device)
    stacked = {name: a.expand(n, *a.shape).clone() if torch.is_tensor(a) else a
               for name, a in one.items()}
    return {"dense_layers": stacked}
