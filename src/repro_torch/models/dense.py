"""Decoder trunk of the port (PyTorch counterpart of
``repro.models.dense``): dense GQA attention (full or sliding-window, RoPE,
M-RoPE or ALiBi) or MLA, and a SwiGLU, GELU or MoE feed-forward, in
sequence or, with ``parallel_block`` (phi-2), both reading the one norm;
for the dense, moe and vlm families.

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; eager PyTorch has nothing to trace, so the port keeps one
``Layer`` module per layer in an ``nn.ModuleList`` for each of the
reference's two segments, ``dense_layers`` (every layer of a dense model,
the leading ``first_dense_layers`` of a MoE model) and ``moe_layers``,
and loops over them.  The KV caches keep the reference's stacked layout
(a leading layer axis per segment), and each layer reads and writes its
slice in place.

Plan-aware (sited) path: ``trunk_fwd(mesh=...)`` runs every layer's
feed-forward over the explicit chunked collectives of
``parallel.collectives``, each addressed by its SiteId.  A dense layer's
MLP: ``ring_ag_matmul`` for gate and up (up alone for GELU, its bias slice
added before the GELU), ``mm_reduce_scatter`` for down (its bias added once,
after the reduce-scatter), at ``tp.layer{i}.mlp.ag|rs`` without a cache and
``serve.layer{i}.mlp.ag|rs``
with one.  A MoE layer's experts: the dispatch and combine all-to-alls of
``layers.moe_block`` at ``ep.layer{j}.moe.a2a_disp|comb`` without a cache
(j counted within the segment, as the reference counts it) and
``serve.layer{i}.moe.a2a_*`` with one (i global, as
``core.extract.extract_decode_workload`` names them).  Each site resolves
its knobs against the active plan when it runs, so one plan can drive two
layers to different chunk structure.  Each rank holds a column shard of
``gate``/``up`` and a row shard of ``down`` of a dense MLP
(``shard_trunk``) and runs its E/n experts of a MoE layer, and the
sharded outputs are gathered back explicitly
(``collectives.all_gather_rows``) where GSPMD gathers them implicitly in
the reference.  Attention (GQA or MLA) is whole on every rank of a served trunk; on a
placed one (below) each rank runs its heads and the rows of ``o`` they
feed, summed over the model axis at ``tp.layer{i}.attn.ar``
(``layers.attention``, ``layers.mla_attention``), and a MoE layer's shared experts run
column-then-row at ``ep.layer{j}.moe.shared.ar`` (``layers.moe_block``):
one all-reduce each, unchunked, as GSPMD's in the reference.

Training: ``trunk_fwd(remat=True)`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), so the backward recomputes a
layer from its input, as the reference's ``jax.checkpoint`` per layer does;
on the sited path the recompute issues the layer's forward collectives
again, on every rank in the same order (backward layer order).  Every
collective helper has a backward (``parallel.collectives``), so the sited
trunk trains at any mesh size.  For training, ``models.model.shard_``
places the model in place: each layer's attention heads, MLP weights,
shared and routed experts become this rank's shards over ``model`` (under
the same state-dict names), which the sited trunk runs
(``Trunk.mlp_mesh``); serving keeps the whole
weights and hands ``trunk_fwd`` copies (``shard_trunk``).  On a model
placed over ``data`` (FSDP) each layer's weights are this rank's slices
and ``trunk_fwd``'s ``gather`` gathers them inside the layer's checkpoint,
and the routers route the global batch over ``data``
(``layers.moe_block``).
"""
from __future__ import annotations

import contextvars
import warnings
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import as_mesh
from repro_torch.models import layers as L
from repro_torch.parallel import constraints as CT
from repro_torch.parallel.collectives import (all_gather_rows, copy_to, mm_reduce_scatter,
                                              reduce_from, ring_ag_matmul, shard_rows)

Caches = Dict[str, Dict[str, object]]

SEGMENTS = ("dense_layers", "moe_layers")


FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg) -> None:
    """Raise for a config this trunk does not run."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} has no decoder trunk of models.dense")
    L.check_attention_supported(cfg)


def segment_sizes(cfg) -> Dict[str, int]:
    """Layers of each segment: a MoE model's leading ``first_dense_layers``
    are dense, the rest MoE; a dense model's are all dense."""
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    return {"dense_layers": n_dense, "moe_layers": cfg.num_layers - n_dense}


class Layer(nn.Module):
    """One pre-norm decoder layer: ln1 -> attention (``layers.MLA`` where
    ``attn_kind`` is ``"mla"``), ln2 -> MLP (``mlp``) or, with ``use_moe``,
    routed experts (``moe``); with ``parallel_block`` there is no ln2: the
    MLP reads ln1's output too."""

    def __init__(self, cfg, *, use_moe: bool = False, ep_pad: int = 1, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(cfg.d_model, cfg.norm_kind, **kw)
        self.attn = L.MLA(cfg, **kw) if cfg.attn_kind == "mla" else L.Attention(cfg, **kw)
        if not cfg.parallel_block:
            self.ln2 = L.Norm(cfg.d_model, cfg.norm_kind, **kw)
        if use_moe:
            self.moe = L.MoE(cfg, ep_pad=ep_pad, **kw)
        else:
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
    output leaves gathered back to (B, S, D) (``all_gather_rows``).  GELU
    (the reference's ``tp_mlp``): this rank's columns of ``up``'s bias are
    added before the GELU, ``down``'s bias once, to the gathered rows (so
    its gradient is the whole sequence's on every rank).  Where the
    sequence does not split over the mesh (whisper's 1500 frames over 16
    ranks) it runs column-then-row on the whole sequence instead: ``x``
    enters through ``copy_to`` (``{site}.ar.bwd``) and the ranks' partial
    rows are summed at ``{site}.ar``.
    Numerically ``layers.mlp``, and differentiable."""
    if kind not in L.MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {kind!r}; known: {L.MLP_KINDS}")
    m = as_mesh(mesh)
    if x.shape[-2] % m.size:
        xc = copy_to(x, m, site=f"{site}.ar.bwd")
        if kind == "swiglu":
            h = F.silu(F.linear(xc, p.gate.weight)) * F.linear(xc, p.up.weight)
        else:
            h = L.gelu(F.linear(xc, p.up.weight, p.up.bias))
        y = reduce_from(F.linear(h, p.down.weight), m, site=f"{site}.ar")
        return y + p.down.bias if kind == "gelu" else y
    xl = shard_rows(x, m)
    if kind == "swiglu":
        h = (F.silu(ring_ag_matmul(xl, p.gate.weight.T, m, site=f"{site}.ag"))
             * ring_ag_matmul(xl, p.up.weight.T, m, site=f"{site}.ag"))
    else:
        h = L.gelu(ring_ag_matmul(xl, p.up.weight.T, m, site=f"{site}.ag") + p.up.bias)
    y = all_gather_rows(mm_reduce_scatter(h, p.down.weight.T, m, site=f"{site}.rs"), m)
    return y + p.down.bias if kind == "gelu" else y


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
    ``up`` (and ``up``'s bias) and a row shard of ``down`` (in
    ``nn.Linear`` layout, rows of ``gate``/``up`` and columns of ``down``;
    ``down``'s bias whole).  At mesh size 1 the shard is ``p`` itself: no
    copy."""
    m = as_mesh(mesh)
    if m.size == 1:
        return p
    d_ff, d_model = p.up.weight.shape
    f = d_ff // m.size
    cols = slice(m.rank * f, (m.rank + 1) * f)
    w = p.up.weight
    kind = "swiglu" if hasattr(p, "gate") else "gelu"
    shard = L.MLP(d_model, f, kind, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        if kind == "swiglu":
            shard.gate.weight.copy_(p.gate.weight[cols])
        else:
            shard.up.bias.copy_(p.up.bias[cols])
            shard.down.bias.copy_(p.down.bias)
        shard.up.weight.copy_(p.up.weight[cols])
        shard.down.weight.copy_(p.down.weight[:, cols])
    return shard


def layers_of(p: "Trunk") -> Iterator[Tuple[str, int, int, Layer]]:
    """(segment, index in it, global index, layer) of every layer, in order."""
    li = 0
    for seg in SEGMENTS:
        for j, lp in enumerate(getattr(p, seg, ())):
            yield seg, j, li, lp
            li += 1


def shard_trunk(p: "Trunk", mesh) -> list:
    """Every layer's feed-forward shard in layer order: ``shard_mlp`` of a
    dense layer's MLP, a MoE layer's whole experts (``layers.moe_block``
    takes this rank's rows of them as views); what an engine makes once, at
    construction, and hands to ``trunk_fwd(shards=...)``."""
    return [lp.moe if seg == "moe_layers" else shard_mlp(lp.mlp, mesh)
            for seg, _, _, lp in layers_of(p)]


def layer_fwd(p: Layer, cfg, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, object]], *, backend: Optional[str] = None,
              mesh=None, site: str = "", serve: bool = False, ff=None,
              experts: Optional[int] = None, data=None, groups: int = 1,
              attn_site: str = "tp.attn",
              ) -> Tuple[torch.Tensor, Optional[Dict[str, object]], torch.Tensor]:
    """One decoder layer.  Returns (x, updated cache or None, aux).
    ``mesh`` switches the feed-forward onto the explicit plan-aware
    collectives, with ``ff`` this rank's shard of it (default ``p.mlp`` or
    ``p.moe``, the whole), ``site`` the layer's SiteId prefix and ``serve``
    marking the decode-shape layout of a dense MLP; attention split by
    heads over ``mesh`` (a placed model's) sums its rows at
    ``{attn_site}.ar``.  A MoE layer takes ``experts`` (its padded expert
    count), ``data`` and ``groups`` (``layers.moe_block``)."""
    x = CT.btd(x)
    h = L.norm(p.ln1, x, cfg.norm_kind, backend=backend)
    if cfg.attn_kind == "mla":
        attn_out, new_cache = L.mla_attention(p.attn, cfg, h, positions, cache=cache,
                                              backend=backend, mesh=mesh, site=attn_site)
    else:
        attn_out, new_cache = L.attention(p.attn, cfg, h, positions, cache=cache,
                                          backend=backend, mesh=mesh, site=attn_site)
    x = x + attn_out
    use_moe = hasattr(p, "moe")
    if ff is None:
        ff = p.moe if use_moe else p.mlp
    if use_moe:
        h2 = L.norm(p.ln2, x, cfg.norm_kind, backend=backend)
        out, aux = L.moe_block(ff, cfg, h2, experts=experts, mesh=mesh, data=data,
                               site=site or "ep.moe", groups=groups)
        return x + out, new_cache, aux
    # phi-2's parallel block: the MLP reads the attention's norm, x + attn + mlp
    h2 = h if cfg.parallel_block else L.norm(p.ln2, x, cfg.norm_kind, backend=backend)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mesh is None:
        return x + L.mlp(ff, h2, cfg.mlp_kind), new_cache, aux
    if serve:
        out = serve_mlp(ff, h2, cfg.mlp_kind, mesh, site=site or "serve.mlp")
    else:
        out = tp_mlp(ff, h2, cfg.mlp_kind, mesh, site=site or "tp.mlp")
    return x + out, new_cache, aux


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------

class Trunk(nn.Module):
    """The reference's two segments unstacked: ``dense_layers`` (state-dict
    keys ``dense_layers.{i}.*``) and, for a MoE model, ``moe_layers``
    (``moe_layers.{j}.*``); a segment with no layer is absent, as in the
    reference's tree."""

    def __init__(self, cfg, *, ep_pad: int = 1, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        for seg, n in segment_sizes(cfg).items():
            if n:
                setattr(self, seg, nn.ModuleList(
                    Layer(cfg, use_moe=seg == "moe_layers", ep_pad=ep_pad, **kw)
                    for _ in range(n)))
        self.mlp_mesh = None     # the mesh of the feed-forward shards, once placed
                                 # (model.shard_)


def init_trunk(cfg, *, ep_pad: int = 1, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, ep_pad=ep_pad, device=device, dtype=dtype)


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


def _ff(lp: Layer) -> nn.Module:
    return lp.moe if hasattr(lp, "moe") else lp.mlp


def trunk_fwd(p: Trunk, cfg, x: torch.Tensor, positions: torch.Tensor,
              caches: Optional[Caches] = None, *, backend: Optional[str] = None,
              mesh=None, shards: Optional[list] = None, remat: bool = False,
              gather=None, data=None, route_rows: bool = False,
              ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """caches: None | {segment: stacked cache}.  Returns (x, caches, aux);
    aux is the sum of the MoE layers' load-balancing losses (zero for a
    dense trunk).

    ``mesh`` opts into the plan-aware sited path (module docstring):
    dense layer ``i``'s MLP runs at ``tp.layer{i}.mlp`` without caches and
    at ``serve.layer{i}.mlp`` with them, MoE layer ``j`` (the ``i``-th in
    all) at ``ep.layer{j}.moe`` and ``serve.layer{i}.moe``.  A trunk
    sharded in place (``models.model.shard_``) runs its own feed-forwards,
    the shards, and needs its mesh; otherwise ``shards`` are this rank's
    (default ``shard_trunk(p, mesh)``, copies made anew for the call, which
    carry no gradient to ``p``; engines make them once).  Shapes the
    explicit helpers cannot split fall back to the unsited loop with a
    ``RuntimeWarning``, as the reference falls back to its scan (a sharded
    trunk raises).  ``remat`` (without caches) recomputes each layer in
    the backward.

    ``gather(name, site, lp)`` (a placed model's, ``models.model``) gives
    layer ``i`` (``name``: ``"{segment}.{j}"``) as it runs, its data-split
    weights gathered whole at ``site`` (``fsdp.layer{i}.ag_params``); it
    is called inside the layer's checkpoint, so
    remat's recompute gathers them again and no gathered layer outlives its
    use.  ``data`` is the data axis the routers route the global batch
    over; ``route_rows`` routes each row of the batch alone (the
    continuous engine's slots)."""
    kind = "tp" if caches is None else "serve"
    if p.mlp_mesh is not None and (mesh is None or as_mesh(mesh) != p.mlp_mesh
                                   or shards is not None):
        raise ValueError(f"the trunk's feed-forwards are this rank's shards over "
                         f"{p.mlp_mesh}: run it on that mesh, without other shards")
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
            first = _ff(next(layers_of(p))[3])
            if as_mesh(mesh).size > 1 and torch.is_grad_enabled() and any(
                    q.requires_grad for q in first.parameters()):
                raise ValueError(
                    f"training at mesh size {as_mesh(mesh).size} needs the feed-forward "
                    "shards as parameters: shard the trunk in place first "
                    "(models.model.shard_)")
            shards = shard_trunk(p, mesh)
    groups = x.shape[0] if route_rows else 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, j, i, lp in layers_of(p):
        sc = caches[seg] if caches is not None else None
        lc = None
        if sc is not None:      # layer j's views of the stacked cache, and the shared pos
            lc = {name: a if name == "pos" else a[j] for name, a in sc.items()}
        use_moe = seg == "moe_layers"
        if caches is not None:
            site = f"serve.layer{i}.{'moe' if use_moe else 'mlp'}"
        else:
            site = f"ep.layer{j}.moe" if use_moe else f"tp.layer{i}.mlp"

        def fl(x, lp=lp, lc=lc, i=i, name=f"{seg}.{j}", site=site, use_moe=use_moe):
            lq = lp if gather is None else gather(name, f"fsdp.layer{i}.ag_params", lp)
            ff = None
            if mesh is not None:
                ff = _ff(lq) if p.mlp_mesh is not None else shards[i]
            x, _, a = layer_fwd(lq, cfg, x, positions, lc, backend=backend, mesh=mesh,
                                site=site, serve=caches is not None, ff=ff,
                                experts=lp.moe.experts if use_moe else None,
                                data=data, groups=groups, attn_site=f"tp.layer{i}.attn")
            return x, a

        if remat and caches is None:
            # the backward may recompute the layer on autograd's device
            # thread: run it in this context (the plan scopes and issued-
            # collective logs are context variables) both times
            x, a = checkpoint(contextvars.copy_context().run, fl, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = fl(x)
        aux = aux + a
    new_caches = None
    if caches is not None:
        new_caches = {seg: dict(sc, pos=sc["pos"] + x.shape[1]) for seg, sc in caches.items()}
    return x, new_caches, aux


def split_stages(p: Trunk, stages: int) -> list:
    """A dense trunk's ``dense_layers`` in ``stages`` contiguous runs of
    equal length (the reference's stacked stage dim): stage ``s`` holds
    layers ``s·L/S ... (s+1)·L/S - 1``."""
    layers = list(getattr(p, "dense_layers", ()))
    if hasattr(p, "moe_layers") or not layers or len(layers) % stages:
        raise ValueError(f"a pipeline of {stages} stages needs a dense trunk whose layers "
                         f"split evenly; this one has {len(layers)} dense and "
                         f"{len(getattr(p, 'moe_layers', ()))} MoE layers")
    n = len(layers) // stages
    return [layers[s * n:(s + 1) * n] for s in range(stages)]


def stage_fwd(layers, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              remat: bool = False, backend: Optional[str] = None) -> torch.Tensor:
    """A pipeline stage: the given dense ``Layer``s in order through
    ``layer_fwd``, without a cache (the counterpart of the reference's
    uncached ``_run_segment``); ``remat`` recomputes each layer in the
    backward, as the reference's per-layer ``jax.checkpoint``."""
    for lp in layers:
        def fl(x, lp=lp):
            return layer_fwd(lp, cfg, x, positions, None, backend=backend)[0]

        if remat:
            x = checkpoint(contextvars.copy_context().run, fl, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fl(x)
    return x


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    """Stacked decode caches per segment: k, v (L,B,W,Hkv,h) (MLA: c_kv
    (L,B,W,kv_lora_rank) and k_rope (L,B,W,1,dr)), slot_pos (L,B,W), and
    one ``pos`` for all of the segment's layers (the reference stacks a
    per-layer copy): a Python int, or a (B,) tensor of per-row positions
    (the continuous engine's slots)."""
    check_supported(cfg)
    init = L.init_mla_cache if cfg.attn_kind == "mla" else L.init_kv_cache
    one = init(cfg, batch, seq_len, dtype=dtype, device=device)
    return {seg: {name: a.expand(n, *a.shape).clone() if torch.is_tensor(a) else a
                  for name, a in one.items()}
            for seg, n in segment_sizes(cfg).items() if n}
