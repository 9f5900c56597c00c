"""Model API of the port (PyTorch counterpart of ``repro.models.model``)
for every family of the zoo: dense, ``moe`` (MLA included), ``vlm``
(M-RoPE), ``ssm`` (rwkv6), ``hybrid`` (zamba2) and ``audio`` (whisper).

    model = init_params(cfg, seed, device="cuda"[, ep_pad=n])          # nn.Module
    loss, metrics = loss_and_metrics(cfg, model, batch)                 # train
    x, caches, aux = forward_hidden(cfg, model, batch[, caches])        # prefill
    caches = init_caches(cfg, batch_size, seq_len, device="cuda")       # serving
    logits, caches = decode_step(cfg, model, tokens, caches)            # decode
    shard_(cfg, model, meshes)      # training on a (data, model) mesh: placed in place
    model = init_placed(cfg, seed, meshes, device="cuda")   # the same, drawn a module at a time
    model = init_stage(cfg, seed, stage, stages, device="cuda")     # a pipeline rank's
    loss, metrics = pipeline_loss(cfg, model, batch, mesh=stage_mesh, microbatches=M)

``batch``: {"tokens": (B,S) int}, and for the loss "targets" (B,S) int and
optionally "mask" (B,S) float; plus "frames" (B, encoder_seq, D) for audio
and optionally "patches" (B, n, D) for vlm (the frontends are stubs:
precomputed embeddings, which replace the first n token embeddings).  A
vlm batch with patches takes the reference's M-RoPE grid: patch i at
(0, i // 16, i % 16), text j at 16 + j on all three axes; its attention
masks by index on every route (the flash kernel's mask), which the
reference's cached prefill does and its uncached path does not (it masks
by the temporal position: ROADMAP.md, queue 3).  Entry points run on the
card unless the caller passes ``device="cpu"``; asking for ``"cuda"`` with
no card raises.  The weights are random, drawn on the target device from a
``torch.Generator`` seeded with ``seed`` (the reference draws from
``jax.random``; the tests convert its weights with
``convert.params_from_jax`` instead of reseeding).  The loss
(``loss_and_metrics``, chunked cross-entropy plus ``router_aux_coef``
times the routers' load-balancing loss) trains the dense, moe (MLA
included) and vlm families, which share the trunk of ``models.dense``,
and the audio family (``models.whisper``: the tied embedding's gradient
sums the lookup's and the head's, ``dec_pos`` gets the rows below S),
and the hybrid family (``models.zamba2``, its SSD scan through
``ops.SSDFn`` on the card); ssm (rwkv6) trains only once WKV6 has a
backward (``WKV6_BACKWARD``).  ``shard_`` places the dense, moe (MLA
included), vlm (M-RoPE) and audio (learned positions) families; the two
recurrent trunks raise (``RECURRENT_PLACEMENT``).
"""
from __future__ import annotations

import contextvars
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.convert import reference_layout
from repro_torch.launch.mesh import as_mesh
from repro_torch.models import dense, layers as L, rwkv6, whisper, zamba2
from repro_torch.parallel import collectives, constraints as CT, sharding
from repro_torch.parallel.pipeline import pipeline_apply

Caches = Dict[str, object]

_TRUNKS = {"dense": dense, "moe": dense, "vlm": dense, "ssm": rwkv6, "hybrid": zamba2,
           "audio": whisper}
WKV6_BACKWARD = "the WKV6 backward (ROADMAP.md, queue 1 item 14.2)"
RECURRENT_PLACEMENT = "placing the recurrent trunks (ROADMAP.md, queue 1 item 14.3)"
PLACEMENT = "the rest of the placements (ROADMAP.md, queue 1 item 8)"
DECODER = dense.FAMILIES         # the families of ``models.dense``'s trunk
N_PATCHES = 256                  # the vlm stub: one 16x16 image at the sequence head
_PATCH_GRID = 16


def _trunk(cfg):
    if cfg.family not in _TRUNKS:
        raise ValueError(f"unknown family {cfg.family!r}; known: {sorted(_TRUNKS)}")
    return _TRUNKS[cfg.family]


def shard_(cfg, model: "Model", mesh) -> "Model":
    """Place ``model`` in place on ``mesh`` for training.  ``mesh`` is this
    rank's ``{"data": Mesh, "model": Mesh}`` (``launch.mesh.make_mesh``):
    every parameter becomes this rank's slice of the reference's placement
    (``parallel.sharding.place``: the F dims over ``data`` where they
    divide; the T dims over ``model``: attention by whole heads, so
    ``attn.q.weight`` is (Hq/m·h, D/d), the MLP's and the shared experts'
    hidden units, the experts (``moe.gate`` is (E/m, D/d, f)) and the
    vocabulary of the embedding and the head (``embed.weight`` is (V/m,
    D/d))); the norm scales, the routers, the shared gate and the biases
    of ``o`` and ``down`` stay whole.  The other families alike: whisper's
    encoder, self- and cross-attention by heads, its GELU MLPs over
    ``model``, its tied vocabulary where m divides it (51865 stays whole),
    ``dec_pos`` over ``data`` by positions and ``enc_pos`` whole; MLA by
    heads (``q``, ``kv_b``, ``o``; ``kv_a`` and the latent's norm whole on
    ``model``); M-RoPE's GQA as any GQA.  One ``Mesh`` is the model axis
    alone.  ``model.placement`` records which axis splits which dim
    (``sharding.Placement``); ``forward_hidden`` and the loss gather each
    data-split weight where it is used, run the vocabulary's slices
    (``_embed``, ``chunked_ce``), the trunk runs its shards on the model
    axis (``trunk.mlp_mesh``), and its routers route the global batch over
    ``data``.  A placed model trains; it serves no cache."""
    if model.placement is not None:
        raise ValueError("the model is already sharded: place it once")
    place = _placement(cfg, model, mesh)
    for name, p in list(model.named_parameters()):
        _keep_local(model, place, name, p)
    return _placed(model, place)


def check_placement(cfg) -> None:
    """Raise for a family that cannot be placed yet, naming its item."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"training the {cfg.family!r} family on a mesh "
                                  f"arrives with {RECURRENT_PLACEMENT}")


def _placement(cfg, model: Model, mesh) -> sharding.Placement:
    check_placement(cfg)
    return sharding.place(reference_layout(cfg, model), mesh, heads=sharding.heads_of(cfg))


@torch.no_grad()
def _keep_local(model: Model, place: sharding.Placement, name: str, p) -> None:
    """Replace the parameter ``name`` (``p``) by this rank's slice of it."""
    t = place.local(name, p)
    if t is not p:
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=p.requires_grad))


def _placed(model: Model, place: sharding.Placement) -> Model:
    if "model" in place.meshes:
        model.trunk.mlp_mesh = place.meshes["model"]
    model.placement = place
    return model


def init_placed(cfg, seed: int, mesh, *, device="cuda", ep_pad: int = 1) -> Model:
    """``shard_(cfg, init_params(cfg, seed, device=device, ep_pad=ep_pad),
    mesh)``, the same slices of the same weights, without the whole model
    on the device: each module's leaves are drawn whole, in
    ``init_params``' order from its one generator, and cut to this rank's
    slices before the next module's are drawn (qwen2-vl-72b's 80 fp32
    layers are 290 GB)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Model(cfg, ep_pad=ep_pad, dtype=_dtype(cfg))
    place = _placement(cfg, model, mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for prefix, mod in model.named_modules():
        own = list(mod.named_parameters(recurse=False))
        for n, p in own:
            setattr(mod, n, nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device=dev),
                                         requires_grad=p.requires_grad))
        _init_module(mod, gen)
        for n, _ in own:
            _keep_local(model, place, f"{prefix}.{n}" if prefix else n, getattr(mod, n))
    return _placed(model, place)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Model(nn.Module):
    """embed -> trunk -> ln_f -> head (untied) or embedᵀ (tied).  ``ep_pad``
    pads a MoE model's experts to a multiple of it (``layers.moe_pad_experts``).
    An audio model also holds the decoder's learned positions ``dec_pos``
    (max_seq_len, d), at the top level as the reference keeps them."""

    def __init__(self, cfg, *, ep_pad: int = 1, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.trunk = (dense.init_trunk(cfg, ep_pad=ep_pad, **kw) if cfg.family in DECODER
                      else _trunk(cfg).init_trunk(cfg, **kw))
        if cfg.family == "audio":
            self.dec_pos = nn.Parameter(torch.empty((cfg.max_seq_len, cfg.d_model), **kw))
        self.ln_f = L.Norm(cfg.d_model, cfg.norm_kind, **kw)
        self.head = None if cfg.tie_embeddings else nn.Linear(
            cfg.d_model, cfg.vocab_size, bias=False, **kw)
        self.placement: Optional[sharding.Placement] = None     # shard_

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """``dec_pos`` N(0, 0.02²), as the reference draws it."""
        if hasattr(self, "dec_pos"):
            self.dec_pos.normal_(0.0, 0.02, generator=gen)


@torch.no_grad()
def _init_weights(model: Model, gen: torch.Generator) -> None:
    """The reference's scheme: linear weights N(0, 1/d_in), biases 0,
    embeddings N(0, 0.02²), norm scales 1 and biases 0; modules with other
    leaves (the Mamba2 block, RWKV6's time- and channel-mix, the experts)
    draw those themselves (``init_weights``).  Each module draws only its
    own leaves (``_init_module``)."""
    for mod in model.modules():
        _init_module(mod, gen)


@torch.no_grad()
def _init_module(mod: nn.Module, gen: torch.Generator) -> None:
    if hasattr(mod, "init_weights"):
        mod.init_weights(gen)
    if isinstance(mod, nn.Linear):
        mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features), generator=gen)
        if mod.bias is not None:
            mod.bias.zero_()
    elif isinstance(mod, nn.Embedding):
        mod.weight.normal_(0.0, 0.02, generator=gen)
    elif isinstance(mod, L.Norm):
        mod.scale.fill_(1.0)
        if mod.kind == "layernorm":
            mod.bias.zero_()


def init_params(cfg, seed: int = 0, *, device="cuda", ep_pad: int = 1) -> Model:
    """A model with random weights, made on ``device`` (never on the host
    and copied: llama3-8b in fp32 is 32 GB), its experts padded by
    ``ep_pad``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Model(cfg, ep_pad=ep_pad, dtype=_dtype(cfg))
    model = model.to_empty(device=dev)
    _init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def _check_pipeline(cfg) -> None:
    """The pipeline runs the dense, non-MoE trunk; anything else raises,
    naming the slice that would lift it."""
    if cfg.family == "dense" and not cfg.is_moe:
        return
    later = {"moe": "the MoE follow-ups (ROADMAP.md, queue 1 item 11)",
             "ssm": RECURRENT_PLACEMENT, "hybrid": RECURRENT_PLACEMENT}
    raise NotImplementedError(f"a pipeline of the {cfg.family!r} family arrives with "
                              + later.get(cfg.family, PLACEMENT))


def init_stage(cfg, seed: int = 0, stage: int = 0, stages: int = 1, *,
               device="cuda") -> Model:
    """Stage ``stage`` of ``stages`` of a dense model with random weights,
    made on ``device``: the embedding, final norm and head, and of the
    trunk only layers ``s·L/S ... (s+1)·L/S - 1`` (a pipeline rank
    allocates its stage alone: yi-34b's 60 layers fit no card).  The
    embedding and head are drawn from ``seed`` in ``init_params``'s order,
    so they are equal on every rank; layer ``i`` is drawn from a generator
    of its own, seeded ``seed + 1 + i``, so the stages of S hold the very
    layers that ``init_stage(cfg, seed)`` (one stage: the whole model)
    holds.  The weights differ from ``init_params(cfg, seed)``'s, which
    draws every layer from one generator."""
    _check_pipeline(cfg)
    if cfg.num_layers % stages or not 0 <= stage < stages:
        raise ValueError(f"stage {stage} of {stages}: {cfg.num_layers} layers do not "
                         "split into that many equal stages")
    n = cfg.num_layers // stages
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Model(cfg.replace(num_layers=n), dtype=_dtype(cfg))
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for part in (model.embed, model.ln_f, model.head):
        if part is not None:
            _init_weights(part, gen)
    for j, lp in enumerate(model.trunk.dense_layers):
        _init_weights(lp, torch.Generator(device=dev).manual_seed(seed + 1 + stage * n + j))
    return model


def _positions(cfg, B: int, S: int, t0, device, *, patches: bool = False) -> torch.Tensor:
    """(B,S) int64 positions t0..t0+S-1; ``t0`` an int, or a (B,) tensor of
    per-row starts.  M-RoPE: (3,B,S), the same positions on the three axes
    or, with ``patches``, the reference's grid: the first N_PATCHES at
    (t0, t0 + i // 16, t0 + i % 16), text j at t0 + 16 + j on all three."""
    if torch.is_tensor(t0):
        pos = t0.to(device, torch.int64)[:, None] + torch.arange(S, device=device)
    else:
        pos = (t0 + torch.arange(S, device=device)).expand(B, S)
    if cfg.pos_kind != "mrope":
        return pos
    if not patches:
        return pos.expand(3, B, S)
    n = N_PATCHES
    i = torch.arange(n, device=device)
    text = _PATCH_GRID + torch.arange(S - n, device=device)
    grid = torch.stack([torch.cat([torch.zeros_like(i), text]),
                        torch.cat([i // _PATCH_GRID, text]),
                        torch.cat([i % _PATCH_GRID, text])])              # (3,S)
    start = t0.to(device, torch.int64)[:, None] if torch.is_tensor(t0) else t0
    return grid[:, None, :] + start


def _embed_inputs(cfg, p: "Model", batch) -> torch.Tensor:
    """The token embeddings, a vlm batch's first n replaced by its patches."""
    x = _embed(p, batch["tokens"])
    patches = batch.get("patches") if cfg.family == "vlm" else None
    if patches is not None:
        n = patches.shape[1]
        x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
    return x


def forward_hidden(cfg, p: Model, batch, caches: Optional[Caches] = None, *,
                   remat: bool = False, backend: Optional[str] = None, mesh=None,
                   shards=None, route_rows: bool = False,
                   ) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """Runs the trunk over batch["tokens"].  If ``caches`` is given, this is a
    cached prefill into fresh caches (filled in place).  ``remat`` recomputes
    each decoder layer in the backward.  ``mesh`` opts the dense, moe
    and vlm families into the plan-aware sited trunk (``dense.trunk_fwd``,
    with ``shards`` this rank's feed-forward shards); a placed audio model
    runs its trunk on it (``whisper.encode``); the recurrent families and a
    whole audio model ignore it.  ``route_rows`` routes each row's tokens alone through the
    experts (the continuous engine: the reference vmaps over its slots).

    Audio: the encoder runs over ``batch["frames"]``, the decoder's learned
    positions (gathered over ``data`` at ``fsdp.dec_pos.ag_params`` where
    the placement splits them) are added at each row's position, and a
    cached prefill keeps the encoder's output in the caches' ``"memory"``
    for decode."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if caches is not None:
        _check_unplaced(p)
    t0 = caches["pos"] if caches is not None else 0
    positions = _positions(cfg, B, S, t0, tokens.device,
                           patches=batch.get("patches") is not None)
    x = _embed_inputs(cfg, p, batch)
    tc = caches["trunk"] if caches is not None else None
    if cfg.family == "audio":
        if batch.get("frames") is None:
            raise ValueError("an audio model's batch needs its 'frames' (B, encoder_seq, D)")
        gather = _layer_gather(p)
        memory = whisper.encode(p.trunk, cfg, batch["frames"].to(x.dtype), backend=backend,
                                remat=remat, mesh=mesh, gather=gather)
        x, new_tc = whisper.decode_trunk(p.trunk, cfg, x + _dec_pos(p, positions, t0, S),
                                         memory, positions, tc, backend=backend, remat=remat,
                                         mesh=mesh, gather=gather)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = None if caches is None else {"trunk": new_tc, "pos": t0 + S,
                                                  "memory": memory}
    else:
        x, new_tc, aux = _trunk_fwd(cfg, p, x, positions, tc, backend=backend, mesh=mesh,
                                    shards=shards, remat=remat, route_rows=route_rows)
        new_caches = None if caches is None else {"trunk": new_tc, "pos": t0 + S}
    return L.norm(p.ln_f, x, cfg.norm_kind, backend=backend), new_caches, aux


def _weight(p: Model, name: str, site: str) -> torch.Tensor:
    """The parameter ``name`` of ``p``, gathered over ``data`` (logged at
    ``site``) when the placement splits it there: whole, or this rank's
    slice over ``model``."""
    w = p.get_parameter(name)
    return w if p.placement is None else p.placement.gather(name, w, site)


def _dec_pos(p: Model, positions: torch.Tensor, t0, S: int) -> torch.Tensor:
    """An audio model's learned positions at ``positions`` (gathered over
    ``data`` where the placement splits them): rows t0 .. t0 + S - 1 for
    every row of the batch where ``t0`` is one int, a slice whose gradient
    sums over the batch in a fixed order (an index's scatter-add on the
    host's threads does not: the ranks' whole copies would drift apart),
    else each row's own."""
    w = _weight(p, "dec_pos", "fsdp.dec_pos.ag_params")
    return w[positions] if torch.is_tensor(t0) else w[t0:t0 + S]


def _vocab_mesh(p: Model, name: str):
    """The model axis that splits the vocabulary of ``name`` (the embedding
    or the head), or None."""
    place = p.placement
    if place is None or "model" not in place.axes(name):
        return None
    return place.meshes["model"]


def _check_unplaced(p: Model) -> None:
    if p.placement is not None and any("model" in p.placement.axes(n)
                                       for n in p.placement.specs):
        raise ValueError("a model placed over 'model' trains; the engines serve whole "
                         "models (ROADMAP.md, queue 1 item 8)")


def _embed(p: Model, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens``.  With the table's vocabulary split over
    ``model`` (rank ``r`` holding ids ``r·V/m ...``), each rank looks up the
    ids in its range, zeros the rest, and the ranks' rows are summed at
    ``tp.embed.ar`` (``collectives.reduce_from``)."""
    w = _weight(p, "embed.weight", "fsdp.embed.ag_params")
    m = _vocab_mesh(p, "embed.weight")
    if m is None:
        return F.embedding(tokens, w)
    v0 = m.rank * w.shape[0]
    mine = (tokens >= v0) & (tokens < v0 + w.shape[0])
    rows = F.embedding(torch.where(mine, tokens - v0, 0), w) * mine[..., None].to(w.dtype)
    return collectives.reduce_from(rows, m, site="tp.embed.ar")


def _layer_gather(p: Model):
    """The trunks' ``gather`` for a model placed over ``data``: the layer
    ``trunk.{name}`` as modules over its weights gathered at ``site``
    (``dense.trunk_fwd``, ``whisper.encode``)."""
    if p.placement is None or "data" not in p.placement.meshes:
        return None

    def gather(name, site, lp):
        return sharding.gathered(lp, f"trunk.{name}.", p.placement, site)

    return gather


def _trunk_fwd(cfg, p: Model, x, positions, tc, *, backend, mesh, shards, remat=False,
               route_rows=False):
    if cfg.family in DECODER:
        data = None if p.placement is None else p.placement.meshes.get("data")
        return dense.trunk_fwd(p.trunk, cfg, x, positions, tc, backend=backend, mesh=mesh,
                               shards=shards, remat=remat, gather=_layer_gather(p),
                               data=data, route_rows=route_rows)
    # as in the reference, the recurrent families ignore ``mesh``
    if cfg.family == "hybrid":
        return zamba2.trunk_fwd(p.trunk, cfg, x, positions, tc, backend=backend, remat=remat)
    if remat:
        raise NotImplementedError(f"remat of the {cfg.family!r} trunk arrives with "
                                  f"{WKV6_BACKWARD}")
    return _trunk(cfg).trunk_fwd(p.trunk, cfg, x, positions, tc, backend=backend)


def _head(cfg, p: Model) -> torch.Tensor:
    """The unembedding weight (V, D), whole: the head's, or the embedding's
    when tied."""
    if cfg.tie_embeddings:
        return _weight(p, "embed.weight", "fsdp.embed.ag_params")
    return _weight(p, "head.weight", "fsdp.head.ag_params")


def _logits(cfg, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.T if cfg.tie_embeddings else F.linear(x, w)


def _unembed(cfg, p: Model, x: torch.Tensor) -> torch.Tensor:
    return _logits(cfg, _head(cfg, p), x)


# ---------------------------------------------------------------------------
# training loss (chunked cross-entropy: the full (B,S,V) logits are never
# materialized; each chunk's logits are recomputed in the backward)
# ---------------------------------------------------------------------------

def _chunk_ce(cfg, w, xb, tb, mb, mesh) -> torch.Tensor:
    logits = CT.logits(_logits(cfg, w, CT.btd(xb)).float())
    return collectives.vocab_parallel_ce(logits, tb, mb, mesh)


def chunked_ce(cfg, p: Model, x, targets, mask, *, chunk: int = 256) -> torch.Tensor:
    """Masked mean cross-entropy of the head's logits at x (B,S,D) against
    targets (B,S), over sequence chunks of ``chunk`` (S padded to a
    multiple, the pad masked out).  Each chunk runs under
    ``torch.utils.checkpoint``, so only one chunk's (B, chunk, V) logits
    exist at a time, in the backward too; the chunks' sums add up in order
    in fp32, as the reference's scan does.  The unembedding weight is
    gathered once for all chunks (a placed model's head is split over
    ``data``), and its gradient reduce-scattered once.  A head whose
    vocabulary is split over ``model`` gives each rank its (B, chunk, V/m)
    logits, whose cross-entropy is vocab-parallel
    (``collectives.vocab_parallel_ce`` at ``tp.ce.ar``; remat's recompute
    issues each chunk's sums again, in the same order on every rank); x
    enters through ``copy_to`` at ``tp.ce.ar.bwd``."""
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    targets = targets.long()
    w = _head(cfg, p)
    m = as_mesh(_vocab_mesh(p, "embed.weight" if cfg.tie_embeddings else "head.weight"))
    x = collectives.copy_to(x, m, site="tp.ce.ar.bwd")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        tot = tot + checkpoint(contextvars.copy_context().run, _chunk_ce, cfg, w, x[:, sl],
                               targets[:, sl], mask[:, sl], m, use_reentrant=False,
                               preserve_rng_state=False)
    return tot / torch.clamp(mask.sum(), min=1.0)


def loss_and_metrics(cfg, p: Model, batch, *, remat: bool = True,
                     backend: Optional[str] = None, mesh=None):
    """The training loss: chunked cross-entropy plus ``router_aux_coef``
    times the trunk's aux loss.  ``batch``: tokens, targets and optionally
    mask (ones by default); a vlm batch's patch rows carry no target (their
    mask is zeroed).  Returns (loss, {"ce", "aux", "loss"})."""
    x, _, aux = forward_hidden(cfg, p, batch, remat=remat, backend=backend, mesh=mesh)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, dtype=torch.float32, device=x.device)
    mask = mask.float()
    if cfg.family == "vlm" and batch.get("patches") is not None:
        mask = mask.clone()
        mask[:, :batch["patches"].shape[1]] = 0.0
    ce = chunked_ce(cfg, p, x, batch["targets"], mask)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def pipeline_loss(cfg, p: Model, batch, *, mesh, microbatches: int, remat: bool = True,
                  backend: Optional[str] = None, site: Optional[str] = None):
    """The training loss through a pipeline over ``mesh``'s stages
    (``parallel.pipeline.pipeline_apply``), composed as the reference
    composes its own functions: the embedding on every rank, this rank's
    stage of the trunk over the microbatches (each with one microbatch's
    (B/M, S) positions), then the final norm and ``chunked_ce`` on every
    rank, from the outputs every rank holds.  ``p`` holds all
    ``cfg.num_layers`` layers (the rank runs its run of ``dense.
    split_stages``) or, made by ``init_stage``, its stage's alone.  Every
    rank returns the same loss; its gradients reach this rank's stage, and
    the embedding, final norm and head alike on every rank.  Dense,
    non-MoE configs only.  Returns (loss, {"ce", "aux", "loss"}) as
    ``loss_and_metrics``."""
    _check_pipeline(cfg)
    if p.placement is not None:
        raise ValueError("a pipeline runs an unplaced model: its stage is its own")
    m = as_mesh(mesh["stage"] if isinstance(mesh, dict) else mesh)
    held = len(p.trunk.dense_layers)
    if held == cfg.num_layers:
        layers = dense.split_stages(p.trunk, m.size)[m.rank]
    elif held * m.size == cfg.num_layers:
        layers = list(p.trunk.dense_layers)
    else:
        raise ValueError(f"the model holds {held} layers: neither the {cfg.num_layers} of "
                         f"{cfg.name} nor one stage of {m.size}")
    tokens = batch["tokens"]

    def stage(layers, x):
        positions = _positions(cfg, x.shape[0], x.shape[1], 0, x.device)
        return dense.stage_fwd(layers, cfg, x, positions, remat=remat, backend=backend)

    x = pipeline_apply(stage, layers, F.embedding(tokens, p.embed.weight), mesh=m,
                       microbatches=microbatches, site=site)
    x = L.norm(p.ln_f, x, cfg.norm_kind, backend=backend)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, dtype=torch.float32, device=x.device)
    ce = chunked_ce(cfg, p, x, batch["targets"], mask.float())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return ce, {"ce": ce, "aux": aux, "loss": ce}


def init_caches(cfg, batch: int, seq_len: int, *, device="cuda") -> Caches:
    """Fresh caches for ``batch`` sequences of up to ``seq_len`` tokens; an
    audio model's also hold the encoder's ``memory`` (zeros until a cached
    prefill writes it)."""
    dev = resolve_device(device)
    caches = {"trunk": _trunk(cfg).init_trunk_caches(cfg, batch, seq_len, dtype=_dtype(cfg),
                                                     device=dev),
              "pos": 0}
    if cfg.family == "audio":
        caches["memory"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=_dtype(cfg), device=dev)
    return caches


def _kv_slots(tc) -> Optional[int]:
    """Slots a row of the KV caches in ``tc`` holds (None: no KV cache)."""
    for name, a in tc.items():
        if isinstance(a, dict):
            w = _kv_slots(a)
            if w is not None:
                return w
        elif name == "slot_pos":
            return a.shape[-1]
    return None


def decode_step(cfg, p: Model, tokens: torch.Tensor, caches: Caches, *,
                backend: Optional[str] = None, mesh=None, shards=None,
                route_rows: bool = False) -> Tuple[torch.Tensor, Caches]:
    """One token per sequence: tokens (B,1) -> logits (B,1,vocab).

    ``caches["pos"]`` is one int for the batch, or a (B,) tensor of per-row
    positions (each engine row's true position; every cache ``pos`` inside
    holds the same tensor).  ``mesh`` opts the dense and moe families into
    the sited decode path (``serve.layer{i}.*`` sites, ``shards`` this
    rank's feed-forward shards); ``route_rows`` as in ``forward_hidden``.
    A sliding-window model's ring of ``window`` slots wraps; any other cache
    raises at a position it does not hold.  M-RoPE decodes at the row's
    position on all three axes, after a prefill with patches too, as the
    reference's ``decode_step`` does; an audio model's decoder attends to
    the caches' ``memory``, with its learned positions at the row's
    position."""
    _check_unplaced(p)
    B = tokens.shape[0]
    t0 = caches["pos"]
    if torch.is_tensor(t0):
        W = _kv_slots(caches["trunk"])
        # a ring of the whole window wraps, as the reference's does; a shorter
        # cache must not (it would drop keys still inside the window)
        if W is not None and not L._ring(cfg, W) and int(t0.max()) >= W:
            raise ValueError(f"KV cache of {W} slots cannot take a token at "
                             f"positions {t0.tolist()}")
    positions = _positions(cfg, B, 1, t0, tokens.device)
    x = _embed(p, tokens)
    new_caches = {"pos": t0 + 1}
    if cfg.family == "audio":
        x, new_caches["trunk"] = whisper.decode_trunk(
            p.trunk, cfg, x + _dec_pos(p, positions, t0, 1), caches["memory"], positions,
            caches["trunk"], backend=backend,
            gather=_layer_gather(p))
        new_caches["memory"] = caches["memory"]
    else:
        x, new_caches["trunk"], _ = _trunk_fwd(cfg, p, x, positions, caches["trunk"],
                                               backend=backend, mesh=mesh, shards=shards,
                                               route_rows=route_rows)
    x = L.norm(p.ln_f, x, cfg.norm_kind, backend=backend)
    return _unembed(cfg, p, x), new_caches
