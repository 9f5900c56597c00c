"""Whisper-style encoder-decoder trunk of the port (PyTorch counterpart of
``repro.models.whisper``) [arXiv:2212.04356].

The mel-spectrogram and conv frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, encoder_seq, d_model).  The
encoder is a stack of bidirectional attention layers over the frames plus
the learned ``enc_pos``; the decoder a stack of causal self-attention
(with the KV cache), cross-attention to the encoder's memory and a
feed-forward, all pre-LayerNorm.  The decoder's learned positions
(``dec_pos``) belong to the model (``models.model``), as in the reference.

The reference stacks each stack's layers and scans over them; the port
keeps them as ``nn.ModuleList``s (state-dict keys ``enc_layers.{i}.*``,
``dec_layers.{i}.*``) and loops.  Attention goes through
``layers.attention``: the flash route with ``causal=False`` for the
encoder and for cross-attention (K and V projected from the memory at
every call, decode steps included, as the reference does), causal for
the decoder's self-attention; its decode is plain PyTorch over the cache.
The LayerNorms are plain PyTorch, as the reference's are jnp.  The caches
keep the reference's layout, ``{"dec": stacked KV cache}`` with one
``pos`` for all layers.

Placed for training (``models.model.shard_``), the trunk runs on its model
axis (``Trunk.mlp_mesh``) as ``dense.trunk_fwd`` runs a placed decoder:
every attention by heads (``layers.attention``; cross-attention projects
this rank's K and V heads from the memory), every GELU MLP through
``dense.tp_mlp`` (``up``'s bias split, ``down``'s added once), and each
layer's data-split weights gathered inside its checkpoint by the model's
``gather``.  Decoder layer i takes the sites ``core.extract`` names a
layer: ``tp.layer{i}.attn``, ``tp.layer{i}.mlp``, ``fsdp.layer{i}.ag_params``,
and ``tp.layer{i}.cross_attn`` for its cross-attention; encoder layer i
``tp.enc{i}.attn``, ``tp.enc{i}.mlp`` and ``fsdp.enc{i}.ag_params`` (the
port's names: the extractor has no encoder).
"""
from __future__ import annotations

import contextvars
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import as_mesh
from repro_torch.models import dense, layers as L
from repro_torch.parallel import constraints as CT

Caches = Dict[str, Dict[str, object]]


class EncLayer(nn.Module):
    """ln1 -> bidirectional attention, ln2 -> MLP."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)


class DecLayer(nn.Module):
    """ln1 -> causal self-attention, ln_x -> cross-attention, ln2 -> MLP."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.self_attn = L.Attention(cfg, **kw)
        self.ln_x = L.Norm(cfg.d_model, "layernorm", **kw)
        self.cross_attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, **kw)


class Trunk(nn.Module):
    """``enc_pos`` (encoder_seq, d), ``enc_layers``, ``enc_ln`` and
    ``dec_layers``: the reference's ``init_trunk`` keys."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.enc_pos = nn.Parameter(torch.empty((cfg.encoder_seq, cfg.d_model), **kw))
        self.enc_layers = nn.ModuleList(EncLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_ln = L.Norm(cfg.d_model, "layernorm", **kw)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.mlp_mesh = None     # the model axis of the trunk's shards, once placed
                                 # (model.shard_)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """``enc_pos`` N(0, 0.02²), as the reference draws it."""
        self.enc_pos.normal_(0.0, 0.02, generator=gen)


def init_trunk(cfg, *, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, device=device, dtype=dtype)


def _run(fn, x, remat: bool):
    """fn(x), recomputed in the backward with ``remat``; both runs in this
    context (the plan scopes and issued-collective logs are context
    variables, and the backward may run on autograd's device thread)."""
    if not remat:
        return fn(x)
    return checkpoint(contextvars.copy_context().run, fn, x, use_reentrant=False,
                      preserve_rng_state=False)


def _mesh(p: Trunk, cfg, mesh):
    """The model axis a placed trunk runs on (``mesh``, which must be its
    own), or None for a whole trunk, which ignores ``mesh`` as the
    reference's does."""
    if p.mlp_mesh is None:
        return None
    if mesh is None or as_mesh(mesh) != p.mlp_mesh:
        raise ValueError(f"the trunk is placed over {p.mlp_mesh}: run it on that mesh")
    if cfg.d_ff % p.mlp_mesh.size:
        raise ValueError(f"placed trunk: d_ff {cfg.d_ff} must split over "
                         f"{p.mlp_mesh.size} model ranks")
    return p.mlp_mesh


def _mlp(mp, cfg, h: torch.Tensor, mesh, site: str) -> torch.Tensor:
    """The GELU MLP: whole, or this rank's hidden units over ``mesh``
    (``dense.tp_mlp`` at ``site``)."""
    if mesh is None:
        return L.mlp(mp, h, cfg.mlp_kind)
    return dense.tp_mlp(mp, h, cfg.mlp_kind, mesh, site=site)


def encode(p: Trunk, cfg, frames: torch.Tensor, *, backend: Optional[str] = None,
           remat: bool = False, mesh=None, gather=None) -> torch.Tensor:
    """frames (B, encoder_seq, d) stub embeddings -> the memory (B, S, d):
    ``enc_pos`` added, the bidirectional layers, ``enc_ln``.  ``remat``
    recomputes each layer in the backward (the reference always does).
    ``mesh`` and ``gather(name, site, layer)`` as the module docstring
    says (a placed model's)."""
    x = CT.btd(frames + p.enc_pos[None, :frames.shape[1]])
    B, S, _ = x.shape
    mesh = _mesh(p, cfg, mesh)
    pos = torch.arange(S, device=x.device).expand(B, S)
    for i, lp in enumerate(p.enc_layers):
        def body(x, lp=lp, i=i):
            lq = lp if gather is None else gather(f"enc_layers.{i}", f"fsdp.enc{i}.ag_params",
                                                  lp)
            x = CT.btd(x)
            h = L.norm(lq.ln1, x, "layernorm")
            x = x + L.attention(lq.attn, cfg, h, pos, causal=False, backend=backend,
                                mesh=mesh, site=f"tp.enc{i}.attn")[0]
            return x + _mlp(lq.mlp, cfg, L.norm(lq.ln2, x, "layernorm"), mesh,
                            f"tp.enc{i}.mlp")

        x = _run(body, x, remat)
    return L.norm(p.enc_ln, x, "layernorm")


def dec_layer_fwd(lp: DecLayer, cfg, x: torch.Tensor, memory: torch.Tensor,
                  positions: torch.Tensor, cache, *, backend: Optional[str] = None,
                  mesh=None, site: str = "tp"):
    """One decoder layer, its sites under ``site`` (``tp.layer{i}``) on a
    placed trunk's ``mesh``.  Returns (x, updated cache or None)."""
    x = CT.btd(x)
    h = L.norm(lp.ln1, x, "layernorm")
    a, new_cache = L.attention(lp.self_attn, cfg, h, positions, cache=cache, backend=backend,
                               mesh=mesh, site=f"{site}.attn")
    x = x + a
    h = L.norm(lp.ln_x, x, "layernorm")
    x = x + L.attention(lp.cross_attn, cfg, h, positions, x_kv=memory, backend=backend,
                        mesh=mesh, site=f"{site}.cross_attn")[0]
    x = x + _mlp(lp.mlp, cfg, L.norm(lp.ln2, x, "layernorm"), mesh, f"{site}.mlp")
    return x, new_cache


def decode_trunk(p: Trunk, cfg, x: torch.Tensor, memory: torch.Tensor,
                 positions: torch.Tensor, caches: Optional[Caches] = None, *,
                 backend: Optional[str] = None, remat: bool = False, mesh=None,
                 gather=None) -> Tuple[torch.Tensor, Optional[Caches]]:
    """The decoder stack over x (B, S, d) (its learned positions already
    added) against ``memory``.  caches: None | {"dec": stacked KV cache},
    whose layer views each layer updates in place.  ``mesh`` and
    ``gather`` as ``encode`` takes them.  Returns (x, caches)."""
    mesh = _mesh(p, cfg, mesh)
    sc = caches["dec"] if caches is not None else None
    for j, lp in enumerate(p.dec_layers):
        def layer(x, lc, lp=lp, j=j):
            lq = lp if gather is None else gather(f"dec_layers.{j}", f"fsdp.layer{j}.ag_params",
                                                  lp)
            return dec_layer_fwd(lq, cfg, x, memory, positions, lc, backend=backend,
                                 mesh=mesh, site=f"tp.layer{j}")

        if sc is None:
            x = _run(lambda x, layer=layer: layer(x, None)[0], x, remat)
            continue
        lc = {name: a if name == "pos" else a[j] for name, a in sc.items()}
        x, _ = layer(x, lc)
    if caches is None:
        return x, None
    return x, {"dec": dict(sc, pos=sc["pos"] + x.shape[1])}


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    """{"dec": k, v (L,B,W,H,h), slot_pos (L,B,W) and one ``pos``}."""
    one = L.init_kv_cache(cfg, batch, seq_len, dtype=dtype, device=device)
    return {"dec": {name: a.expand(cfg.num_layers, *a.shape).clone() if torch.is_tensor(a)
                    else a for name, a in one.items()}}
