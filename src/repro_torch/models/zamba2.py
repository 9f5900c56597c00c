"""Zamba2 hybrid trunk of the port (PyTorch counterpart of
``repro.models.zamba2``): Mamba2 layers with one *shared* transformer
block (attention + MLP, one set of weights) applied every
``shared_attn_every`` layers [arXiv:2411.15242].

The shared block reads concat(hidden, original embedding) through a
per-application input projection ``app_in`` (2·d_model -> d_model), runs
the shared attention and MLP at d_model, and is added back to the residual
stream.  The reference reshapes the trunk into ``n_groups`` groups of
``every`` mamba layers plus one shared-block application, and a tail of
the remaining layers, and scans over them; the port keeps the same split
as nested ``nn.ModuleList``s (state-dict keys ``groups.{g}.{j}.*``,
``app_in.{g}.*``, ``tail.{t}.*``, ``shared.*``) and loops.  The caches keep
the reference's stacked layout: each mamba layer's conv carry and SSD
state, and one KV cache per shared-block application (one ``pos`` for all).

Training: ``trunk_fwd(remat=True)`` checkpoints each Mamba layer
(``torch.utils.checkpoint``, non-reentrant) and not the shared block, as
the reference's ``jax.checkpoint`` does, so the backward recomputes a Mamba
layer from its input (its SSD scan and RMSNorms run again).
"""
from __future__ import annotations

import contextvars
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.parallel import constraints as CT

Caches = Dict[str, Dict[str, object]]


def _split(cfg) -> Tuple[int, int, int]:
    every = cfg.shared_attn_every
    n_groups = cfg.num_layers // every
    tail = cfg.num_layers - n_groups * every
    return every, n_groups, tail


class MambaLayer(nn.Module):
    """Pre-norm residual Mamba2 layer: ln (RMSNorm) -> mamba."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = L.Norm(cfg.d_model, "rmsnorm", **kw)
        self.mamba = mamba2.Block(cfg, **kw)


def mamba_layer_fwd(p: MambaLayer, cfg, x, cache, *, backend=None):
    x = CT.btd(x)
    h, nc = mamba2.block_fwd(p.mamba, cfg, L.norm(p.ln, x, "rmsnorm", backend=backend),
                             cache, backend=backend)
    return x + h, nc


class SharedBlock(nn.Module):
    """The shared transformer block: ln1 -> attention, ln2 -> SwiGLU MLP."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.d_model
        self.ln1 = L.Norm(D, "rmsnorm", **kw)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = L.Norm(D, "rmsnorm", **kw)
        self.mlp = L.MLP(D, cfg.d_ff, "swiglu", **kw)


class Trunk(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        L.check_attention_supported(cfg)
        every, n_groups, tail = _split(cfg)
        kw = dict(device=device, dtype=dtype)
        D = cfg.d_model
        if n_groups:
            self.groups = nn.ModuleList(
                nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(every))
                for _ in range(n_groups))
            # per-application input projections (2D -> D)
            self.app_in = nn.ModuleList(nn.Linear(2 * D, D, bias=False, **kw)
                                        for _ in range(n_groups))
            self.shared = SharedBlock(cfg, **kw)
        if tail:
            self.tail = nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(tail))


def init_trunk(cfg, *, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, device=device, dtype=dtype)


def _shared_block_fwd(shared: SharedBlock, app_in: nn.Linear, cfg, x, x0, positions,
                      cache, *, backend=None):
    x = CT.btd(x)
    h = L.linear(app_in, torch.cat([x, x0], dim=-1))
    a = L.norm(shared.ln1, h, "rmsnorm", backend=backend)
    attn_out, new_cache = L.attention(shared.attn, cfg, a, positions, cache=cache,
                                      backend=backend)
    h = h + attn_out
    h = h + L.mlp(shared.mlp, L.norm(shared.ln2, h, "rmsnorm", backend=backend), "swiglu")
    return x + h, new_cache


def _mamba_stack(layers, cfg, x, seg, index, *, backend=None, remat=False):
    """Run ``layers`` in order; ``seg`` is the stacked cache of this stack
    (leading axes ``index`` + the layer) or None.  Each layer's new conv carry
    is written into its slice of ``seg``; its SSD state already is that slice
    (``mamba2.block_fwd`` updates it in place), so it is not copied.  With
    ``remat`` and no cache each layer is checkpointed."""
    for j, lp in enumerate(layers):
        if remat and seg is None:
            def fl(x, lp=lp):
                return mamba_layer_fwd(lp, cfg, x, None, backend=backend)[0]

            x = checkpoint(contextvars.copy_context().run, fl, x, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        lc = None
        if seg is not None:
            lc = {name: a[index + (j,)] for name, a in seg.items()}
        x, nc = mamba_layer_fwd(lp, cfg, x, lc, backend=backend)
        if seg is not None:
            for name, a in nc.items():
                if a.data_ptr() != lc[name].data_ptr():
                    seg[name][index + (j,)] = a
    return x


def trunk_fwd(p: Trunk, cfg, x: torch.Tensor, positions: torch.Tensor,
              caches: Optional[Caches] = None, *, backend: Optional[str] = None,
              remat: bool = False) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """caches: None | {"groups": stacked (G, every, ...), "attn": stacked
    (G, ...) with one ``pos``, "tail": stacked (tail, ...)}, updated in
    place.  ``remat`` (with no caches, as the reference's) checkpoints each
    Mamba layer, not the shared block.  Returns (x, caches, aux); aux is
    zero (no MoE)."""
    every, n_groups, tail = _split(cfg)
    x0 = x              # original embeddings, read by every shared-block application
    for g in range(n_groups):
        x = _mamba_stack(p.groups[g], cfg, x, caches["groups"] if caches is not None else None, (g,),
                         backend=backend, remat=remat)
        ac = None
        if caches is not None:
            seg = caches["attn"]
            ac = {"k": seg["k"][g], "v": seg["v"][g], "slot_pos": seg["slot_pos"][g],
                  "pos": seg["pos"]}
        x, _ = _shared_block_fwd(p.shared, p.app_in[g], cfg, x, x0, positions, ac,
                                 backend=backend)
    if tail:
        x = _mamba_stack(p.tail, cfg, x, caches["tail"] if caches is not None else None, (),
                         backend=backend, remat=remat)
    if caches is not None and n_groups:
        caches = dict(caches, attn=dict(caches["attn"], pos=caches["attn"]["pos"] + x.shape[1]))
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    every, n_groups, tail = _split(cfg)
    m = mamba2.init_cache(cfg, batch, dtype=dtype, device=device)

    def stack(one, lead):
        return {name: a.expand(*lead, *a.shape).clone() if torch.is_tensor(a) else a
                for name, a in one.items()}

    caches: Caches = {}
    if n_groups:
        caches["groups"] = stack(m, (n_groups, every))
        caches["attn"] = stack(L.init_kv_cache(cfg, batch, seq_len, dtype=dtype, device=device),
                               (n_groups,))
    if tail:
        caches["tail"] = stack(m, (tail,))
    return caches
