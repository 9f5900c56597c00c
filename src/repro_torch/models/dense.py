"""Dense decoder trunk of the port (PyTorch counterpart of
``repro.models.dense``, its scan path).

The reference stacks the layers on a leading axis and runs them with
``lax.scan``; eager PyTorch has nothing to trace, so the port keeps one
``Layer`` module per layer in an ``nn.ModuleList`` and loops over it.  The
KV caches keep the reference's stacked layout (a leading layer axis), and
each layer reads and writes its slice in place.

Not ported here, and raising ``NotImplementedError`` naming the slice that
brings them: MoE feed-forwards, MLA, sliding windows, ALiBi, ``qk_norm``,
``parallel_block``, and the plan-aware sited ``mesh=`` path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L

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


def layer_fwd(p: Layer, cfg, x: torch.Tensor, positions: torch.Tensor,
              cache: Optional[Dict[str, object]], *, backend: Optional[str] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, object]]]:
    """One decoder layer.  Returns (x, updated cache or None)."""
    # parallel/constraints.py is not ported: the reference's CT.btd pins a
    # sharding at this boundary, which is a no-op on one device.
    h = L.norm(p.ln1, x, cfg.norm_kind, backend=backend)
    attn_out, new_cache = L.attention(p.attn, cfg, h, positions, cache=cache,
                                      backend=backend)
    x = x + attn_out
    h2 = L.norm(p.ln2, x, cfg.norm_kind, backend=backend)
    return x + L.mlp(p.mlp, h2, cfg.mlp_kind), new_cache


class Trunk(nn.Module):
    """``dense_layers``: the per-layer stack (state-dict keys
    ``dense_layers.{i}.*``, the reference's ``dense_layers`` unstacked)."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        self.dense_layers = nn.ModuleList(
            Layer(cfg, device=device, dtype=dtype) for _ in range(cfg.num_layers))


def init_trunk(cfg, *, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, device=device, dtype=dtype)


def trunk_fwd(p: Trunk, cfg, x: torch.Tensor, positions: torch.Tensor,
              caches: Optional[Caches] = None, *, backend: Optional[str] = None,
              mesh=None) -> Tuple[torch.Tensor, Optional[Caches], torch.Tensor]:
    """caches: None | {"dense_layers": stacked cache}.  Returns (x, caches,
    aux); aux is the MoE load-balancing loss, zero for the dense trunk."""
    if mesh is not None:
        raise NotImplementedError(f"the plan-aware sited trunk (mesh=) arrives with "
                                  f"{L.SERVING_SLICE}")
    seg = caches["dense_layers"] if caches is not None else None
    for i, lp in enumerate(p.dense_layers):
        lc = None
        if seg is not None:
            lc = {"k": seg["k"][i], "v": seg["v"][i], "slot_pos": seg["slot_pos"][i],
                  "pos": seg["pos"]}
        x, _ = layer_fwd(lp, cfg, x, positions, lc, backend=backend)
    new_caches = None
    if seg is not None:
        new_caches = {"dense_layers": dict(seg, pos=seg["pos"] + x.shape[1])}
    return x, new_caches, torch.zeros((), dtype=torch.float32, device=x.device)


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    """Stacked decode caches: k, v (L,B,W,Hkv,h), slot_pos (L,B,W), and one
    ``pos`` for all layers (the reference stacks a per-layer copy)."""
    check_supported(cfg)
    n = cfg.num_layers
    one = L.init_kv_cache(cfg, batch, seq_len, dtype=dtype, device=device)
    stacked = {name: a.expand(n, *a.shape).clone() if torch.is_tensor(a) else a
               for name, a in one.items()}
    return {"dense_layers": stacked}
