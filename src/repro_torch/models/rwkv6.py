"""RWKV6 "Finch" trunk of the port (PyTorch counterpart of
``repro.models.rwkv6``): attention-free, with data-dependent decay
[arXiv:2404.05892].

A layer is a time-mix (the WKV6 linear recurrence over a per-head (K, V)
state, with a per-channel decay made by a LoRA on the token-shifted input)
and a channel-mix (a squared-ReLU FFN with a receptance gate).  The
recurrence runs through ``kernels.ops.wkv6`` (the CUDA WKV6 kernel on the
card, its plain versions on the CPU); the norms are LayerNorms in plain
PyTorch, as the reference's are plain jnp.  The matrices keep the
reference's names and its (d_in, d_out) layout (``x @ W``), as raw
parameters: ``Wr``, ``Wk``, ``Wv``, ``Wg``, ``Wo``, ``maa_w1`` (D, 5·32),
``maa_w2`` (5, 32, D), ``decay_w1`` (D, 64), ``decay_w2`` (64, D), and the
channel-mix's ``Wk``, ``Wv``, ``Wr``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel import constraints as CT

Caches = Dict[str, Dict[str, torch.Tensor]]

MIX_LORA = 32     # rank of the 5-way token-mix LoRA
DECAY_LORA = 64   # rank of the decay LoRA
GROUP_NORM_EPS = 64e-5


def _param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class TimeMix(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        D, H, Kd = cfg.d_model, cfg.num_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.maa_x = _param(D, **kw)
        self.maa = _param(5, D, **kw)                        # w, k, v, r, g bases
        self.maa_w1 = _param(D, 5 * MIX_LORA, **kw)
        self.maa_w2 = _param(5, MIX_LORA, D, **kw)
        self.decay = _param(D, **kw)                         # w = exp(-exp(decay + lora))
        self.decay_w1 = _param(D, DECAY_LORA, **kw)
        self.decay_w2 = _param(DECAY_LORA, D, **kw)
        self.bonus = _param(H, Kd, **kw)                     # u
        for name in ("Wr", "Wk", "Wv", "Wg", "Wo"):
            setattr(self, name, _param(D, D, **kw))
        self.ln_x = L.Norm(D, "layernorm", **kw)             # per-head group norm

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        D = self.maa_x.shape[0]
        self.maa_x.zero_()
        self.maa.zero_()
        self.maa_w1.normal_(0.0, 0.01, generator=gen)
        self.maa_w2.normal_(0.0, 0.01, generator=gen)
        self.decay.fill_(-6.0)
        self.decay_w1.normal_(0.0, 0.01, generator=gen)
        self.decay_w2.normal_(0.0, 0.01, generator=gen)
        self.bonus.normal_(0.0, 0.1, generator=gen)
        for name in ("Wr", "Wk", "Wv", "Wg", "Wo"):
            getattr(self, name).normal_(0.0, 1.0 / math.sqrt(D), generator=gen)


class ChannelMix(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.maa_k = _param(D, **kw)
        self.maa_r = _param(D, **kw)
        self.Wk = _param(D, Fd, **kw)
        self.Wv = _param(Fd, D, **kw)
        self.Wr = _param(D, D, **kw)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.maa_k.zero_()
        self.maa_r.zero_()
        for W in (self.Wk, self.Wv, self.Wr):       # N(0, 1/d_in)
            W.normal_(0.0, 1.0 / math.sqrt(W.shape[0]), generator=gen)


class Layer(nn.Module):
    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.ln2 = L.Norm(cfg.d_model, "layernorm", **kw)
        self.tm = TimeMix(cfg, **kw)
        self.cm = ChannelMix(cfg, **kw)


class Trunk(nn.Module):
    """``layers``: the per-layer stack (state-dict keys ``layers.{i}.*``, the
    reference's stacked ``layers`` unstacked)."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(Layer(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_layers))


def init_trunk(cfg, *, device=None, dtype=None) -> Trunk:
    return Trunk(cfg, device=device, dtype=dtype)


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,S,D) -> the previous token's activations; ``last`` (B,1,D) is the
    carry from the previous segment (zeros at the sequence start)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _group_norm_heads(p: L.Norm, x: torch.Tensor, H: int) -> torch.Tensor:
    """LayerNorm per head (RWKV's GroupNorm(heads)), fp32 out."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, D // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, unbiased=False, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    return xh.reshape(B, S, D) * p.scale + p.bias


def time_mix(p: TimeMix, cfg, x: torch.Tensor, state, shift_last, *,
             backend: Optional[str] = None):
    """Returns (out, new WKV state (B,H,K,V) fp32, the last token (B,1,D)).
    A given ``state`` is updated in place and is the state returned."""
    B, S, D = x.shape
    H, Kd = cfg.num_heads, cfg.head_dim
    xprev = _token_shift(x, shift_last)
    dx = xprev - x
    xxx = x + dx * p.maa_x
    m = torch.tanh(xxx @ p.maa_w1).reshape(B, S, 5, MIX_LORA)
    m = torch.einsum("bsfr,frd->bsfd", m, p.maa_w2)                # (B,S,5,D)
    mu = p.maa[None, None] + m
    xw, xk, xv, xr, xg = (x + dx * mu[:, :, i] for i in range(5))

    r = (xr @ p.Wr).reshape(B, S, H, Kd)
    k = (xk @ p.Wk).reshape(B, S, H, Kd)
    v = (xv @ p.Wv).reshape(B, S, H, Kd)
    g = F.silu(xg @ p.Wg)
    w_log = -torch.exp(p.decay.float() + torch.tanh(xw @ p.decay_w1) @ p.decay_w2)
    w_log = w_log.reshape(B, S, H, Kd)

    y, new_state = ops.wkv6(r, k, v, w_log, p.bonus, state, out_state=state, backend=backend)
    y = _group_norm_heads(p.ln_x, y.reshape(B, S, D), H).to(x.dtype)
    return (y * g) @ p.Wo, new_state, x[:, -1:]


def channel_mix(p: ChannelMix, x: torch.Tensor, shift_last) -> Tuple[torch.Tensor, torch.Tensor]:
    xprev = _token_shift(x, shift_last)
    dx = xprev - x
    xk = x + dx * p.maa_k
    xr = x + dx * p.maa_r
    h = torch.square(F.relu(xk @ p.Wk))
    return torch.sigmoid(xr @ p.Wr) * (h @ p.Wv), x[:, -1:]


def layer_fwd(p: Layer, cfg, x: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]], *,
              backend: Optional[str] = None):
    """cache: {"wkv", "shift_tm", "shift_cm"} or None.  Returns (x, new cache
    or None).  The cache's WKV state is updated in place and is the new
    cache's "wkv"; its token shifts are new tensors, and the cache's are not
    modified."""
    x = CT.btd(x)
    st = cache or {}
    tm_out, wkv, tm_last = time_mix(p.tm, cfg, L.norm(p.ln1, x, "layernorm"),
                                    st.get("wkv"), st.get("shift_tm"), backend=backend)
    x = x + tm_out
    cm_out, cm_last = channel_mix(p.cm, L.norm(p.ln2, x, "layernorm"), st.get("shift_cm"))
    x = x + cm_out
    new_cache = ({"wkv": wkv, "shift_tm": tm_last, "shift_cm": cm_last}
                 if cache is not None else None)
    return x, new_cache


def trunk_fwd(p: Trunk, cfg, x: torch.Tensor, positions=None, caches: Optional[Caches] = None,
              *, backend: Optional[str] = None):
    """caches: None | {"layers": stacked (L, ...)}, updated in place.  Returns
    (x, caches, aux); aux is zero (no MoE).  ``positions`` is unused.  Each
    layer's token shifts are written into its slice of the cache; its WKV
    state already is that slice (``time_mix`` updates it in place), so it is
    not copied."""
    seg = caches["layers"] if caches is not None else None
    for i, lp in enumerate(p.layers):
        lc = None if seg is None else {name: a[i] for name, a in seg.items()}
        x, nc = layer_fwd(lp, cfg, x, lc, backend=backend)
        if seg is not None:
            for name, a in nc.items():
                if a.data_ptr() != lc[name].data_ptr():
                    seg[name][i] = a
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def init_trunk_caches(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                      device=None) -> Caches:
    n = cfg.num_layers
    return {"layers": {
        "wkv": torch.zeros((n, batch, cfg.num_heads, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((n, batch, 1, cfg.d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((n, batch, 1, cfg.d_model), dtype=dtype, device=device),
    }}
