"""Dense building blocks of the port (PyTorch counterpart of
``repro.models.layers``): norms, RoPE, GQA attention with a KV cache,
the SwiGLU MLP, and embeddings.

Parameters live in ``nn.Module``s; the functions take the module as their
``p`` argument, as the reference's functions take a parameter dict.  Linear
weights follow ``nn.Linear``: ``(d_out, d_in)``, the transpose of the
reference's ``(d_in, d_out)`` (``convert.params_from_jax`` transposes).
RMSNorm and prefill attention go through ``kernels.ops``, so on the card
they run the CUDA kernels; decode attention is plain PyTorch, as the
reference's is plain jnp.  Architectural variants that the dense llama
path does not use raise ``NotImplementedError`` naming the slice of the
port that brings them (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF

Cache = Dict[str, object]

OTHER_FAMILIES = "the port's other-families slice (ROADMAP.md, queue 1)"
QUERY_OFFSET = "a query offset in the flash kernel (ROADMAP.md, queue 2)"


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ Wᵀ (+ b): the reference's ``x @ w`` with ``w = Wᵀ``."""
    return p(x)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, d: int, kind: str, *, device=None, dtype=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


def norm(p: Norm, x: torch.Tensor, kind: str, eps: float = 1e-5, *,
         backend: Optional[str] = None) -> torch.Tensor:
    if kind == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
        return y.to(x.dtype)
    return ops.rmsnorm(x, p.scale, backend=backend, eps=eps)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., rot_dim//2), fp32."""
    half = rot_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., rot_dim) with cos/sin (..., rot_dim//2); half-split convention
    (the first half pairs with the second), not interleaved pairs."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, *,
               head_dim: int, fraction: float = 1.0, theta: float = 10_000.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k (B,S,KVH,hd); positions (B,S) int.  (M-RoPE arrives
    with the other families.)"""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    cos, sin = rope_angles(positions, rot, theta)          # (B,S,rot/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]       # broadcast over heads

    def rope_one(x):
        xr, xp = x[..., :rot], x[..., rot:]
        xr = _rotate(xr.float(), cos, sin).to(x.dtype)
        return torch.cat([xr, xp], dim=-1) if xp.shape[-1] else xr

    return rope_one(q), rope_one(k)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: q (d -> Hq·h), k and v (d -> Hkv·h), o (Hq·h -> d)."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        d, bias = cfg.d_model, cfg.attn_bias
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(d, cfg.q_dim, bias=bias, **kw)
        self.k = nn.Linear(d, cfg.kv_dim, bias=bias, **kw)
        self.v = nn.Linear(d, cfg.kv_dim, bias=bias, **kw)
        self.o = nn.Linear(cfg.q_dim, d, bias=bias, **kw)


def check_attention_supported(cfg) -> None:
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"attn_kind {cfg.attn_kind!r} arrives with {OTHER_FAMILIES}")
    if cfg.pos_kind != "rope":
        raise NotImplementedError(f"pos_kind {cfg.pos_kind!r} arrives with {OTHER_FAMILIES}")
    if cfg.sliding_window:
        raise NotImplementedError(f"sliding-window attention arrives with {OTHER_FAMILIES}")
    if cfg.qk_norm:
        raise NotImplementedError(f"qk_norm arrives with {OTHER_FAMILIES}")


def _gqa_scores_to_out(q, k, v, bias, scale):
    """Dense attention.  q (B,Sq,N,G,h); k,v (B,Sk,N,h); bias broadcastable to
    (B,N,G,Sq,Sk), additive, fp32.  Returns the query dtype."""
    logits = torch.einsum("bqngh,bsnh->bngqs", q.float(), k.float()) * scale
    w = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bngqs,bsnh->bqngh", w, v.float())
    return out.to(q.dtype)


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[Cache] = None, backend: Optional[str] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal GQA self-attention.  Returns (out, updated cache).

    * ``cache`` None -> the whole sequence at once, through the flash route.
      ``forward_hidden`` gives positions 0..S-1 here, so the kernel's causal
      mask by index is the reference's mask by position.
    * ``cache`` given, Sq > 1 -> prefill into an empty cache (``pos == 0``,
      the fixed engine's only case).  K/V and ``slot_pos`` are written as the
      reference writes them, and attention goes through the flash route:
      over an empty cache the reference's ``slot_pos`` mask is the causal
      mask over these Sq keys.  Prefill into a non-empty cache raises.
    * ``cache`` given, Sq == 1 -> decode: plain PyTorch over the whole cache
      with the per-row ``slot_pos`` mask, as the reference computes it.
      ``pos`` is one Python int for the batch (the fixed engine) or a (B,)
      tensor, one position a row (the continuous engine's slots, which the
      reference vmaps over): each row writes its K/V at its own position
      and masks by it.  The caller keeps every row's position below the
      cache's length (``model.decode_step`` checks it).

    The cache is updated in place (the reference returns a new one); the
    returned dict holds the same tensors and the advanced ``pos``.
    """
    check_attention_supported(cfg)
    B, Sq, _ = x.shape
    N, G, h = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    q = linear(p.q, x).view(B, Sq, N * G, h)
    k = linear(p.k, x).view(B, Sq, N, h)
    v = linear(p.v, x).view(B, Sq, N, h)
    q, k = apply_rope(q, k, positions, head_dim=h, fraction=cfg.rope_fraction,
                      theta=cfg.rope_theta)

    new_cache = None
    if cache is None:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=True, backend=backend)
    else:
        ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
        W, t = ck.shape[1], cache["pos"]
        if torch.is_tensor(t):
            if Sq != 1:
                raise NotImplementedError(
                    f"prefill into a cache at per-row positions arrives with {QUERY_OFFSET}")
            return _decode_rows(p, q, k, v, cache, N, G, h), dict(cache, pos=t + 1)
        if t + Sq > W:
            raise ValueError(f"KV cache of {W} slots cannot take {Sq} more at position {t}")
        if Sq > 1 and t != 0:
            raise NotImplementedError(
                f"prefill into a non-empty cache (pos {t}) arrives with {QUERY_OFFSET}")
        ck[:, t:t + Sq] = k.to(ck.dtype)
        cv[:, t:t + Sq] = v.to(cv.dtype)
        # slot_pos is per-sequence (B, W): the serving engine invalidates each
        # row's right-padded prefill slots independently (slot_pos = -1)
        spos[:, t:t + Sq] = torch.arange(t, t + Sq, dtype=spos.dtype, device=spos.device)
        new_cache = {"k": ck, "v": cv, "pos": t + Sq, "slot_pos": spos}
        if Sq > 1:
            # attend to the keys as stored in the cache, as the reference does
            kc = k.to(ck.dtype).to(q.dtype).contiguous()
            vc = v.to(cv.dtype).to(q.dtype).contiguous()
            out = ops.flash_attention(q.contiguous(), kc, vc, causal=True, backend=backend)
        else:
            q_pos = t + torch.arange(Sq, device=spos.device)
            valid = (spos[:, None, :] >= 0) & (spos[:, None, :] <= q_pos[None, :, None])
            bias = torch.zeros(valid.shape, dtype=torch.float32, device=x.device)
            bias = bias.masked_fill(~valid, NEG_INF)[:, None, None, :, :]
            out = _gqa_scores_to_out(q.view(B, Sq, N, G, h), ck, cv, bias, 1.0 / math.sqrt(h))
    return linear(p.o, out.reshape(B, Sq, N * G * h)), new_cache


def _decode_rows(p: Attention, q, k, v, cache: Cache, N: int, G: int, h: int):
    """Decode at per-row positions ``cache["pos"]`` (B,): row b writes its
    K/V and ``slot_pos`` at its own position and attends to the slots whose
    ``slot_pos`` lies in [0, that position].  Returns the attention output
    (B, 1, d)."""
    ck, cv, spos, t = cache["k"], cache["v"], cache["slot_pos"], cache["pos"]
    B = q.shape[0]
    rows = torch.arange(B, device=ck.device)
    ck[rows, t] = k[:, 0].to(ck.dtype)
    cv[rows, t] = v[:, 0].to(cv.dtype)
    spos[rows, t] = t.to(spos.dtype)
    valid = (spos >= 0) & (spos <= t[:, None])                    # (B, W)
    bias = torch.zeros(valid.shape, dtype=torch.float32, device=q.device)
    bias = bias.masked_fill(~valid, NEG_INF)[:, None, None, None, :]
    out = _gqa_scores_to_out(q.view(B, 1, N, G, h), ck, cv, bias, 1.0 / math.sqrt(h))
    return linear(p.o, out.reshape(B, 1, N * G * h))


def init_kv_cache(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                  device=None) -> Cache:
    """Pre-allocated decode cache: k, v (B,W,Hkv,h), slot_pos (B,W) int32
    (-1 = empty), and ``pos`` (tokens so far) as a Python int."""
    if cfg.sliding_window:
        raise NotImplementedError(f"sliding-window caches arrive with {OTHER_FAMILIES}")
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
        "slot_pos": torch.full((batch, seq_len), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# feed-forward and embeddings
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU feed-forward: gate, up (d -> d_ff) and down (d_ff -> d)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device=None, dtype=None):
        super().__init__()
        if kind != "swiglu":
            raise NotImplementedError(f"mlp_kind {kind!r} arrives with {OTHER_FAMILIES}")
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = nn.Linear(d_model, d_ff, **kw)
        self.up = nn.Linear(d_model, d_ff, **kw)
        self.down = nn.Linear(d_ff, d_model, **kw)


def mlp(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"mlp_kind {kind!r} arrives with {OTHER_FAMILIES}")
    return linear(p.down, F.silu(linear(p.gate, x)) * linear(p.up, x))
