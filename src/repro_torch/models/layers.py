"""Building blocks of the port (PyTorch counterpart of
``repro.models.layers``): norms, RoPE (full, partial or M-RoPE), ALiBi, GQA
attention with a KV cache (a ring of ``sliding_window`` slots for
sliding-window models), a sliding window and optional ``qk_norm``,
bidirectional and cross-attention, MLA (DeepSeek-V2's latent attention,
``MLA``, ``mla_attention``) with its compressed cache, the SwiGLU and GELU
MLPs, and the capacity-based mixture of experts (``MoE``, ``moe_block``)
with its explicit expert-parallel FFN.

Parameters live in ``nn.Module``s; the functions take the module as their
``p`` argument, as the reference's functions take a parameter dict.  Linear
weights follow ``nn.Linear``: ``(d_out, d_in)``, the transpose of the
reference's ``(d_in, d_out)`` (``convert.params_from_jax`` transposes).
RMSNorm (``qk_norm``'s per-head norms and MLA's ``kv_a_norm`` included)
and GQA attention over a whole sequence (causal, bidirectional or cross)
go through ``kernels.ops``, so on the card they run the CUDA kernels;
decode attention is plain PyTorch, as the reference's is plain jnp, and
so are MLA's scores (the flash kernel has no instantiation of its 192-wide
q·k head beside its 128-wide v head; ROADMAP.md, queue 2) and the MoE's
router, scatter, expert products (batched GEMMs, as the reference's
``einsum``) and combine: the reference computes them outside any Pallas
kernel.

ALiBi departs from the reference on purpose: the reference adds its bias
only on the uncached path (``bias_fn``), so its cached prefill and decode
run with no position information at all (ROADMAP.md, queue 3).  The port
follows the uncached path, the model the reference defines and trains,
on all three routes: the uncached flash, the cached-prefill flash and
decode, whose bias is ``slope·(slot_pos − q_pos)`` over the valid slots.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.launch.mesh import as_mesh
from repro_torch.parallel import collectives as C
from repro_torch.parallel import constraints as CT

Cache = Dict[str, object]

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
               head_dim: int, fraction: float = 1.0, theta: float = 10_000.0,
               mrope_sections: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k (B,S,KVH,hd); positions (B,S) int, or (3,B,S) for
    M-RoPE: ``mrope_sections`` (t, h, w) split the rot/2 frequencies, the
    i-th section rotating by the positions of axis i."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    if mrope_sections:
        rot = 2 * sum(mrope_sections)
        cos_t, sin_t = rope_angles(positions, rot, theta)   # (3,B,S,rot/2)
        sections = list(mrope_sections)
        cos = torch.cat([c[i] for i, c in enumerate(cos_t.split(sections, dim=-1))], dim=-1)
        sin = torch.cat([c[i] for i, c in enumerate(sin_t.split(sections, dim=-1))], dim=-1)
    else:
        cos, sin = rope_angles(positions, rot, theta)      # (B,S,rot/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]       # broadcast over heads

    def rope_one(x):
        xr, xp = x[..., :rot], x[..., rot:]
        xr = _rotate(xr.float(), cos, sin).to(x.dtype)
        return torch.cat([xr, xp], dim=-1) if xp.shape[-1] else xr

    return rope_one(q), rope_one(k)


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """The reference's ALiBi slopes, one a query head, fp32 on the CPU: for
    2^e heads the geometric series 2^(-8/2^e)^(i+1); other head counts take
    the odd powers of 2^(-4/2^e) for the rest."""
    exp = math.floor(math.log2(num_heads))
    base = 2.0 ** (-8.0 / (2 ** exp))
    slopes = [base ** (i + 1) for i in range(2 ** exp)]
    if len(slopes) < num_heads:  # non-power-of-two heads
        extra_base = 2.0 ** (-4.0 / (2 ** exp))
        slopes += [extra_base ** (2 * i + 1) for i in range(num_heads - len(slopes))]
    return torch.tensor(slopes, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _slopes_on(num_heads: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes`` on ``device``, copied there once."""
    return alibi_slopes(num_heads).to(device)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: q (d -> Hq·h), k and v (d -> Hkv·h), o (Hq·h -> d);
    with ``qk_norm``, RMSNorms ``q_norm`` and ``k_norm`` over ``head_dim``."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        d, bias = cfg.d_model, cfg.attn_bias
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(d, cfg.q_dim, bias=bias, **kw)
        self.k = nn.Linear(d, cfg.kv_dim, bias=bias, **kw)
        self.v = nn.Linear(d, cfg.kv_dim, bias=bias, **kw)
        self.o = nn.Linear(cfg.q_dim, d, bias=bias, **kw)
        if cfg.qk_norm:
            self.q_norm = Norm(cfg.head_dim, "rmsnorm", **kw)
            self.k_norm = Norm(cfg.head_dim, "rmsnorm", **kw)


ATTN_KINDS = ("gqa", "mla")
POS_KINDS = ("rope", "mrope", "alibi", "learned", "none")


def check_attention_supported(cfg) -> None:
    if cfg.attn_kind not in ATTN_KINDS:
        raise ValueError(f"unknown attn_kind {cfg.attn_kind!r}; known: {ATTN_KINDS}")
    if cfg.pos_kind not in POS_KINDS:
        raise ValueError(f"unknown pos_kind {cfg.pos_kind!r}; known: {POS_KINDS}")


def _ring(cfg, W: int) -> bool:
    """A cache of W slots is a ring (written at ``t % W``, as the reference
    writes it) when it holds the whole window; a cache shorter than the
    window must not wrap, which would drop keys still inside it."""
    return bool(cfg.sliding_window) and W >= cfg.sliding_window


def _decode_bias(cfg, spos: torch.Tensor, q_pos: torch.Tensor, N: int, G: int
                 ) -> torch.Tensor:
    """The additive bias of one decode query per row over the cache's slots:
    spos (B, W), q_pos (B, 1) -> (B, N, G, 1, W) fp32.  Valid slots hold a
    key at or before q_pos (inside the window); ALiBi adds
    slope·(slot_pos − q_pos) on them."""
    valid = (spos >= 0) & (spos <= q_pos)
    if cfg.sliding_window:
        valid &= spos > q_pos - cfg.sliding_window
    if cfg.pos_kind == "alibi":
        slopes = _slopes_on(cfg.num_heads, spos.device).view(1, N, G, 1, 1)
        bias = slopes * (spos - q_pos).float()[:, None, None, None, :]
    else:
        bias = torch.zeros(valid.shape, dtype=torch.float32,
                           device=spos.device)[:, None, None, None, :]
    return bias.masked_fill(~valid[:, None, None, None, :], NEG_INF)


def _gqa_scores_to_out(q, k, v, bias, scale):
    """Dense attention.  q (B,Sq,N,G,h); k,v (B,Sk,N,h); bias broadcastable to
    (B,N,G,Sq,Sk), additive, fp32.  Returns the query dtype."""
    logits = torch.einsum("bqngh,bsnh->bngqs", q.float(), k.float()) * scale
    w = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bngqs,bsnh->bqngh", w, v.float())
    return out.to(q.dtype)


def _rank_heads(p: Attention, cfg, x: torch.Tensor, m, site: str,
                x_kv: Optional[torch.Tensor] = None):
    """This rank's share of attention split by heads over ``m``: its query
    heads are the contiguous block ``q0 ... q0 + hq - 1`` (laid out KV-head
    major, query head ``n·G + g`` reads KV head ``n``).  ``x`` enters
    through ``copy_to``; so does cross-attention's memory ``x_kv``, which K
    and V are projected from (``{site}.mem.ar.bwd``): every rank's share of
    its gradient is summed.  Where k and v are whole on the model axis
    (``sharding``: m does not divide the KV heads, and the block lies in
    one group) the rank projects the one KV head its block reads from the
    whole weights, each of which enters through ``copy_to`` too.  Returns
    (q, k, v, q0)."""
    B, S, _ = x.shape
    h, G = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    hq = p.q.weight.shape[0] // h
    q0 = m.rank * hq
    x = C.copy_to(x, m, site=f"{site}.ar.bwd")
    src = x if x_kv is None else C.copy_to(x_kv, m, site=f"{site}.mem.ar.bwd")
    Sk = src.shape[1]
    q = linear(p.q, x).view(B, S, hq, h)
    if p.k.weight.shape[0] // h < cfg.num_kv_heads:          # split by heads too
        k, v = linear(p.k, src), linear(p.v, src)
        return q, k.view(B, Sk, -1, h), v.view(B, Sk, -1, h), q0
    rows = slice(q0 // G * h, (q0 // G + 1) * h)
    k, v = (F.linear(src, C.copy_to(lin.weight, m, site=f"{site}.kv.ar.bwd")[rows],
                     None if lin.bias is None
                     else C.copy_to(lin.bias, m, site=f"{site}.kv.ar.bwd")[rows])
            for lin in (p.k, p.v))
    return q, k.view(B, Sk, 1, h), v.view(B, Sk, 1, h), q0


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[Cache] = None, x_kv: Optional[torch.Tensor] = None,
              causal: bool = True, backend: Optional[str] = None,
              mesh=None, site: str = "tp.attn") -> Tuple[torch.Tensor, Optional[Cache]]:
    """GQA attention: causal self-attention, with ``cfg.sliding_window``
    and ALiBi where the config has them; ``causal=False`` bidirectional
    self-attention (whisper's encoder); or, with ``x_kv`` (B, Sk, d),
    cross-attention of x's queries to K and V projected from ``x_kv``
    (whisper's decoder over the encoder's memory: no cache, no RoPE).  The
    last two attend to every key (the reference's zero bias: no window, no
    ALiBi) through the flash route with ``causal=False``, K and V made
    contiguous for the kernel.  RoPE is M-RoPE where ``cfg.pos_kind`` is
    ``"mrope"`` (``positions`` (3, B, S)); learned positions are added to
    the input by the model, so attention applies none.  Returns (out,
    updated cache).

    The head counts come from the weights: where ``p`` holds this rank's
    heads of attention split over the model axis ``mesh`` (a placed model,
    ``models.model.shard_``), the rank computes its heads (``_rank_heads``;
    ALiBi with its slice of the slopes; bidirectional, or cross-attention
    with its K and V heads projected from the memory), its rows of ``o``'s
    product, and the sum over the ranks (``collectives.reduce_from`` at
    ``{site}.ar``), to which ``o``'s bias is added once.  Whole weights
    take the route below, unchanged.

    * ``cache`` None -> the whole sequence at once, through the flash route.
      ``forward_hidden`` gives positions 0..S-1 here, so the kernel's causal
      mask, window and ALiBi distances by index are the reference's by
      position.
    * ``cache`` given, Sq > 1 -> prefill into an empty cache (``pos == 0``,
      the fixed engine's only case) that holds all Sq keys.  K/V and
      ``slot_pos`` are written as the reference writes them, and attention
      goes through the flash route: over an empty cache the reference's
      ``slot_pos`` mask is the causal (and windowed) mask over these Sq
      keys.  Prefill into a non-empty cache raises.
    * ``cache`` given, Sq == 1 -> decode (``_decode_rows``): plain PyTorch
      over the whole cache with the per-row ``slot_pos`` mask, as the
      reference computes it.  ``pos`` is one Python int for the batch or a
      (B,) tensor, one true position a row (both engines' rows, which the
      reference's continuous engine vmaps over): each row writes its K/V at
      its own position and masks by it.  A ring (``_ring``) writes position
      t at slot ``t % W``; any other cache must hold the position (checked
      here for an int ``pos``, by ``model.decode_step`` for a tensor).

    The cache is updated in place (the reference returns a new one); the
    returned dict holds the same tensors and the advanced ``pos``.
    """
    check_attention_supported(cfg)
    B, Sq, _ = x.shape
    h = cfg.head_dim
    placed = p.q.weight.shape[0] != cfg.q_dim
    full = x_kv is not None or not causal
    if full and cache is not None:
        raise ValueError("bidirectional and cross-attention run without a cache")
    if placed:
        m = as_mesh(mesh)
        if cache is not None:
            raise ValueError("attention split over 'model' serves no cache: the engines "
                             "serve whole models (ROADMAP.md, queue 1 item 8)")
        if m.size * p.q.weight.shape[0] != cfg.q_dim:
            raise ValueError(f"attention holds {p.q.weight.shape[0] // h} of "
                             f"{cfg.num_heads} query heads: run it on its model axis")
        q, k, v, q0 = _rank_heads(p, cfg, x, m, site, x_kv)
    else:
        N, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        src = x if x_kv is None else x_kv
        q = linear(p.q, x).view(B, Sq, N * G, h)
        k = linear(p.k, src).view(B, src.shape[1], N, h)
        v = linear(p.v, src).view(B, src.shape[1], N, h)
        q0 = 0
    if cfg.qk_norm:            # per head, over head_dim, before RoPE
        qs, ks = p.q_norm.scale, p.k_norm.scale
        if placed:             # whole scales that each rank uses on its heads
            qs, ks = (C.copy_to(t, m, site=f"{site}.qk_norm.ar.bwd") for t in (qs, ks))
        q = ops.rmsnorm(q, qs, backend=backend, eps=1e-5)
        k = ops.rmsnorm(k, ks, backend=backend, eps=1e-5)
    if x_kv is None:
        q, k = _rope(cfg, q, k, positions)
    slopes = None
    if cfg.pos_kind == "alibi" and not full:
        slopes = _slopes_on(cfg.num_heads, x.device)[q0:q0 + q.shape[2]]
    flash = dict(causal=not full, backend=backend, window=0 if full else cfg.sliding_window,
                 alibi_slopes=slopes)
    if placed:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **flash)
        y = C.reduce_from(F.linear(out.reshape(B, Sq, -1), p.o.weight), m, site=f"{site}.ar")
        return (y if p.o.bias is None else y + p.o.bias), None

    new_cache = None
    if cache is None:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **flash)
    else:
        ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
        W, t = ck.shape[1], cache["pos"]
        if Sq == 1:
            if not torch.is_tensor(t) and t >= W and not _ring(cfg, W):
                raise ValueError(f"KV cache of {W} slots cannot take 1 more at position {t}")
            rows = t if torch.is_tensor(t) else torch.full((B,), t, device=ck.device)
            return _decode_rows(p, cfg, q, k, v, cache, rows, N, G, h), dict(cache, pos=t + 1)
        if torch.is_tensor(t):
            raise NotImplementedError(
                f"prefill into a cache at per-row positions arrives with {QUERY_OFFSET}")
        if t != 0:
            raise NotImplementedError(
                f"prefill into a non-empty cache (pos {t}) arrives with {QUERY_OFFSET}")
        if Sq > W:
            raise ValueError(f"KV cache of {W} slots cannot take {Sq} more at position {t}")
        ck[:, :Sq] = k.to(ck.dtype)
        cv[:, :Sq] = v.to(cv.dtype)
        # slot_pos is per-sequence (B, W): the serving engine invalidates each
        # row's right-padded prefill slots independently (slot_pos = -1)
        spos[:, :Sq] = torch.arange(Sq, dtype=spos.dtype, device=spos.device)
        new_cache = {"k": ck, "v": cv, "pos": Sq, "slot_pos": spos}
        # attend to the keys as stored in the cache, as the reference does
        kc = k.to(ck.dtype).to(q.dtype).contiguous()
        vc = v.to(cv.dtype).to(q.dtype).contiguous()
        out = ops.flash_attention(q.contiguous(), kc, vc, **flash)
    return linear(p.o, out.reshape(B, Sq, N * G * h)), new_cache


def _rope(cfg, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor):
    """RoPE or M-RoPE on q and k where the config has them, else both as they are."""
    if cfg.pos_kind not in ("rope", "mrope"):
        return q, k
    return apply_rope(q, k, positions, head_dim=cfg.head_dim, fraction=cfg.rope_fraction,
                      theta=cfg.rope_theta,
                      mrope_sections=cfg.mrope_sections if cfg.pos_kind == "mrope" else ())


def _decode_rows(p: Attention, cfg, q, k, v, cache: Cache, t: torch.Tensor,
                 N: int, G: int, h: int):
    """Decode at per-row positions t (B,): row b writes its K/V and
    ``slot_pos`` at its own position (slot ``t % W`` in a ring) and attends
    to the slots whose ``slot_pos`` lies in [0, that position] and in its
    window.  Returns the attention output (B, 1, d)."""
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    B = q.shape[0]
    rows = torch.arange(B, device=ck.device)
    slot = t % ck.shape[1] if _ring(cfg, ck.shape[1]) else t
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    spos[rows, slot] = t.to(spos.dtype)
    bias = _decode_bias(cfg, spos, t.to(spos.dtype)[:, None], N, G)
    out = _gqa_scores_to_out(q.view(B, 1, N, G, h), ck, cv, bias, 1.0 / math.sqrt(h))
    return linear(p.o, out.reshape(B, 1, N * G * h))


def init_kv_cache(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                  device=None) -> Cache:
    """Pre-allocated decode cache: k, v (B,W,Hkv,h), slot_pos (B,W) int32
    (-1 = empty), and ``pos`` (tokens so far) as a Python int.  A
    sliding-window model keeps W = min(seq_len, window) slots, as the
    reference does."""
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
        "slot_pos": torch.full((batch, W), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2's multi-head latent attention
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """MLA's projections (no biases): ``q`` (d -> H·(dn+dr)), or with
    ``q_lora_rank`` ``q_a`` (d -> r_q), its RMSNorm ``q_a_norm`` and ``q_b``
    (r_q -> H·(dn+dr)); ``kv_a`` (d -> kv_lora_rank + dr), the RMSNorm
    ``kv_a_norm`` over the latent, ``kv_b`` (kv_lora_rank -> H·(dn+dv)) and
    ``o`` (H·dv -> d): the reference's ``init_mla`` keys."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, H = cfg.d_model, cfg.num_heads
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            self.q_a = nn.Linear(d, cfg.q_lora_rank, **kw)
            self.q_a_norm = Norm(cfg.q_lora_rank, "rmsnorm", device=device, dtype=dtype)
            self.q_b = nn.Linear(cfg.q_lora_rank, H * qk, **kw)
        else:
            self.q = nn.Linear(d, H * qk, **kw)
        self.kv_a = nn.Linear(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw)
        self.kv_a_norm = Norm(cfg.kv_lora_rank, "rmsnorm", device=device, dtype=dtype)
        self.kv_b = nn.Linear(cfg.kv_lora_rank,
                              H * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw)
        self.o = nn.Linear(H * cfg.v_head_dim, d, **kw)


# profiler ranges around MLA's plain attention: ``kv_b``'s expansion of the
# latents to K and V, and the scores with their softmax and product with V
MLA_EXPAND, MLA_SCORES = "mla.kv_b", "mla.scores"


@torch.profiler.record_function(MLA_SCORES)
def _mla_scores_to_out(q_nope, q_rope, k_nope, k_rope, v, bias, scale) -> torch.Tensor:
    """Dense MLA attention: q_nope (B,Sq,H,dn), q_rope (B,Sq,H,dr), k_nope
    (B,Sk,H,dn), k_rope (B,Sk,1,dr) (one rotary key for every head), v
    (B,Sk,H,dv); bias broadcastable to (B,H,Sq,Sk), additive, fp32.
    Returns (B,Sq,H,dv) in the query's dtype."""
    logits = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bsxd->bhqs", q_rope.float(), k_rope.float())) * scale
    w = torch.softmax(logits + bias, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", w, v.float()).to(q_nope.dtype)


def _causal_bias(Sq: int, Sk: int, device) -> torch.Tensor:
    """(Sq, Sk) fp32: 0 where key index <= query index, NEG_INF elsewhere."""
    keep = torch.arange(Sq, device=device)[:, None] >= torch.arange(Sk, device=device)[None]
    return torch.zeros((Sq, Sk), dtype=torch.float32, device=device).masked_fill(~keep, NEG_INF)


@torch.profiler.record_function(MLA_SCORES)
def _mla_blockwise(q_nope, q_rope, k_nope, k_rope, v, scale, kv_block: int,
                   q_block: int = 512) -> torch.Tensor:
    """Causal MLA over blocks of ``q_block`` queries and ``kv_block`` keys
    with an online softmax (the reference's ``_mla_blockwise``): never more
    than one block pair's scores.  A key block wholly after a query block
    is skipped: its every score is masked, and adds exactly nothing."""
    B, Sq, H, _ = q_nope.shape
    Sk, dv = k_nope.shape[1], v.shape[-1]
    out = q_nope.new_empty((B, Sq, H, dv))
    for q0 in range(0, Sq, q_block):
        qn, qr = q_nope[:, q0:q0 + q_block].float(), q_rope[:, q0:q0 + q_block].float()
        qb = qn.shape[1]
        q_pos = torch.arange(q0, q0 + qb, device=qn.device)
        m = torch.full((B, H, qb), NEG_INF, dtype=torch.float32, device=qn.device)
        l = torch.zeros((B, H, qb), dtype=torch.float32, device=qn.device)
        acc = torch.zeros((B, H, qb, dv), dtype=torch.float32, device=qn.device)
        for s0 in range(0, min(Sk, q0 + qb), kv_block):
            kn, kr = k_nope[:, s0:s0 + kv_block].float(), k_rope[:, s0:s0 + kv_block].float()
            k_pos = torch.arange(s0, s0 + kn.shape[1], device=qn.device)
            logits = (torch.einsum("bqhd,bshd->bhqs", qn, kn)
                      + torch.einsum("bqhd,bsxd->bhqs", qr, kr)) * scale
            logits = logits.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            pw = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pw.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", pw, v[:, s0:s0 + kv_block].float())
            m = m_new
        out[:, q0:q0 + qb] = (acc / torch.clamp(l, min=1e-20)[..., None]).transpose(1, 2)
    return out


def mla_attention(p: MLA, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                  cache: Optional[Cache] = None, backend: Optional[str] = None,
                  kv_block: int = 1024, blockwise_threshold: int = 2048,
                  mesh=None, site: str = "tp.attn",
                  ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """MLA with the compressed cache (the reference's ``mla_attention``):
    per token the cache holds the normed latent ``c_kv`` (kv_lora_rank
    wide) and one rotary key ``k_rope`` (dr), not per-head K and V.  The
    latent's RMSNorm (``kv_a_norm``, and ``q_a_norm`` where there is a q
    LoRA) goes through ``kernels.ops``; the scores are plain PyTorch, as
    the reference's are jnp.  Returns (out, updated cache).

    * ``cache`` None -> causal over the sequence, dense or, above
      ``blockwise_threshold`` keys, blockwise (``_mla_blockwise``).
    * ``cache`` given, Sq > 1 -> prefill into an empty cache (``pos`` 0):
      the latents, rotary keys and ``slot_pos`` written at slots 0..Sq-1,
      attention causal over them, as stored (over an empty cache the
      reference's ``slot_pos`` mask is that causal mask).
    * ``cache`` given, Sq == 1 -> decode at ``pos``, one int or a (B,)
      tensor of per-row positions: each row writes its slot, ``kv_b``
      expands every slot of the cache to K and V (the reference's method:
      the whole cache, each step), and the per-row ``slot_pos`` mask keeps
      the slots at or before the row's position.

    The cache is updated in place; the returned dict holds the same
    tensors and the advanced ``pos``.

    Placed over the model axis ``mesh`` (``models.model.shard_``: ``p``
    holds this rank's rows of ``q`` (or ``q_b``) and ``kv_b`` and its
    columns of ``o``, all head-major, so a contiguous share is whole heads)
    the rank computes its heads: x enters through ``copy_to``
    (``{site}.ar.bwd``), and so do the whole ``kv_a``, ``kv_a_norm`` (and
    ``q_a``, ``q_a_norm``) weights (``{site}.kv.ar.bwd``), whose gradients
    each rank holds a share of; its heads' scores, its rows of ``o``'s
    product and their sum over the ranks (``collectives.reduce_from`` at
    ``{site}.ar``).  A placed MLA serves no cache."""
    check_attention_supported(cfg)
    B, Sq, _ = x.shape
    rank = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = p.o.weight.shape[1] // dv                               # this rank's heads
    placed = H != cfg.num_heads
    whole = _identity
    if placed:
        m = as_mesh(mesh)
        if cache is not None:
            raise ValueError("MLA split over 'model' serves no cache: the engines serve "
                             "whole models (ROADMAP.md, queue 1 item 8)")
        if m.size * H != cfg.num_heads:
            raise ValueError(f"MLA holds {H} of {cfg.num_heads} heads: run it on its "
                             "model axis")
        q_rows = (p.q_b if cfg.q_lora_rank else p.q).weight.shape[0]
        assert q_rows == H * (dn + dr) and p.kv_b.weight.shape[0] == H * (dn + dv), \
            "MLA's q and kv_b split by whole heads"
        x = C.copy_to(x, m, site=f"{site}.ar.bwd")

        def whole(t):
            return C.copy_to(t, m, site=f"{site}.kv.ar.bwd")
    if cfg.q_lora_rank:
        qa = F.linear(x, whole(p.q_a.weight))
        q = linear(p.q_b, ops.rmsnorm(qa, whole(p.q_a_norm.scale), backend=backend,
                                      eps=1e-5))
    else:
        q = linear(p.q, x)
    q = q.view(B, Sq, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = F.linear(x, whole(p.kv_a.weight))                    # (B,S,rank+dr)
    c_kv = ops.rmsnorm(kv_a[..., :rank].contiguous(), whole(p.kv_a_norm.scale),
                       backend=backend, eps=1e-5)
    k_rope = kv_a[..., rank:][:, :, None, :]                    # (B,S,1,dr)
    q_rope, k_rope = apply_rope(q_rope, k_rope, positions, head_dim=dr, fraction=1.0,
                                theta=cfg.rope_theta)
    scale = 1.0 / math.sqrt(dn + dr)

    def expand(c):
        with torch.profiler.record_function(MLA_EXPAND):
            kv = linear(p.kv_b, c).view(B, c.shape[1], H, dn + dv)
        return kv[..., :dn], kv[..., dn:]

    new_cache = None
    if cache is None:
        k_nope, v = expand(c_kv)
        if Sq > blockwise_threshold:
            out = _mla_blockwise(q_nope, q_rope, k_nope, k_rope, v, scale, kv_block)
        else:
            out = _mla_scores_to_out(q_nope, q_rope, k_nope, k_rope, v,
                                     _causal_bias(Sq, Sq, x.device), scale)
    else:
        cc, cr, spos = cache["c_kv"], cache["k_rope"], cache["slot_pos"]
        W, t = cc.shape[1], cache["pos"]
        if Sq == 1:
            if not torch.is_tensor(t) and t >= W:
                raise ValueError(f"MLA cache of {W} slots cannot take 1 more at position {t}")
            rows_t = t if torch.is_tensor(t) else torch.full((B,), t, device=cc.device)
            rows = torch.arange(B, device=cc.device)
            cc[rows, rows_t] = c_kv[:, 0].to(cc.dtype)
            cr[rows, rows_t] = k_rope[:, 0].to(cr.dtype)
            spos[rows, rows_t] = rows_t.to(spos.dtype)
            k_nope, v = expand(cc.to(x.dtype))
            valid = (spos >= 0) & (spos <= rows_t.to(spos.dtype)[:, None])       # (B, W)
            bias = torch.zeros(valid.shape, dtype=torch.float32, device=x.device
                               ).masked_fill(~valid, NEG_INF)[:, None, None, :]
            out = _mla_scores_to_out(q_nope, q_rope, k_nope, cr.to(x.dtype), v, bias, scale)
            new_cache = dict(cache, pos=t + 1)
        else:
            if torch.is_tensor(t):
                raise NotImplementedError(
                    f"prefill into a cache at per-row positions arrives with {QUERY_OFFSET}")
            if t != 0:
                raise NotImplementedError(
                    f"prefill into a non-empty cache (pos {t}) arrives with {QUERY_OFFSET}")
            if Sq > W:
                raise ValueError(f"MLA cache of {W} slots cannot take {Sq} more at position {t}")
            cc[:, :Sq] = c_kv.to(cc.dtype)
            cr[:, :Sq] = k_rope.to(cr.dtype)
            spos[:, :Sq] = torch.arange(Sq, dtype=spos.dtype, device=spos.device)
            new_cache = {"c_kv": cc, "k_rope": cr, "pos": Sq, "slot_pos": spos}
            k_nope, v = expand(cc[:, :Sq].to(x.dtype))
            out = _mla_scores_to_out(q_nope, q_rope, k_nope, cr[:, :Sq].to(x.dtype), v,
                                     _causal_bias(Sq, Sq, x.device), scale)
    if placed:
        return C.reduce_from(linear(p.o, out.reshape(B, Sq, H * dv)), m,
                             site=f"{site}.ar"), None
    return linear(p.o, out.reshape(B, Sq, H * dv)), new_cache


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def init_mla_cache(cfg, batch: int, seq_len: int, *, dtype=torch.float32,
                   device=None) -> Cache:
    """MLA's decode cache: c_kv (B,W,kv_lora_rank), k_rope (B,W,1,dr),
    slot_pos (B,W) int32 (-1 = empty) and ``pos`` a Python int."""
    return {
        "c_kv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, seq_len, 1, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "pos": 0,
        "slot_pos": torch.full((batch, seq_len), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# feed-forward and embeddings
# ---------------------------------------------------------------------------

MLP_KINDS = ("swiglu", "gelu")


class MLP(nn.Module):
    """SwiGLU feed-forward: gate, up (d -> d_ff) and down (d_ff -> d), no
    biases; or GELU: up and down, each with a bias (the reference's
    ``init_mlp``)."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device=None, dtype=None):
        super().__init__()
        if kind not in MLP_KINDS:
            raise ValueError(f"unknown mlp_kind {kind!r}; known: {MLP_KINDS}")
        kw = dict(bias=kind == "gelu", device=device, dtype=dtype)
        if kind == "swiglu":
            self.gate = nn.Linear(d_model, d_ff, **kw)
        self.up = nn.Linear(d_model, d_ff, **kw)
        self.down = nn.Linear(d_ff, d_model, **kw)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (the exact erf form is
    another function: it misses the reference by more than 1e-4)."""
    return F.gelu(x, approximate="tanh")


def mlp(p: MLP, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp_kind {kind!r}; known: {MLP_KINDS}")
    if kind == "gelu":
        return linear(p.down, gelu(linear(p.up, x)))
    return linear(p.down, F.silu(linear(p.gate, x)) * linear(p.up, x))


# ---------------------------------------------------------------------------
# mixture of experts (capacity-based scatter dispatch)
# ---------------------------------------------------------------------------

def moe_pad_experts(num_experts: int, ep_size: int) -> int:
    """Experts padded up to a multiple of the expert-parallel axis (e.g.
    qwen2-moe's 60 -> 64 on a 16-way axis).  The router has only the real
    experts' logits, so padded experts never receive a token."""
    return ((num_experts + ep_size - 1) // ep_size) * ep_size


class MoE(nn.Module):
    """Routed experts: ``router`` (d -> the real expert count, fp32, no
    bias); ``gate``, ``up`` (E, d, f) and ``down`` (E, f, d), E padded by
    ``ep_pad`` (``moe_pad_experts``), multiplied as ``x @ W`` (the
    reference's layout, not ``nn.Linear``'s); optional shared experts
    ``shared`` (a SwiGLU ``MLP``) and their ``shared_gate`` (d -> 1).
    ``experts`` is E: on a model placed over ``model`` the tensors hold
    this rank's E / n experts and ``experts`` stays E."""

    def __init__(self, cfg, *, ep_pad: int = 1, device=None, dtype=None):
        super().__init__()
        E = moe_pad_experts(cfg.num_experts, ep_pad)
        d, f = cfg.d_model, cfg.moe_d_ff
        kw = dict(device=device, dtype=dtype)
        self.experts = E
        self.router = nn.Linear(d, cfg.num_experts, bias=False, device=device,
                                dtype=torch.float32)
        self.gate = nn.Parameter(torch.empty((E, d, f), **kw))
        self.up = nn.Parameter(torch.empty((E, d, f), **kw))
        self.down = nn.Parameter(torch.empty((E, f, d), **kw))
        if cfg.num_shared_experts:
            sf = cfg.shared_d_ff or cfg.moe_d_ff * cfg.num_shared_experts
            self.shared = MLP(d, sf, "swiglu", **kw)
            if cfg.shared_expert_gate:
                self.shared_gate = nn.Linear(d, 1, bias=False, **kw)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scheme: ``gate`` and ``up`` N(0, 1/d), ``down``
        N(0, 1/f) (the linears are drawn by ``models.model``)."""
        d, f = self.gate.shape[1], self.gate.shape[2]
        self.gate.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.up.normal_(0.0, 1.0 / math.sqrt(d), generator=gen)
        self.down.normal_(0.0, 1.0 / math.sqrt(f), generator=gen)


class Routing:
    """The experts each ``moe_block`` call chose (its ``top_e``), by site in
    call order: recorded, or replayed into another run of the same calls
    (``record_routing``)."""

    def __init__(self):
        self.calls: Dict[str, list] = {}
        self._next: Dict[str, int] = {}

    def replay(self, site: str, rows: Optional[slice]) -> torch.Tensor:
        k = self._next.get(site, 0)
        self._next[site] = k + 1
        top_e = self.calls[site][k]
        return top_e if rows is None else top_e[rows]


_ROUTING: contextvars.ContextVar = contextvars.ContextVar("repro_torch_routing",
                                                          default=None)


@contextlib.contextmanager
def record_routing(replay: Optional[Routing] = None, rows: Optional[slice] = None):
    """Record the experts every ``moe_block`` call in the ``with`` block
    chooses (yields the ``Routing``); with ``replay``, each call takes them
    from that record instead (the k-th call at a site the k-th recorded
    there; ``rows`` the slice of its tokens, for a data rank replaying a
    whole batch's record), its combine weights its own probabilities at
    those experts.  Comparisons of two runs of one model whose numbers
    differ in the last bits (the kernels against their plain versions, four
    ranks against one card) force the discrete routing equal, as they
    force the tokens equal; the gap between two candidate experts' router
    probabilities can be smaller than those bits."""
    rec = Routing() if replay is None else replay
    rec._next = {}                     # each replay starts at every site's first call
    token = _ROUTING.set((rec, replay is not None, rows))
    try:
        yield rec
    finally:
        _ROUTING.reset(token)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, largest first, the lower index
    first among equals (``lax.top_k``'s order: the order of a token's k
    slots sets their positions in the capacity buffers)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts_ffn(b: torch.Tensor, gate, up, down) -> torch.Tensor:
    """SwiGLU of each expert over its rows: b (E, c, d) -> (E, c, d)."""
    return torch.bmm(F.silu(torch.bmm(b, gate)) * torch.bmm(b, up), down)


def _local_experts(p, E: int, m) -> Tuple[torch.Tensor, ...]:
    """(gate, up, down) of this rank's E / n experts: ``p``'s own when it
    holds a shard (a placed model's), else views of its rows (a served
    model's whole experts: rows ``r·E/n ... (r+1)·E/n``, no copy)."""
    el = E // m.size
    ws = (p.gate, p.up, p.down)
    if ws[0].shape[0] == el:
        return ws
    return tuple(w.narrow(0, m.rank * el, el) for w in ws)


def _moe_ffn_explicit(p, buf: torch.Tensor, E: int, mesh, *, site: str) -> torch.Tensor:
    """The expert FFN with the dispatch and combine all-to-alls explicit,
    over the ``model`` mesh: this rank's slice of the buffer's capacity
    slots (``shard_rows``) goes through a chunked all-to-all at
    ``{site}.a2a_disp``, (E, cap/n, D) -> (E/n, cap, D); the local experts'
    three products run as batched GEMMs; a chunked all-to-all at
    ``{site}.a2a_comb`` takes (E/n, cap, D) back to (E, cap/n, D), and the
    slices are gathered back (``all_gather_rows``), where GSPMD gathers
    them in the reference.  Chunk counts resolve per site against the
    active plan; numerically the plain expert FFN."""
    m = as_mesh(mesh)
    b = C.chunked_all_to_all(C.shard_rows(buf, m), m, split_axis=0, concat_axis=1,
                             site=f"{site}.a2a_disp")
    y = _experts_ffn(b, *_local_experts(p, E, m))
    y = C.chunked_all_to_all(y, m, split_axis=1, concat_axis=0, site=f"{site}.a2a_comb")
    return C.all_gather_rows(y, m)


def _moe_ffn_degraded(p, buf: torch.Tensor, E: int, mesh) -> torch.Tensor:
    """The expert FFN when the buffer does not split over the mesh (the
    reference's GSPMD expert layout): with the experts split over the
    ranks, each computes its experts' rows of the replicated buffer and
    the rows are gathered over the expert axis; with every expert whole on
    every rank (n does not divide E), each computes them all."""
    m = as_mesh(mesh)
    if E % m.size:
        return _experts_ffn(buf, p.gate, p.up, p.down)
    _, c, d = buf.shape
    mine = C.shard_rows(buf.view(E, c * d), m).view(E // m.size, c, d)
    y = _experts_ffn(mine, *_local_experts(p, E, m))
    return C.all_gather_rows(y.reshape(-1, c * d), m).view(E, c, d)


def moe_block(p, cfg, x: torch.Tensor, *, capacity_factor: Optional[float] = None,
              experts: Optional[int] = None, mesh=None, data=None, site: str = "moe",
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity-bounded scatter dispatch and
    optional shared experts: x (B, S, D) -> (out (B, S, D), aux), as the
    reference's ``moe_block``.

    The router's softmax over the real experts, the top k, renormalised;
    the Switch load-balancing loss ``aux``; each (token, slot)'s position
    in its expert by a cumsum over the flat T·k order; the capacity
    ``cap = max(1, int(T·k·cf / E_real))``; the scatter into (E, cap, D)
    by ``index_add`` (an add: overflow rows are clipped onto the last slot
    with zeroed values, which must not overwrite the token that holds it),
    the experts, and the gather that combines each token's k slots.

    ``experts`` is the padded expert count E (default: ``p.gate``'s rows,
    the whole tensor).  ``mesh`` (the ``model`` axis) runs the explicit
    expert-parallel FFN at ``{site}.a2a_disp|comb``; where n does not
    divide E or cap, the site warns once (``warn_degraded``) and the
    degraded layout runs, numerically the same.  ``data`` (the data axis
    of a model trained on (data, model)) routes the global batch, as
    GSPMD's global arrays do in the reference: the per-expert counts are
    all-gathered over ``data`` for each rank's offsets, ``cap`` comes from
    the global T, and the statistics of ``aux`` are summed over ``data``
    (``collectives.sum_over``).  Each rank's buffer holds its own tokens
    at their global slots.  ``groups`` routes each of that many equal
    runs of rows alone, with its own capacity (the continuous engine's
    slots, which the reference vmaps over); their buffers lie side by side
    along the capacity axis, and ``aux`` is the groups' mean.  Shared
    experts split over ``mesh`` (a placed model's) run column-then-row,
    their partial outputs summed at ``{site}.shared.ar``
    (``collectives.reduce_from``) before the shared gate, which is whole,
    multiplies them."""
    B, S, D = x.shape
    T = B * S
    E_real, k = cfg.num_experts, cfg.top_k
    E = p.gate.shape[0] if experts is None else experts
    cf = capacity_factor or cfg.capacity_factor
    dm = as_mesh(data)
    if groups > 1 and dm.size > 1:
        raise ValueError("routing groups of rows and a data axis do not combine")
    G, Tg = groups, T // groups
    T_all = Tg * dm.size                    # the tokens one routing sees
    cap = max(1, int(T_all * k * cf / E_real))
    xt = x.reshape(T, D)

    probs = torch.softmax(linear(p.router, xt.float()), dim=-1)      # (T, E_real)
    top_p, top_e = _top_k(probs, k)
    routing = _ROUTING.get()
    if routing is not None:
        rec, replaying, rows = routing
        if replaying:
            top_e = rec.replay(site, rows).to(top_e.device)
            top_p = probs.gather(-1, top_e)
        else:
            rec.calls.setdefault(site, []).append(top_e.detach())
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(G, Tg * k)
    # the one-hot laid out (G, E, Tg·k): the cumsum runs along the innermost
    # dim (along the outer one, a scan over 32k rows of 64 took 6.6 ms)
    seen = (flat_e[:, None, :] == torch.arange(E, device=x.device)[:, None]).cumsum(-1)
    counts = seen[:, :, -1]                                          # (G, E)
    pos = seen.gather(1, flat_e[:, None, :])[:, 0] - 1               # (G, Tg·k)
    del seen
    me = probs.view(G, Tg, E_real).mean(1)
    if dm.size > 1:                         # the global batch's routing
        every = C.gather_full(counts[0], dm, 0).view(dm.size, E)
        pos = pos + every[:dm.rank].sum(0)[flat_e]
        counts = every.sum(0, keepdim=True)
        me = C.sum_over(me, dm) / dm.size
    ce = counts[:, :E_real].float() / (T_all * k)
    aux = (E_real * torch.sum(me * ce, dim=-1)).mean()

    keep = pos < cap
    row = torch.clamp(flat_e * cap + pos, 0, E * cap - 1)           # within a group
    if G > 1:         # group g's slot c of expert e at e·G·cap + g·cap + c
        gi = torch.arange(G, device=x.device)[:, None]
        row = (row // cap) * (G * cap) + gi * cap + row % cap
    row, keep = row.reshape(-1), keep.reshape(-1)
    vals = xt.repeat_interleave(k, dim=0) * keep[:, None].to(x.dtype)
    buf = x.new_zeros((E * G * cap, D)).index_add(0, row, vals).view(E, G * cap, D)
    del vals

    n = as_mesh(mesh).size if mesh is not None else 1
    if mesh is not None and (E % n or cap % n):
        C.warn_degraded(site, f"expert buffer (E={E}, cap={cap}) is not divisible by the "
                              f"'model' axis ({n}); using the GSPMD expert layout instead "
                              "of explicit all-to-alls", stacklevel=3)
        y = _moe_ffn_degraded(p, CT.ecd(buf), E, mesh)
    elif mesh is not None:
        y = _moe_ffn_explicit(p, buf, E, mesh, site=site)
    else:
        y = _experts_ffn(CT.ecd(buf), p.gate, p.up, p.down)

    gathered = y.reshape(-1, D).index_select(0, row)                 # (T·k, D)
    w = (top_p.reshape(-1) * keep).to(x.dtype)
    out = (gathered * w[:, None]).view(T, k, D).sum(dim=1)
    shared = getattr(p, "shared", None)
    if shared is not None:
        split = shared.up.weight.shape[0] < (cfg.shared_d_ff
                                             or cfg.moe_d_ff * cfg.num_shared_experts)
        m = as_mesh(mesh if split else None)      # a placed model's shards
        sh = C.reduce_from(mlp(shared, C.copy_to(xt, m, site=f"{site}.shared.ar.bwd"),
                               "swiglu"), m, site=f"{site}.shared.ar")
        gate = getattr(p, "shared_gate", None)
        if gate is not None:
            sh = sh * torch.sigmoid(linear(gate, xt))
        out = out + sh
    return out.view(B, S, D), aux
