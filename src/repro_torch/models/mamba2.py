"""Mamba2 (SSD) block of the port (PyTorch counterpart of
``repro.models.mamba2``): a scalar-identity state space with a chunked
scan, used by the zamba2 hybrid trunk.

The inner recurrence runs through ``kernels.ops.ssd`` (the CUDA SSD kernel
on the card, its plain versions on the CPU) and the gated inner norm
through ``kernels.ops.rmsnorm``.  The depthwise causal convolution is plain
PyTorch, as the reference's is plain jnp.  Linear weights are
``nn.Linear``'s (d_out, d_in); the other leaves keep the reference's
names and shapes (``conv_w`` (K, C), ``A_log``, ``D``, ``dt_bias`` (H,)).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]


def d_inner(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def head_p(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_heads


def conv_channels(cfg) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_groups * cfg.ssm_state


class Block(nn.Module):
    """Separate z / conv-input / dt projections (as the reference keeps them),
    the depthwise conv, the SSD parameters, the gated RMSNorm and out_proj."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        D, din = cfg.d_model, d_inner(cfg)
        G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        kw = dict(device=device, dtype=dtype)
        self.z_proj = nn.Linear(D, din, bias=False, **kw)
        self.xbc_proj = nn.Linear(D, din + 2 * G * N, bias=False, **kw)
        self.dt_proj = nn.Linear(D, H, bias=False, **kw)
        self.conv_w = nn.Parameter(torch.empty(cfg.conv_kernel, conv_channels(cfg), **kw))
        self.conv_b = nn.Parameter(torch.empty(conv_channels(cfg), **kw))
        f32 = dict(device=device, dtype=torch.float32)   # fp32 whatever the model dtype
        self.A_log = nn.Parameter(torch.empty(H, **f32))
        self.D = nn.Parameter(torch.empty(H, **f32))
        self.dt_bias = nn.Parameter(torch.empty(H, **f32))
        self.norm = L.Norm(din, "rmsnorm", **kw)
        self.out_proj = nn.Linear(din, D, bias=False, **kw)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scheme for the leaves that are not linears or norms."""
        K, H = self.conv_w.shape[0], self.A_log.shape[0]
        self.conv_w.normal_(0.0, 1.0 / math.sqrt(K), generator=gen)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H, device=self.A_log.device)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xBC (B,S,C), w (K,C).  ``conv_state``
    (B,K-1,C) carries the previous K-1 inputs (decode).  Returns
    (silu(conv), new carry)."""
    Kk = w.shape[0]
    if conv_state is None:
        conv_state = xBC.new_zeros((xBC.shape[0], Kk - 1, xBC.shape[2]))
    xp = torch.cat([conv_state, xBC], dim=1)                   # (B,S+K-1,C)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(Kk)) + b
    return F.silu(out), xp[:, -(Kk - 1):]


def block_fwd(p: Block, cfg, x: torch.Tensor, cache: Optional[Cache], *,
              backend: Optional[str] = None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """cache: {"conv": (B,K-1,C), "state": (B,H,P,N) fp32} or None.  Returns
    (out, new cache or None).  The cache's SSD state is updated in place (the
    new cache holds that same tensor); the conv carry is a new tensor, and
    the cache's own carry is left as it was."""
    B, S, _ = x.shape
    din = d_inner(cfg)
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = head_p(cfg)

    z = L.linear(p.z_proj, x)
    xBC = L.linear(p.xbc_proj, x)
    dt = L.linear(p.dt_proj, x)
    xBC, conv_state = _causal_conv(xBC, p.conv_w, p.conv_b,
                                   cache["conv"] if cache is not None else None)
    # views of the conv output, B and C per group: the SSD kernel reads them
    # in place (the plain versions expand the groups themselves)
    xs, Bm, Cm = torch.split(xBC, [din, G * N, G * N], dim=-1)
    xs = xs.unflatten(-1, (H, P))
    Bm = Bm.unflatten(-1, (G, N))
    Cm = Cm.unflatten(-1, (G, N))
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    state = cache["state"] if cache is not None else None
    y, new_state = ops.ssd(xs, dt, A, Bm, Cm, p.D, state, out_state=state, backend=backend)
    y = y.reshape(B, S, din)
    y = L.norm(p.norm, y * F.silu(z), "rmsnorm", backend=backend)
    out = L.linear(p.out_proj, y)
    new_cache = {"conv": conv_state, "state": new_state} if cache is not None else None
    return out, new_cache


def init_cache(cfg, batch: int, *, dtype=torch.float32, device=None) -> Cache:
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_channels(cfg)),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, head_p(cfg), cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }
