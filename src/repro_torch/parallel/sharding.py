"""Sharding rules of the port (counterpart of ``repro.parallel.sharding``):
which mesh axis splits which dim of each parameter, batch and decode cache.

The rules are the reference's, copied: every matrix shards its
"feature-parallel" dim over the ``model`` axis (attention heads, FFN
hidden, experts, vocab) and its other dim over the FSDP axes (``data``);
1-D leaves (norm scales) are replicated; a dim that an axis does not divide
stays whole on that axis (the per-dim fallback).  Templates use ``F`` for
the fsdp axes and ``T`` for ``model``; a rule's spec matches the *trailing*
dims of the array, and stacked leading dims are replicated (None).

Where the reference takes a pytree and a ``jax.sharding.Mesh`` and returns
``PartitionSpec``s, these take ``{key path: shape}`` (the reference's
paths, ``"trunk/dense_layers/attn/q/w"``) and ``{axis: size}``, and return
one tuple a path: the spec's entries, ``()`` for a replicated leaf.  A mesh
without the ``model`` axis raises ``ValueError`` (the reference raises
``KeyError: 'model'``): pure FSDP over D ranks is the mesh ``Dx1``.

The port's layout (``port_specs``): its state dict unstacks the layers and
holds linear weights as ``nn.Linear``'s (d_out, d_in), so a reference
spec maps onto a port leaf by dropping the stacked dims and, for ``w``
leaves, reversing it (``convert.reference_layout`` gives each leaf's
reference path, shape and both facts).  The F dim is then dim 1 of
``attn.{q,k,v}.weight``, ``mlp.{gate,up}.weight``, ``head.weight`` and
``embed.weight``, and dim 0 of ``attn.o.weight`` and ``mlp.down.weight``;
the experts' ``moe.gate``, ``moe.up`` (E, d, f) and ``moe.down`` (E, f,
d) keep the reference's layout, E their T dim.

``Placement`` is what a model placed on a mesh holds (``models.model.
shard_``): each leaf's spec in the port's layout and the ``launch.mesh.
Mesh`` of each axis.  Its F dims are split over ``data``, and the T dims
of the leaves that the trainable families run (``TP_HELD``: attention's
q, k, v and o, whisper's self- and cross-attention's, MLA's q and
``kv_b``, the dense MLP, the shared and the routed experts, the embedding
and the head) over ``model``.  The unit of an attention split
is a head (``port_specs``' ``heads``): where the model axis divides the
query heads but not the KV heads, k and v stay whole on ``model``, and
where it does not divide the query heads (or a rank's block of them would
read two KV heads' groups in part), attention does; each case warns
once.  A leaf split over ``data`` is gathered where it is used
(``collectives.gather_param``, whose backward reduce-scatters its
gradient), so each rank keeps only its slice between uses; the model
axis's slices are used as slices.
"""
from __future__ import annotations

import math
import re
import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import as_mesh
from repro_torch.parallel.collectives import gather_full, gather_param

Spec = Tuple[Any, ...]

# (path regex, spec template applied to trailing dims)
# Templates: "F"->fsdp, "T"->model, None->replicated.
_RULES: Sequence[Tuple[str, Tuple[Any, ...]]] = (
    # embeddings / head
    (r"embed/table$",              ("T", "F")),
    (r"head/w$",                   ("F", "T")),
    (r"dec_pos$",                  ("F", None)),
    (r"enc_pos$",                  (None, None)),
    # attention (gqa)
    (r"attn/[qkv]/w$",             ("F", "T")),
    (r"attn/[qkv]/b$",             ("T",)),
    (r"attn/o/w$",                 ("T", "F")),
    (r"attn/o/b$",                 (None,)),
    (r"(self|cross)_attn/[qkv]/w$", ("F", "T")),
    (r"(self|cross)_attn/[qkv]/b$", ("T",)),
    (r"(self|cross)_attn/o/w$",    ("T", "F")),
    (r"(self|cross)_attn/o/b$",    (None,)),
    # attention (mla)
    (r"attn/q/w$",                 ("F", "T")),
    (r"attn/q_a/w$",               ("F", None)),
    (r"attn/q_b/w$",               (None, "T")),
    (r"attn/kv_a/w$",              ("F", None)),
    (r"attn/kv_b/w$",              (None, "T")),
    # mlps
    (r"(mlp|shared)/(gate|up)/w$", ("F", "T")),
    (r"(mlp|shared)/(gate|up)/b$", ("T",)),
    (r"(mlp|shared)/down/w$",      ("T", "F")),
    (r"(mlp|shared)/down/b$",      (None,)),
    # moe
    (r"moe/router/w$",             ("F", None)),
    (r"moe/(gate|up)$",            ("T", "F", None)),
    (r"moe/down$",                 ("T", None, "F")),
    (r"moe/shared_gate/w$",        (None, None)),
    # rwkv6 time-mix / channel-mix
    (r"tm/W[rkvg]$",               ("F", "T")),
    (r"tm/Wo$",                    ("T", "F")),
    (r"tm/maa_w1$",                ("F", None)),
    (r"tm/decay_w1$",              ("F", None)),
    (r"tm/decay_w2$",              (None, "F")),
    (r"tm/bonus$",                 ("T", None)),
    (r"cm/Wk$",                    ("F", "T")),
    (r"cm/Wv$",                    ("T", "F")),
    (r"cm/Wr$",                    ("F", "T")),
    # mamba2
    (r"mamba/(z_proj|xbc_proj)/w$", ("F", "T")),
    (r"mamba/dt_proj/w$",          ("F", None)),
    (r"mamba/out_proj/w$",         ("T", "F")),
    (r"mamba/conv_w$",             (None, "T")),
    (r"mamba/conv_b$",             ("T",)),
    # zamba2 per-application adapters
    (r"app_in/w$",                 ("F", "T")),
)

# the leaves whose T dim the port splits over ``model``: attention's q, k, v
# (and their biases) and o wherever they sit (``attn``, whisper's
# ``self_attn`` and ``cross_attn``), MLA's q, ``q_b`` and ``kv_b`` (its
# ``q_a`` and ``kv_a`` have no T dim), the dense MLP and the shared experts
# (the GELU MLP's up bias with them), the routed experts, the embedding and
# the head; only the recurrent families' T dims stay whole
_ATTN = r"(^|/)(self_|cross_)?attn/([qkv]/[wb]|(q_b|kv_b|o)/w)$"
_KV = r"(^|/)(self_|cross_)?attn/[kv]/[wb]$"
TP_HELD = (_ATTN + r"|(mlp|shared)/(gate|up|down)/w$|(mlp|shared)/up/b$"
           r"|moe/(gate|up|down)$|embed/table$|head/w$")
_WARNED: set = set()


def _warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def heads_of(cfg) -> Tuple[int, int]:
    """The (query, KV) head counts that attention splits by: MLA's every
    head has its own K and V rows of ``kv_b`` (H, H); GQA's the config's."""
    return (cfg.num_heads,
            cfg.num_heads if cfg.attn_kind == "mla" else cfg.num_kv_heads)


def _whole_attention(heads, m: int) -> Optional[str]:
    """The attention leaves that stay whole on a model axis of ``m`` ranks,
    by heads (a regex, or None): k and v where ``m`` divides the query
    heads but not the KV heads and each rank's query heads read one KV head
    (the query heads are laid out KV-head major), all of attention where
    ``m`` does not divide the query heads or a rank's block would read part
    of two groups (the reference's per-dim fallback would split inside a
    head; the port never does).  One rule for every attention of the
    model: GQA's, whisper's bidirectional and cross-attention (the same
    heads), MLA's (``heads_of``: its q·k and v heads differ in width, not
    in count, and each leaf is laid out head-major).  Warns once a case."""
    if m == 1:
        return None
    hq, hkv = heads
    if hq % m or (hkv % m and (hq // hkv) % (hq // m)):
        _warn_once(f"{hq} query heads over {hkv} KV heads do not split by whole heads over "
                   f"{m} model ranks: attention's q, k, v and o stay whole on 'model', "
                   "every rank computing all heads")
        return _ATTN
    if hkv % m:
        _warn_once(f"{hkv} KV heads do not split over {m} model ranks ({hq} query heads "
                   "do): k and v stay whole on 'model', each rank projecting the KV head "
                   "its query heads read")
        return _KV
    return None


def _expand(template, fsdp, tp):
    out = []
    for t in template:
        if t == "F":
            out.append(fsdp if len(fsdp) > 1 else fsdp[0])
        elif t == "T":
            out.append(tp)
        else:
            out.append(None)
    return tuple(out)


def _size(ax, mesh_shape) -> int:
    return math.prod(mesh_shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


def _check_axis(mesh_shape: Mapping[str, int], tp_axis) -> None:
    if tp_axis is not None and tp_axis not in mesh_shape:
        d = math.prod(mesh_shape.values())
        raise ValueError(f"the mesh {dict(mesh_shape)} has no {tp_axis!r} axis; pure FSDP "
                         f"over {d} data ranks is the mesh {d}x1 (--mesh {d}x1)")


def param_specs(shapes: Mapping[str, Sequence[int]], mesh_shape: Mapping[str, int], *,
                fsdp_axes: Tuple[str, ...] = ("data",),
                tp_axis: Optional[str] = "model") -> Dict[str, Spec]:
    """The spec of each parameter: ``shapes`` maps the reference's key paths
    to shapes, ``mesh_shape`` an axis name to its size."""
    _check_axis(mesh_shape, tp_axis)

    def one(pstr, shape):
        for rx, template in _RULES:
            if re.search(rx, pstr):
                spec = _expand(template, fsdp_axes, tp_axis)
                lead = len(shape) - len(spec)
                if lead < 0:
                    break
                full = (None,) * lead + spec
                # drop axes that don't divide evenly (fall back per-dim)
                return tuple(ax if ax is not None and shape[i] % _size(ax, mesh_shape) == 0
                             else None for i, ax in enumerate(full))
        return ()  # replicate (norms, scalars, loras)

    return {path: one(path, tuple(shape)) for path, shape in shapes.items()}


def batch_specs(cfg, shapes: Mapping[str, Optional[Sequence[int]]],
                mesh_shape: Mapping[str, int], *,
                dp_axes: Tuple[str, ...] = ("data",)) -> Dict[str, Optional[Spec]]:
    """Batch dim over the data-parallel axes when divisible, else replicate
    (a None leaf stays None)."""
    dp = _size(dp_axes, mesh_shape)
    dp_spec = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(shape):
        if shape is None:
            return None
        shape = tuple(shape)
        B = shape[0] if shape else 0
        lead = dp_spec if B and B % dp == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    return {path: one(shape) for path, shape in shapes.items()}


def cache_specs(cfg, shapes: Mapping[str, Sequence[int]], mesh_shape: Mapping[str, int], *,
                dp_axes: Tuple[str, ...] = ("data",),
                tp_axis: Optional[str] = "model") -> Dict[str, Spec]:
    """Decode-cache sharding.  Layout per leaf (after any stacked leading
    dims): KV caches (B, S, N, h) — batch over data when divisible else
    sequence over data; heads over model.  States (B, H, K, V) — heads over
    model.  Conv/shift small leaves: batch over data if divisible."""
    _check_axis(mesh_shape, tp_axis)
    dp = _size(dp_axes, mesh_shape)
    tp = mesh_shape[tp_axis] if tp_axis else 10**9   # None -> never divides
    dp_spec = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(pstr, shape):
        shape = tuple(shape)
        nd = len(shape)
        if nd == 0 or pstr.endswith("pos") or "slot_pos" in pstr:
            return ()
        spec = [None] * nd
        if re.search(r"(^|/)(k|v|c_kv|k_rope)$", pstr):
            # (..., B, S, N, h) or (..., B, S, rank)
            b_ax = nd - (4 if pstr.endswith(("k", "v", "k_rope")) else 3)
            s_ax = b_ax + 1
            if shape[b_ax] % dp == 0:
                spec[b_ax] = dp_spec
            elif shape[s_ax] % dp == 0:
                spec[s_ax] = dp_spec           # context parallelism (B too small)
            if pstr.endswith(("k", "v")) and shape[nd - 2] % tp == 0:
                spec[nd - 2] = tp_axis          # kv heads over model
            elif spec[s_ax] is None and shape[s_ax] % tp == 0:
                spec[s_ax] = tp_axis            # kv heads don't divide tp:
                                                # shard the sequence instead
            elif not pstr.endswith(("k", "v")) and shape[nd - 1] % tp == 0:
                spec[nd - 1] = tp_axis          # MLA latent rank over model
        elif re.search(r"(wkv|state)$", pstr):
            # (..., B, H, K/P, V/N)
            b_ax = nd - 4
            if shape[b_ax] % dp == 0:
                spec[b_ax] = dp_spec
            if shape[nd - 3] % tp == 0:
                spec[nd - 3] = tp_axis
        elif re.search(r"(shift_tm|shift_cm|conv|memory)$", pstr):
            b_ax = max(0, nd - 3)
            if shape[b_ax] % dp == 0:
                spec[b_ax] = dp_spec
            if shape[nd - 1] % tp == 0 and pstr.endswith("conv"):
                spec[nd - 1] = tp_axis
        return tuple(spec)

    return {path: one(path, shape) for path, shape in shapes.items()}


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RefLeaf:
    """Where a port parameter comes from in the reference's tree."""
    path: str                   # the reference's key path
    shape: Tuple[int, ...]      # its shape there, stacked layer axes included
    lead: int                   # stacked layer axes the port unstacks
    transposed: bool            # a ``w`` leaf: nn.Linear holds its transpose


def port_specs(layout: Mapping[str, RefLeaf], mesh_shape: Mapping[str, int], *,
               heads: Tuple[int, int]) -> Dict[str, Spec]:
    """``param_specs`` of the reference's leaves on the mesh ``{data,
    model}``, in the port's layout: one spec a state-dict name of
    ``layout`` (``convert.reference_layout``), one entry a dim of the
    port's tensor.  Only the leaves ``TP_HELD`` matches keep ``model``,
    and attention splits by whole heads of ``heads`` (the config's query
    and KV head counts) or stays whole (``_whole_attention``)."""
    ref = param_specs({leaf.path: leaf.shape for leaf in layout.values()}, mesh_shape)
    whole = _whole_attention(heads, mesh_shape.get("model", 1))
    out = {}
    for name, leaf in layout.items():
        spec = ref[leaf.path]
        spec = (spec + (None,) * (len(leaf.shape) - len(spec)))[leaf.lead:]
        if leaf.transposed:
            spec = spec[::-1]
        if not re.search(TP_HELD, leaf.path) or (whole and re.search(whole, leaf.path)):
            spec = tuple(None if ax == "model" else ax for ax in spec)
        out[name] = spec
    return out


@dataclass
class Placement:
    """A placed model's record: ``specs[name]`` names the mesh axis (or
    None) that splits each dim of the parameter ``name`` in the port's
    layout; ``meshes[axis]`` is this rank's ``launch.mesh.Mesh`` of that
    axis.  An axis absent from ``meshes`` splits nothing."""
    specs: Dict[str, Spec]
    meshes: Dict[str, Any]

    def dim(self, name: str, axis: str) -> Optional[int]:
        """The dim of ``name`` that ``axis`` splits, or None."""
        if axis not in self.meshes:
            return None
        spec = self.specs.get(name, ())
        return spec.index(axis) if axis in spec else None

    def axes(self, name: str) -> Tuple[str, ...]:
        """The axes of more than one rank that split ``name``, in mesh order."""
        return tuple(a for a, m in self.meshes.items()
                     if m.size > 1 and self.dim(name, a) is not None)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` on every axis, a copy of its own where
        split (a slice of dim 0 is contiguous as a view, and a view would
        keep the whole tensor's storage alive)."""
        whole = t
        for axis, m in self.meshes.items():
            d = self.dim(name, axis)
            if d is not None and m.size > 1:
                if t.shape[d] % m.size:
                    raise ValueError(f"{name}: dim {d} of {tuple(t.shape)} does not split "
                                     f"over {m.size} {axis} ranks")
                k = t.shape[d] // m.size
                t = t.narrow(d, m.rank * k, k)
        return t if t is whole else t.clone(memory_format=torch.contiguous_format)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of this rank's slice ``t``, gathered over every
        axis that splits it (no gradient; every rank of those axes calls it)."""
        for axis in reversed(self.axes(name)):
            t = gather_full(t, self.meshes[axis], self.dim(name, axis))
        return t

    def gather(self, name: str, t: torch.Tensor, site: str) -> torch.Tensor:
        """``t``, this rank's slice of ``name``, gathered over ``data`` for
        its use (differentiable; ``t`` itself when ``data`` splits nothing)."""
        d = self.dim(name, "data")
        return t if d is None else gather_param(t, self.meshes["data"], d, site=site)


def place(layout: Mapping[str, RefLeaf], mesh, *, heads: Tuple[int, int]) -> Placement:
    """The placement of a model of ``layout`` (``convert.reference_layout``)
    on ``mesh``: this rank's ``{"data": Mesh, "model": Mesh}``, or one
    ``Mesh``, the model axis alone (tensor parallelism without FSDP);
    ``heads`` as ``port_specs`` takes it."""
    meshes = dict(mesh) if isinstance(mesh, Mapping) else {"model": as_mesh(mesh)}
    shape = {"data": 1, "model": 1, **{a: m.size for a, m in meshes.items()}}
    return Placement(port_specs(layout, shape, heads=heads), meshes)


class _LinearView:
    """An ``nn.Linear`` as its forward uses it, with other weights."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        self.weight, self.bias = weight, bias

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def gathered(module: nn.Module, prefix: str, placement: Placement, site: str):
    """``module`` (state-dict names under ``prefix``) as its forward uses
    it: each ``nn.Linear`` a view over its weights gathered over ``data``
    (``Placement.gather``, logged at ``site``), each container a namespace
    of its children's and of its own parameters, gathered (the experts'
    ``gate``, ``up``, ``down``); a module with no split parameter is
    itself."""
    if not any(placement.dim(prefix + n, "data") is not None
               for n, _ in module.named_parameters()):
        return module

    def g(leaf, t):
        return None if t is None else placement.gather(prefix + leaf, t, site)

    if isinstance(module, nn.Linear):
        return _LinearView(g("weight", module.weight), g("bias", module.bias))
    children = dict(module.named_children())
    own = dict(module.named_parameters(recurse=False))
    if not children:
        raise NotImplementedError(f"{prefix}: a {type(module).__name__} split over "
                                  "data is not gathered for its use")
    return SimpleNamespace(**{n: gathered(c, f"{prefix}{n}.", placement, site)
                              for n, c in children.items()},
                           **{n: g(n, t) for n, t in own.items()})
