"""Parameters of the JAX reference -> the port's ``state_dict``.

The reference keeps parameters as a nested dict: linear weights ``w`` of
shape (d_in, d_out), embeddings ``table``, and the trunk's layers stacked
on leading axes: ``trunk.dense_layers`` (L, ...) for the dense and vlm
families (a MoE model's leading dense layers) and ``trunk.moe_layers``
(L - those, ...) for the moe family, ``trunk.layers`` (L, ...) for rwkv6,
for zamba2 ``trunk.groups`` (G, every, ...), ``trunk.app_in`` (G, ...)
and ``trunk.tail`` (T, ...), and for whisper ``trunk.enc_layers``
(encoder_layers, ...) and ``trunk.dec_layers`` (L, ...).  MLA's leaves
(``attn.q``, ``kv_a``, ``kv_a_norm``, ``kv_b``, ``o``) sit where GQA's
do; whisper's ``trunk.enc_pos``, ``trunk.enc_ln`` and the top-level
``dec_pos`` are unstacked, and keep their layout.  The port keeps one
module per layer (nested ``nn.ModuleList``s, indexed ``groups.{g}.{j}``)
and ``nn.Linear``'s (d_out, d_in) weights, so ``w`` leaves are
transposed.  Every other leaf keeps the reference's layout,
rwkv6's raw matrices (``Wr``, ``maa_w1``, ``maa_w2``, ``decay_w1``, ...),
mamba2's ``conv_w`` (K, C) and the experts' ``gate``, ``up`` (E, d, f)
and ``down`` (E, f, d), padded experts included: the port multiplies them as the
reference does (``x @ W``).  ``params_from_jax`` takes the reference's tree
with numpy leaves (``jax.tree.map(np.asarray, params)``) and returns a
``state_dict`` for ``Model.load_state_dict``; ``params_to_jax`` is its
inverse, and ``opt_state_from_jax`` converts the reference's AdamW state
(its ``mu`` and ``nu`` mirror the parameter tree) to the port's.

Placements: with ``mesh=`` the two ``*_from_jax`` give one rank's state
dict of a model placed on that mesh (``models.model.shard_``): ``mesh`` is
``{"data": Mesh, "model": Mesh}``, and each leaf is cut to this rank's
slice of every dim those axes split (``parallel.sharding.place``, by the
config's heads); one ``Mesh`` is the model axis alone.
``params_to_jax`` of a placed model gathers each leaf over the axes that
split it (every rank of them must call it), one leaf at a time, each to
the host before the next is gathered.  ``reference_layout`` gives each
port parameter's reference path and shape, from which
``sharding.port_specs`` maps the reference's rules onto the port.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.parallel import sharding

_LEAF_NAMES = {"w": "weight", "b": "bias", "table": "weight"}


def stacked_axes(cfg) -> Dict[Tuple[str, str], Tuple[int, ...]]:
    """The reference's stacked subtrees for ``cfg`` -> the sizes of their
    leading layer axes."""
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        groups, tail = cfg.num_layers // every, cfg.num_layers % every
        return {("trunk", "groups"): (groups, every), ("trunk", "app_in"): (groups,),
                ("trunk", "tail"): (tail,)}
    if cfg.family == "ssm":
        return {("trunk", "layers"): (cfg.num_layers,)}
    if cfg.family == "audio":
        return {("trunk", "enc_layers"): (cfg.encoder_layers,),
                ("trunk", "dec_layers"): (cfg.num_layers,)}
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.num_layers
    return {("trunk", "dense_layers"): (n_dense,),
            ("trunk", "moe_layers"): (cfg.num_layers - n_dense,)}


def _flatten(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _flatten(node, path + (key,))
        else:
            yield path + (key,), np.asarray(node)


def _tensor(path: Tuple[str, ...], a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.T.contiguous() if path[-1] == "w" else t


def _name(path: Tuple[str, ...]) -> str:
    return ".".join(path[:-1] + (_LEAF_NAMES.get(path[-1], path[-1]),))


def params_from_jax(cfg, tree, mesh=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> the port's
    state_dict; with ``mesh``, this rank's state dict of the model placed
    on it (module docstring)."""
    stacked = stacked_axes(cfg)
    out: Dict[str, torch.Tensor] = {}
    layout: Dict[str, sharding.RefLeaf] = {}
    for path, a in _flatten(tree):
        lead = stacked.get(path[:2], ())
        if a.shape[:len(lead)] != lead:
            raise ValueError(f"{'.'.join(path)}: stacked axes {a.shape[:len(lead)]}, "
                             f"config {cfg.name} has {lead}")
        leaf = sharding.RefLeaf("/".join(path), a.shape, len(lead), path[-1] == "w")
        for idx in itertools.product(*(range(n) for n in lead)):
            name = _name(path[:2] + tuple(map(str, idx)) + path[2:] if lead else path)
            out[name], layout[name] = _tensor(path, a[idx] if lead else a), leaf
    if mesh is None:
        return out
    place = sharding.place(layout, mesh, heads=sharding.heads_of(cfg))
    return {k: place.local(k, v) for k, v in out.items()}


def _reference_leaf(mods, key: str, stacked):
    """(path, layer index, stacked axes, transposed) in the reference's tree
    of the port's state-dict entry ``key``."""
    parts = key.split(".")
    mod, leaf = mods[".".join(parts[:-1])], parts[-1]
    transposed = False
    if isinstance(mod, nn.Embedding):
        leaf = "table"
    elif isinstance(mod, nn.Linear):
        transposed = leaf == "weight"
        leaf = {"weight": "w", "bias": "b"}[leaf]
    lead = stacked.get(tuple(parts[:2]), ())
    path = parts[:2] + parts[2 + len(lead):-1] + [leaf] if lead else parts[:-1] + [leaf]
    return tuple(path), tuple(int(i) for i in parts[2:2 + len(lead)]), lead, transposed


def reference_layout(cfg, model: nn.Module) -> Dict[str, sharding.RefLeaf]:
    """Each entry of the (whole, not yet placed) ``model``'s state dict ->
    its leaf in the reference's tree: key path, shape (stacked axes
    included), the count of stacked axes, and whether it is transposed."""
    mods = dict(model.named_modules())
    stacked = stacked_axes(cfg)
    out = {}
    for key, t in model.state_dict().items():
        path, _, lead, transposed = _reference_leaf(mods, key, stacked)
        shape = tuple(t.shape)[::-1] if transposed else tuple(t.shape)
        out[key] = sharding.RefLeaf("/".join(path), lead + shape, len(lead), transposed)
    return out


def params_to_jax(cfg, model: nn.Module):
    """The inverse of ``params_from_jax``: the port's model -> the
    reference's nested tree of numpy arrays (layers restacked, linear
    weights transposed back, embeddings as ``table``); a placed model's
    leaves gathered whole, one at a time, on every rank that splits them."""
    mods = dict(model.named_modules())
    stacked = stacked_axes(cfg)
    place = getattr(model, "placement", None)
    tree: Dict = {}
    parts_of: Dict[Tuple[str, ...], Dict] = {}
    for key, t in model.state_dict().items():
        path, idx, lead, transposed = _reference_leaf(mods, key, stacked)
        if place is not None:
            t = place.full(key, t)
        a = t.detach().cpu().numpy()
        del t
        parts_of.setdefault(path, {"lead": lead})[idx] = a.T if transposed else a
    for path, got in parts_of.items():
        lead = got.pop("lead")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if lead:
            idxs = list(itertools.product(*(range(n) for n in lead)))
            node[path[-1]] = np.stack([got[i] for i in idxs]).reshape(lead + got[idxs[0]].shape)
        else:
            node[path[-1]] = got[()]
    return tree


def opt_state_from_jax(cfg, state, mesh=None) -> Dict[str, object]:
    """The reference's AdamW state ({"mu", "nu", "count"}, numpy leaves) ->
    the port's: ``mu`` and ``nu`` keyed by state-dict name (through
    ``params_from_jax``, with ``mesh`` this rank's shards), ``count`` an
    int64 scalar tensor."""
    return {"mu": params_from_jax(cfg, state["mu"], mesh),
            "nu": params_from_jax(cfg, state["nu"], mesh),
            "count": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int64)}
