"""Parameters of the JAX reference -> the port's ``state_dict``.

The reference keeps parameters as a nested dict: linear weights ``w`` of
shape (d_in, d_out), embeddings ``table``, and the trunk's layers stacked
on leading axes: ``trunk.dense_layers`` (L, ...) for the dense family,
``trunk.layers`` (L, ...) for rwkv6, and for zamba2 ``trunk.groups``
(G, every, ...), ``trunk.app_in`` (G, ...) and ``trunk.tail`` (T, ...).
The port keeps one module per layer (nested ``nn.ModuleList``s, indexed
``groups.{g}.{j}``) and ``nn.Linear``'s (d_out, d_in) weights, so ``w``
leaves are transposed.  Every other leaf keeps the reference's layout,
rwkv6's raw matrices (``Wr``, ``maa_w1``, ``maa_w2``, ``decay_w1``, ...)
and mamba2's ``conv_w`` (K, C) included: the port multiplies them as the
reference does (``x @ W``).  ``params_from_jax`` takes the reference's tree
with numpy leaves (``jax.tree.map(np.asarray, params)``) and returns a
``state_dict`` for ``Model.load_state_dict``; ``params_to_jax`` is its
inverse, and ``opt_state_from_jax`` converts the reference's AdamW state
(its ``mu`` and ``nu`` mirror the parameter tree) to the port's.

Tensor parallelism: with ``mesh=`` the two ``*_from_jax`` give one rank's
state dict of a model sharded in place (``models.model.shard_``): the
dense trunk's MLP weights cut to this rank's columns of gate and up and
rows of down.  ``params_to_jax`` of a sharded model gathers the shards
over its mesh (every rank of it must call it) and returns the full tree.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import as_mesh
from repro_torch.models.model import mlp_shard_dims, sharded_params, tp_mesh
from repro_torch.parallel.collectives import all_gather_rows

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
    return {("trunk", "dense_layers"): (cfg.num_layers,)}


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


def _shard(cfg, sd: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards of the MLP weights of ``sd`` over ``mesh``."""
    m = as_mesh(mesh)
    if m.size == 1:
        return sd
    for name, dim in mlp_shard_dims(cfg).items():
        k = sd[name].shape[dim] // m.size
        sd[name] = sd[name].narrow(dim, m.rank * k, k).contiguous()
    return sd


def params_from_jax(cfg, tree, mesh=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> the port's
    state_dict; with ``mesh``, this rank's state dict of the model sharded
    over it."""
    stacked = stacked_axes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(tree):
        lead = stacked.get(path[:2])
        if lead is None:
            out[_name(path)] = _tensor(path, a)
            continue
        if a.shape[:len(lead)] != lead:
            raise ValueError(f"{'.'.join(path)}: stacked axes {a.shape[:len(lead)]}, "
                             f"config {cfg.name} has {lead}")
        for idx in itertools.product(*(range(n) for n in lead)):
            out[_name(path[:2] + tuple(map(str, idx)) + path[2:])] = _tensor(path, a[idx])
    return out if mesh is None else _shard(cfg, out, mesh)


def _gathered(cfg, model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with any MLP shards gathered over the mesh
    the model is sharded over."""
    sd = model.state_dict()
    with torch.no_grad():
        for name, dim in sharded_params(cfg, model).items():
            t = sd[name] if dim == 0 else sd[name].T
            g = all_gather_rows(t.contiguous(), tp_mesh(model))
            sd[name] = g if dim == 0 else g.T
    return sd


def params_to_jax(cfg, model: nn.Module):
    """The inverse of ``params_from_jax``: the port's model -> the
    reference's nested tree of numpy arrays (layers restacked, linear
    weights transposed back, embeddings as ``table``); a sharded model's
    MLP shards gathered into the full weights."""
    mods = dict(model.named_modules())
    stacked = stacked_axes(cfg)
    tree: Dict = {}
    parts_of: Dict[Tuple[str, ...], Dict] = {}
    for key, t in _gathered(cfg, model).items():
        parts = key.split(".")
        mod, leaf = mods[".".join(parts[:-1])], parts[-1]
        a = t.detach().cpu().numpy()
        if isinstance(mod, nn.Embedding):
            leaf = "table"
        elif isinstance(mod, nn.Linear):
            a = a.T if leaf == "weight" else a
            leaf = {"weight": "w", "bias": "b"}[leaf]
        lead = stacked.get(tuple(parts[:2]), ())
        path = parts[:2] + parts[2 + len(lead):-1] + [leaf] if lead else parts[:-1] + [leaf]
        idx = tuple(int(i) for i in parts[2:2 + len(lead)])
        parts_of.setdefault(tuple(path), {"lead": lead})[idx] = a
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
