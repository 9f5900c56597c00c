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
``state_dict`` for ``Model.load_state_dict``.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

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


def params_from_jax(cfg, tree) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> the port's state_dict."""
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
    return out
