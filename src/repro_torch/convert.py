"""Parameters of the JAX reference -> the port's ``state_dict``.

The reference keeps parameters as a nested dict: linear weights ``w`` of
shape (d_in, d_out), embeddings ``table``, and the trunk's layers stacked
on a leading axis under ``trunk.dense_layers``.  The port keeps one module
per layer and ``nn.Linear``'s (d_out, d_in) weights.  ``params_from_jax``
takes the reference's tree with numpy leaves (``jax.tree.map(np.asarray,
params)``) and returns a ``state_dict`` for ``Model.load_state_dict``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAF_NAMES = {"w": "weight", "b": "bias", "table": "weight"}
STACKED = ("trunk", "dense_layers")


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
    out: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(tree):
        if path[:2] == STACKED:
            if a.shape[0] != cfg.num_layers:
                raise ValueError(f"{'.'.join(path)}: {a.shape[0]} stacked layers, "
                                 f"config has {cfg.num_layers}")
            for i in range(a.shape[0]):
                out[_name(STACKED + (str(i),) + path[2:])] = _tensor(path, a[i])
        else:
            out[_name(path)] = _tensor(path, a)
    return out
