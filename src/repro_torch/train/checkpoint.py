"""Checkpoints in the reference's layout (the port of
``repro.train.checkpoint``): numpy ``.npz`` plus a structure manifest.

    step_00000100/arrays.npz       leaf_0 ... leaf_{n-1}
    step_00000100/manifest.json    {"step", "treedef", "num_leaves", "extra"}
    latest                         the newest step's directory name

A tree is nested dicts (and lists or tuples) of arrays or tensors.  Its
leaves are written in ``jax.tree.flatten`` order, which sorts dict keys, and
the manifest's ``treedef`` is the string ``jax.tree.structure`` prints, both
computed here without jax, so a checkpoint crosses between the packages both
ways: the port saves ``convert.params_to_jax(cfg, model)`` and the
reference restores it, and the reverse.  Writes are atomic (a ``.tmp``
directory renamed into place); ``keep`` bounds how many steps stay.

Restores are fault-tolerant as the reference's: a corrupt checkpoint
(truncated ``.npz``, mangled manifest, wrong leaf count) warns and falls
back to the newest intact earlier step, and only when every candidate is
unreadable does a ``FileNotFoundError`` surface.  Leaves come back as numpy
arrays.  The port trains in fp32: a bf16 leaf of a reference checkpoint,
which numpy stores as 2-byte void (``|V2``, from ``ml_dtypes``), is read
through its 2-byte view and widened to fp32 exactly.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# what a torn or corrupt checkpoint raises when loaded (the reference's list)
_LOAD_ERRORS = (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError)


def leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.flatten`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if tree is None:
        return []
    return [tree]


def _structure(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` writes it."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _unflatten(tree, arrays: List[np.ndarray]):
    it = iter(arrays)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(tree)


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fp32_of_v2(a: np.ndarray) -> np.ndarray:
    """A bf16 leaf stored as ``|V2`` -> fp32 (the bf16 bits are the high
    half of the fp32 word)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def save(path: str, tree, *, step: int, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``path``; returns its directory."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves(tree))}
    ck = os.path.join(path, f"step_{step:08d}")
    tmp = ck + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "treedef": f"PyTreeDef({_structure(tree)})",
                   "num_leaves": len(arrays), "extra": extra or {}}, f)
    if os.path.exists(ck):
        shutil.rmtree(ck)
    os.rename(tmp, ck)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(os.path.basename(ck))
    _gc(path, keep)
    return ck


def _load_one(ck: str, tree_like) -> Tuple[Any, int]:
    """One checkpoint directory into ``tree_like``'s structure (raises on
    any corruption; see ``_LOAD_ERRORS``)."""
    with np.load(os.path.join(ck, "arrays.npz")) as z:
        arrays = [_fp32_of_v2(z[f"leaf_{i}"]) for i in range(len(z.files))]
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(leaves(tree_like))
    if n != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, model expects {n}")
    return _unflatten(tree_like, arrays), manifest["step"]


def restore(path: str, tree_like, *, step: Optional[int] = None):
    """Restores into the structure of ``tree_like``; returns (tree, step).

    A corrupt requested checkpoint warns (``RuntimeWarning``) and falls
    back to the newest intact strictly-earlier step; only when every
    candidate is unreadable does a ``FileNotFoundError`` surface."""
    if step is None:
        with open(os.path.join(path, "latest")) as f:
            first = f.read().strip()
    else:
        first = f"step_{step:08d}"
    # the requested step, then every strictly earlier one, newest first
    # (zero-padded names sort chronologically)
    earlier = sorted((d for d in os.listdir(path)
                      if d.startswith("step_") and not d.endswith(".tmp") and d < first),
                     reverse=True)
    errors = []
    for name in [first] + earlier:
        ck = os.path.join(path, name)
        try:
            return _load_one(ck, tree_like)
        except _LOAD_ERRORS as e:
            errors.append(f"{name}: {type(e).__name__}: {e}")
            warnings.warn(
                f"checkpoint {ck} is unreadable ({type(e).__name__}: {e})"
                + (f" — falling back to {earlier[len(errors) - 1]}"
                   if len(errors) <= len(earlier) else ""),
                RuntimeWarning, stacklevel=2)
    raise FileNotFoundError(
        f"no intact checkpoint at or before {first} under {path}; tried: "
        + "; ".join(errors))


def _gc(path: str, keep: int) -> None:
    cks = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    for d in cks[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
