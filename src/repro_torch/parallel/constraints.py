"""Activation placement checks (counterpart of ``repro.parallel.constraints``).

The reference pins activation shardings at layer boundaries for GSPMD.
The port's placements are explicit: each rank holds its slice of the
batch, and nothing redistributes an activation.  So these helpers return
their tensor unchanged.  With axes installed (``use_axes``, as the
reference's launcher does) and the step's global batch known, each one
checks the local shape: the batch dim must be this data rank's share
(``parallel.sharding.batch_specs``: the batch over the data axes when they
divide it, else whole), divided by the microbatches the trainer splits it
into (``microbatches``).  A mismatch raises ``ValueError``.

The helpers sit where the reference calls them: ``btd`` at each layer's
input and on the loss chunks, ``logits`` on each chunk's logits.  The
port keeps the vocabulary and the feed-forward features of the
activations whole on every rank of ``model`` (the sited MLP gathers its
output back), so ``btf`` and ``logits`` check the batch dim only, and
``ecd`` (the MoE capacity buffers) nothing: each rank's buffer holds every
expert's slots of the global batch (``layers.moe_block``), whose size
no local shape shows.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Optional, Tuple

import torch

_AXES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_axes",
                                                        default=None)
_SPLIT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_microbatches",
                                                         default=1)


@contextlib.contextmanager
def use_axes(dp_axes: Tuple[str, ...], tp_axis: str, *,
             sizes: Optional[Dict[str, int]] = None, batch: Optional[int] = None):
    """Install the mesh axes for the ``with`` block.  ``sizes`` maps each
    axis to its size and ``batch`` is the step's global batch: with both,
    the helpers check each activation's batch dim."""
    token = _AXES.set({"dp": tuple(dp_axes), "tp": tp_axis, "sizes": dict(sizes or {}),
                       "batch": batch})
    try:
        yield
    finally:
        _AXES.reset(token)


@contextlib.contextmanager
def microbatches(n: int):
    """The activations inside are one of ``n`` microbatches of the step's
    batch (the trainer's ``grad_accum`` and ``microbatches`` modes)."""
    token = _SPLIT.set(_SPLIT.get() * n)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def axes():
    return _AXES.get()


def _check_rows(x: torch.Tensor, what: str) -> torch.Tensor:
    a = axes()
    if a is None or x.ndim != 3:
        return x
    if a["batch"] is not None and a["sizes"]:
        dp = math.prod(a["sizes"][ax] for ax in a["dp"])
        share = a["batch"] // dp if a["batch"] % dp == 0 else a["batch"]
        want = share // _SPLIT.get()
        if x.shape[0] != want:
            raise ValueError(
                f"constraints.{what}: batch dim {x.shape[0]} of {tuple(x.shape)}, but this "
                f"rank's share of the global batch {a['batch']} over {a['dp']} "
                f"({a['sizes']}) in {_SPLIT.get()} microbatch(es) is {want}")
    return x


def btd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations: batch over the data axes."""
    return _check_rows(x, "btd")


def btf(x: torch.Tensor) -> torch.Tensor:
    """(B, S, F) feed-forward activations: batch over the data axes."""
    return _check_rows(x, "btf")


def ecd(x: torch.Tensor) -> torch.Tensor:
    """(E, cap, D) MoE capacity buffers, unchecked: a rank's buffer is the
    global batch's (``layers.moe_block``), the same shape on every rank."""
    return x


def logits(x: torch.Tensor) -> torch.Tensor:
    """(B, c, V) loss logits chunk: batch over the data axes."""
    return _check_rows(x, "logits")
