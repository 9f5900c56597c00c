"""The port's mesh: one tensor-parallel axis over a torch ``ProcessGroup``
(counterpart of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices; the port's
collectives run over a ``torch.distributed`` process group instead, so a
``Mesh`` here is that group (or ``None``), the axis name, its size and
this process's rank in it.  A size-1 mesh with no group issues no
collective: every helper of ``parallel.collectives`` then computes its
local product alone.

``make_mesh`` never initialises a process group: the caller does that
(``torch.distributed.init_process_group`` with an address, a world size
and a rank), and ``make_mesh`` only reads it.  With NCCL each rank sets
its current device (``torch.cuda.set_device``) first: NCCL's
point-to-point ops (the ring) and the port's kernels run on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One mesh axis, ``"model"``, over ``group`` (``None``: this process
    alone)."""
    group: Optional[object]
    size: int = 1
    rank: int = 0
    axis: str = "model"


def make_mesh(group=None) -> Mesh:
    """A mesh over ``group``; by default the initialised default group, and
    with none initialised a size-1 mesh that issues no collective."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None)
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group))


def as_mesh(mesh) -> Mesh:
    """A ``Mesh`` from a ``Mesh``, a ``ProcessGroup`` or ``None`` (size 1)."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return Mesh(None)
    return make_mesh(mesh)
