"""The port's mesh: each axis over a torch ``ProcessGroup`` (counterpart
of ``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices; the port's
collectives run over a ``torch.distributed`` process group instead, so a
``Mesh`` here is that group (or ``None``), the axis name, its size and
this process's rank in it.  A size-1 mesh with no group issues no
collective: every helper of ``parallel.collectives`` then computes its
local product alone.

``make_mesh`` never initialises the default process group: the caller
does that (``torch.distributed.init_process_group`` with an address, a
world size and a rank), and ``make_mesh`` reads it.  With NCCL each rank
sets its current device (``torch.cuda.set_device(local_rank)``) first:
NCCL's point-to-point ops (the ring) and the port's kernels run on it.

``make_mesh((d, m), ("data", "model"))`` lays the default group's ranks
out row-major, as the reference's ``jax.make_mesh`` lays out its devices
(rank ``i·m + j`` at data index ``i``, model index ``j``), and returns
this rank's ``Mesh`` for each axis: its model group is the ``m`` ranks
of its row, its data group the ``d`` ranks of its column.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One mesh axis, ``"model"``, over ``group`` (``None``: this process
    alone)."""
    group: Optional[object]
    size: int = 1
    rank: int = 0
    axis: str = "model"


def make_mesh(shape=None, axes: Optional[Sequence[str]] = None):
    """``make_mesh(group)``: a one-axis mesh over ``group``; by default the
    initialised default group, and with none initialised a size-1 mesh
    that issues no collective.

    ``make_mesh(shape, axes)``: this rank's ``Mesh`` for each axis, as
    ``{axis: Mesh}``, over the initialised default group, whose size must
    be the product of ``shape`` (module docstring).  Every rank must call
    it: each axis's groups are made on all ranks, in the same order."""
    if axes is None:
        group = shape
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        if group is None:
            return Mesh(None)
        return Mesh(group, dist.get_world_size(group), dist.get_rank(group))
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    me = dist.get_rank()
    coord = [(me // math.prod(shape[k + 1:])) % shape[k] for k in range(len(shape))]
    out: Dict[str, Mesh] = {}
    for k, axis in enumerate(axes):
        stride = math.prod(shape[k + 1:])
        others = [range(n) if j != k else range(1) for j, n in enumerate(shape)]
        for c in itertools.product(*others):
            base = sum(ci * math.prod(shape[j + 1:]) for j, ci in enumerate(c))
            ranks = [base + i * stride for i in range(shape[k])]
            group = (dist.group.WORLD if len(ranks) == world else
                     dist.new_group(ranks))
            if me in ranks:
                out[axis] = Mesh(group, shape[k], coord[k], axis)
    return out


def as_mesh(mesh) -> Mesh:
    """A ``Mesh`` from a ``Mesh``, a ``ProcessGroup`` or ``None`` (size 1)."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return Mesh(None)
    return make_mesh(mesh)
