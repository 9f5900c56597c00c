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

The dry run (``launch.dryrun``) places models on the reference's
production meshes (``make_production_mesh``: 16 × 16 ``data`` × ``model``,
or 2 × 16 × 16 with ``pod``) over a fake world (``fake_world``: torch's
fake process group, whose collectives move nothing), in one process that
is rank 0: the program is SPMD, so one rank's issue is every rank's.
Where FSDP spans several axes (``pod`` × ``data``), ``axis_mesh`` makes
one group over them, their ranks in mesh order, as the reference's
sharding over the axes' product.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
    return {axis: axis_mesh(shape, axes, (axis,)) for axis in axes}


def axis_mesh(shape, axes: Sequence[str], over: Sequence[str], name: Optional[str] = None,
              ) -> Mesh:
    """This rank's ``Mesh`` over the axes ``over`` of the mesh ``shape`` /
    ``axes`` laid over the default group (row-major, as ``make_mesh``): the
    ranks that share this rank's index on every other axis, ordered by
    their index on ``over`` in mesh order.  Every such group of the mesh is
    made, each once and in the same order on every rank.  Named ``name``
    (default: ``over`` joined by ``"+"``)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    ks = [axes.index(a) for a in over]
    world, me = dist.get_world_size(), dist.get_rank()
    strides = [math.prod(shape[k + 1:]) for k in range(len(shape))]
    mine = None
    others = [range(1) if k in ks else range(n) for k, n in enumerate(shape)]
    for c in itertools.product(*others):
        base = sum(ci * st for ci, st in zip(c, strides))
        ranks = [base + sum(i * strides[k] for i, k in zip(idx, ks))
                 for idx in itertools.product(*(range(shape[k]) for k in ks))]
        group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
        if me in ranks:
            mine = Mesh(group, len(ranks), ranks.index(me), name or "+".join(over))
    return mine


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, Mesh]:
    """This rank's ``{axis: Mesh}`` of the reference's production mesh: 16 ×
    16 (``data``, ``model``), or 2 × 16 × 16 (``pod``, ``data``,
    ``model``) with ``multi_pod``, over the default group (of 256 or 512
    ranks: the dry run's ``fake_world``)."""
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes)


def production_shape(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(data-parallel axes, tensor-parallel axis) of a production mesh
    (``{axis: Mesh}``, or its axis names)."""
    if "pod" in mesh:
        return ("pod", "data"), "model"
    return ("data",), "model"


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks of torch's fake backend, this
    process rank 0, for the ``with`` block (destroyed on exit): every
    collective returns at once and moves nothing.  Refuses where a default
    group exists."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists: a fake world of "
                           f"{n} ranks would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def as_mesh(mesh) -> Mesh:
    """A ``Mesh`` from a ``Mesh``, a ``ProcessGroup`` or ``None`` (size 1)."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return Mesh(None)
    return make_mesh(mesh)
