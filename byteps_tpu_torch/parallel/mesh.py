"""Process groups of the port: the data-parallel group, and the named
axes of a mesh (the port's counterpart of
``byteps_tpu/parallel/mesh.py``).

The JAX package names the axes of a device mesh that a collective spans.
With one process per GPU the same role is played by ``torch.distributed``
process groups: the default group once ``init()`` joined one, and no
group at all at world 1. ``make_mesh`` lays the world's ranks out on
named axes (``data`` × ``seq``, ...) and builds one group per line of
each axis of size > 1. A size-1 axis is kept, with no group: it is a ring
of one, as the JAX ring keeps its named axis at size 1
(``bench.py:177-180``).

``use_mesh`` makes a mesh current (``ShardedTrainer.step`` does); a model
with ``sp_axis`` resolves that axis through ``axis_ring``, and raises
when no current mesh holds it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch.distributed as dist

# Canonical axis order, outermost first (the JAX package's AXIS_ORDER):
# ranks are laid out row-major over it, so ``seq`` varies fastest after
# ``model``.
AXIS_ORDER = ("dcn", "pipe", "data", "expert", "seq", "model")


class Ring(NamedTuple):
    """One rank's view of a mesh axis: its group (None for a ring of
    one), the axis size and this rank's index along it."""
    group: Optional[object]
    size: int
    index: int


class Mesh:
    """The world's ranks on named axes, with one process group per axis
    line this rank lies on (None for a size-1 axis)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 groups: Dict[str, object]) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        coords = np.unravel_index(rank, tuple(shape.values()))
        self._index = {a: int(i) for a, i in zip(self.axis_names, coords)}
        self._groups = dict(groups)

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not name."""
        return self.shape.get(axis, 1)

    def ring(self, axis: str) -> Ring:
        if axis not in self.shape:
            raise ValueError(f"mesh axes {self.axis_names} hold no {axis!r} "
                             "axis")
        return Ring(self._groups.get(axis), self.shape[axis],
                    self._index[axis])

    def group(self, axis: str):
        """The axis's process group, None for a size-1 axis."""
        return self.ring(axis).group


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Lay the world's ranks out on named axes (default: all on ``data``).

    Axis sizes must multiply to the world size (1 without a process
    group). Axes keep their given sizes, 1 included, ordered by
    ``AXIS_ORDER``. Every rank must call this with the same sizes: each
    group is made by all ranks together.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = dict(axis_sizes or {"data": world})
    for ax in sizes:
        if ax not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {ax!r}; valid: {AXIS_ORDER}")
    if math.prod(sizes.values()) != world:
        raise ValueError(f"axis sizes {sizes} do not multiply to the world "
                         f"size {world}")
    shape = {a: sizes[a] for a in AXIS_ORDER if a in sizes}
    grid = np.arange(world).reshape(tuple(shape.values()))
    groups = {}
    for i, ax in enumerate(shape):
        if shape[ax] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[ax]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[ax] = g
    return Mesh(shape, rank, groups)


_current: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` current inside the block (process-wide: the autograd
    engine's device threads run the backward, a recompute included)."""
    global _current
    prev, _current = _current, mesh
    try:
        yield mesh
    finally:
        _current = prev


def current_mesh() -> Optional[Mesh]:
    return _current


def axis_ring(axis: str) -> Ring:
    """The current mesh's ``axis``: (group, size, index). Raises when no
    mesh is current or it holds no such axis; never a silent ring of
    one."""
    if _current is None:
        raise RuntimeError(
            f"{axis!r} names a mesh axis, and no mesh is current: train "
            "through ShardedTrainer, or enter parallel.mesh.use_mesh(mesh)")
    return _current.ring(axis)


def data_group():
    """The group a gradient all-reduce spans, or None when it spans one
    rank: the current mesh's ``data`` axis, else the whole world."""
    if _current is not None:
        return _current.group("data") if "data" in _current.shape else None
    return dist.group.WORLD if dist.is_initialized() else None


def dp_size(group=None) -> int:
    """Number of data-parallel replicas in ``group`` (default: the data
    group); 1 when no process group exists."""
    if group is None:
        group = data_group()
    return 1 if group is None else dist.get_world_size(group)
