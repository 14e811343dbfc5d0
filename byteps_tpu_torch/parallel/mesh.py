"""The data-parallel group (the port's counterpart of
``byteps_tpu/parallel/mesh.py::data_axes`` / ``dp_size``).

The JAX package names the axes of a device mesh that a gradient
all-reduce spans. With one process per GPU the same role is played by a
``torch.distributed`` process group: the default group once ``init()``
joined one, and no group at all at world 1.
"""

from __future__ import annotations

import torch.distributed as dist


def data_group():
    """The group a gradient all-reduce spans, or None at world 1."""
    return dist.group.WORLD if dist.is_initialized() else None


def dp_size(group=None) -> int:
    """Number of data-parallel replicas in ``group`` (default: the data
    group); 1 when no process group exists."""
    if group is None:
        group = data_group()
    return 1 if group is None else dist.get_world_size(group)

