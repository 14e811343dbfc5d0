"""Gradient synchronization: the port's push_pull (counterpart of
``byteps_tpu/parallel/collectives.py::psum_reducer`` and
``bucketed_allreduce``).

What survives of the reference's 12-stage pipeline (reference:
common.h:88-102, core_loops.cc) in a data-parallel all-reduce:

  1. **Bucketing**: many small gradients fused into few fixed-byte buckets
     (``common/partition.py::plan_buckets``).
  2. **Priority order**: buckets communicated in reverse declaration order
     so the earliest-ready gradients go first (reference:
     scheduled_queue.cc:82-102).

Each bucket is one ``torch.distributed.all_reduce`` (NCCL on the card,
gloo on the CPU) on the data-parallel group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common.partition import Bucket, LeafSpec, plan_buckets
from .mesh import data_group, dp_size


def psum_reducer(buf: torch.Tensor, group) -> torch.Tensor:
    """Default reducer: an in-place sum over ``group`` (identity without
    one)."""
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def leaf_specs(tensors: Sequence[torch.Tensor],
               names: Optional[Sequence[str]] = None) -> List[LeafSpec]:
    names = names or [str(i) for i in range(len(tensors))]
    return [LeafSpec(name=n, size=t.numel(),
                     dtype=str(t.dtype).removeprefix("torch."))
            for n, t in zip(names, tensors)]


def _pack_bucket(flat: List[torch.Tensor], bucket: Bucket) -> torch.Tensor:
    parts = [flat[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length]
             for s in bucket.segments]
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def _unpack_bucket(buf: torch.Tensor, bucket: Bucket,
                   flat: List[torch.Tensor]) -> None:
    for s in bucket.segments:
        flat[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length].copy_(
            buf[s.bucket_offset:s.bucket_offset + s.length])


def bucketed_allreduce(tensors: Sequence[torch.Tensor], group=None,
                       partition_bytes: int = 4 << 20, average: bool = True,
                       names: Optional[Sequence[str]] = None) -> None:
    """Bucketed gradient all-reduce, IN PLACE on ``tensors``.

    Flattens the leaves, packs them into ~partition_bytes buckets in
    reverse declaration order, sums each bucket over ``group`` (default:
    the data group) with ``psum_reducer``, divides by the group size when
    ``average``, and copies the result back. At world 1 there is nothing
    to reduce and the call returns at once, as the JAX trainer drops
    size-1 axes (``training.py:337-342``).
    """
    if group is None:
        group = data_group()
    n = dp_size(group)
    if not tensors or n == 1:
        return
    buckets = plan_buckets(leaf_specs(tensors, names), partition_bytes,
                           reverse_order=True)
    flat = [t.view(-1) for t in tensors]
    for b in buckets:
        buf = psum_reducer(_pack_bucket(flat, b), group)
        if average:
            buf = buf / n
        _unpack_bucket(buf, b, flat)
