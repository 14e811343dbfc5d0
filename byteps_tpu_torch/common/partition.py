"""Gradient bucketing math (the port's copy of
``byteps_tpu/common/partition.py``).

The reference partitions every tensor into fixed-byte chunks so that push,
network, pull, and broadcast stages pipeline per chunk
(reference: PartitionTensor, operations.cc:140-180; BYTEPS_PARTITION_BYTES
global.cc:134-143). For a data-parallel all-reduce what matters is the
opposite aggregation: fusing many small gradients into few fixed-byte
buckets so each collective is big enough to saturate the link, while
keeping several buckets so that priority ordering is possible at bucket
granularity.

``plan_buckets`` takes the flat list of (name, size, dtype) leaves in
declaration order and packs them greedily into buckets of
~``partition_bytes`` each. Oversized single tensors are split across
buckets at element granularity (same role as the reference's chunk split
with remainder-to-last, operations.cc:154-167).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def itemsize(dtype: str) -> int:
    """Bytes per element of a dtype name; knows torch's ``bfloat16``,
    which numpy does not."""
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


@dataclass(frozen=True)
class LeafSpec:
    """One flat leaf of the gradient tree."""
    name: str
    size: int          # number of elements
    dtype: str         # numpy dtype name, e.g. "float32"

    @property
    def nbytes(self) -> int:
        return self.size * itemsize(self.dtype)


@dataclass(frozen=True)
class Segment:
    """A contiguous slice of one leaf placed inside a bucket."""
    leaf_index: int    # index into the leaf list
    leaf_offset: int   # element offset within the (flattened) leaf
    bucket_offset: int # element offset within the bucket buffer
    length: int        # number of elements


@dataclass(frozen=True)
class Bucket:
    """A fixed-size flat buffer holding segments of one or more leaves."""
    index: int
    size: int          # total elements
    dtype: str
    segments: Tuple[Segment, ...]
    priority: int      # higher = communicated earlier

    @property
    def nbytes(self) -> int:
        return self.size * itemsize(self.dtype)


def plan_buckets(leaves: Sequence[LeafSpec], partition_bytes: int,
                 reverse_order: bool = True,
                 priorities: Sequence[int] | None = None) -> List[Bucket]:
    """Pack leaves into ~partition_bytes buckets.

    ``reverse_order=True`` packs the *last-declared* leaves into the
    *first* buckets: in a backward pass gradients arrive in reverse layer
    order, so this makes bucket 0 complete (and communicable) earliest —
    the analogue of the reference's priority scheduling where
    priority = -declared_key (reference: scheduled_queue.cc:82-102,
    tf ops.cc:158).

    ``priorities`` (one int per leaf, higher = communicated earlier)
    overrides the default order. Ties keep leaf order.

    All leaves in one bucket must share a dtype; a dtype change forces a
    bucket boundary. Returns buckets with priority = -bucket_index.
    """
    if partition_bytes <= 0:
        raise ValueError("partition_bytes must be positive")
    if priorities is not None:
        if len(priorities) != len(leaves):
            raise ValueError("priorities must have one entry per leaf")
        order = sorted(range(len(leaves)), key=lambda i: -priorities[i])
    else:
        order = list(range(len(leaves)))
        if reverse_order:
            order.reverse()

    buckets: List[Bucket] = []
    cur_segments: List[Segment] = []
    cur_dtype: str | None = None
    cur_fill = 0  # elements

    def cap_elems(dtype: str) -> int:
        return max(1, partition_bytes // itemsize(dtype))

    def flush() -> None:
        nonlocal cur_segments, cur_dtype, cur_fill
        if cur_segments:
            idx = len(buckets)
            buckets.append(Bucket(index=idx, size=cur_fill, dtype=cur_dtype,
                                  segments=tuple(cur_segments), priority=-idx))
        cur_segments, cur_dtype, cur_fill = [], None, 0

    for li in order:
        leaf = leaves[li]
        remaining = leaf.size
        leaf_off = 0
        while remaining > 0:
            if cur_dtype is not None and cur_dtype != leaf.dtype:
                flush()
            if cur_dtype is None:
                cur_dtype = leaf.dtype
            cap = cap_elems(cur_dtype)
            space = cap - cur_fill
            if space <= 0:
                flush()
                continue
            take = min(space, remaining)
            cur_segments.append(Segment(leaf_index=li, leaf_offset=leaf_off,
                                        bucket_offset=cur_fill, length=take))
            cur_fill += take
            leaf_off += take
            remaining -= take
            if cur_fill >= cap:
                flush()
    flush()
    return buckets
