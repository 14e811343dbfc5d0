"""Compressed cross-replica reduction of the port (counterpart of
``byteps_tpu/ops/compression/reducer.py``, its ``gather`` exchange).

The reference compresses right before PUSH and decompresses after PULL,
with the server summing decompressed payloads (reference:
core_loops.cc:498-536, server.cc:86-113). An all-reduce over bit-packed
payloads would be meaningless, so, as in the JAX package, every replica
all-gathers the *compressed* payloads of a bucket over the data-parallel
group and decompress-sums them locally: wire bytes per step drop from
O(n) to O(world × payload).

``CompressionPlan`` binds the bucket plan (``plan_buckets`` over the
gradient leaves in the JAX tree's order, last-declared first) to one
compressor per bucket, or None where the bucket is smaller than
``min_compress_bytes`` (reference: operations.cc:362-364); those buckets
take the plain sum. At world 1 there is no collective, but every
compressed bucket is still compressed and decompressed: compression,
error feedback and momentum shape the gradient there too, as the JAX
trainer keeps size-1 axes on lossy paths.

The reduce-scatter-shaped exchange (``exchange="rs"``) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ...common.partition import Bucket, LeafSpec, itemsize, plan_buckets
from ...parallel.collectives import _pack_bucket, _unpack_bucket, psum_reducer
from ...parallel.mesh import data_group, dp_size
from . import base


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` from every replica of ``group``, in rank order; [t] without
    a group (world 1)."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


class CompressionPlan:
    """Per-bucket compressors over a fixed list of gradient leaves."""

    def __init__(self, specs: Sequence[LeafSpec], partition_bytes: int,
                 kwargs: Dict[str, str], min_compress_bytes: int = 65536):
        kwargs = dict(kwargs)
        exchange = kwargs.pop("exchange", "gather")
        if exchange == "rs":
            raise NotImplementedError(
                "compression exchange 'rs' (reduce-scatter shaped) is not "
                "ported yet (ROADMAP.md, 'Modules still to port')")
        if exchange != "gather":
            raise ValueError(f"compression exchange must be gather|rs, "
                             f"got {exchange!r}")
        self.specs = list(specs)     # the leaves, in the order reduce takes them
        self.buckets: List[Bucket] = plan_buckets(specs, partition_bytes,
                                                  reverse_order=True)
        self.compressors: List[Optional[base.Compressor]] = [
            None if b.size * itemsize(b.dtype) < min_compress_bytes
            else base.create(kwargs, b.size, b.dtype)
            for b in self.buckets]

    @property
    def n_compressed(self) -> int:
        return sum(c is not None for c in self.compressors)

    def init_state(self, device=None) -> list:
        return [() if c is None else c.init_state(device)
                for c in self.compressors]

    def reduce(self, tensors: Sequence[torch.Tensor], states: list,
               group=None, average: bool = True) -> list:
        """Bucketed compressed all-reduce, IN PLACE on ``tensors`` (the
        leaves in the order of the plan's specs) over ``group`` (default:
        the data group). Returns the new compressor states."""
        if group is None:
            group = data_group()
        n = dp_size(group)
        flat = [t.view(-1) for t in tensors]
        new_states = []
        for b, comp, st in zip(self.buckets, self.compressors, states):
            buf = _pack_bucket(flat, b)
            if comp is None:
                red = psum_reducer(buf, group)
            else:
                payload, st = comp.compress(buf, st)
                gathered = {k: _all_gather(v.reshape(-1), group)
                            for k, v in payload.items()}
                red = torch.zeros_like(buf)
                for i in range(n):
                    red = red + comp.decompress(
                        {k: v[i].reshape(payload[k].shape)
                         for k, v in gathered.items()})
            if average:
                red = red / n
            new_states.append(st)
            _unpack_bucket(red, b, flat)
        return new_states
