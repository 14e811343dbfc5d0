"""Compressed cross-replica reduction of the port (counterpart of
``byteps_tpu/ops/compression/reducer.py``).

The reference compresses right before PUSH and decompresses after PULL,
with the server summing decompressed payloads (reference:
core_loops.cc:498-536, server.cc:86-113). An all-reduce over bit-packed
payloads would be meaningless, so, as in the JAX package, the exchange
comes in two shapes, chosen by the ``exchange`` compression kwarg:

- ``"gather"`` (default): every replica all-gathers the *compressed*
  payloads of a bucket over the data-parallel group and decompress-sums
  them locally: wire bytes per step drop from O(n) to O(world × payload).
- ``"rs"`` (reduce-scatter shaped): each replica zero-pads the bucket to
  ``world`` equal shards, compresses each with its own per-shard state,
  and ``all_to_all``s them, so replica r holds every replica's payload for
  shard r; it decompress-sums its shard, zeroes the pad tail, averages,
  and compresses the merged shard once more with the merge chain (the
  server's role: the worker chain without momentum, with its own error
  feedback); an ``all_gather`` of the merged payloads then gives every
  replica every shard. Wire bytes and decompress work per replica are
  O(payload), whatever the world.

``CompressionPlan`` binds the bucket plan (``plan_buckets`` over the
gradient leaves in the JAX tree's order, last-declared first) to one
compressor per bucket, or None where the bucket is smaller than
``min_compress_bytes`` (reference: operations.cc:362-364); those buckets
take the plain sum. ``world`` is the size of the group the plan reduces
over, which sizes the rs shards (the trainers pass it). At world 1 there
is no collective, but every compressed bucket is still compressed and
decompressed: compression, error feedback and momentum shape the
gradient there too, as the JAX trainer keeps size-1 axes on lossy paths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ...common.partition import Bucket, LeafSpec, itemsize, plan_buckets
from ...parallel.collectives import _pack_bucket, _unpack_bucket, psum_reducer
from ...parallel.mesh import data_group, dp_size
from . import base


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a collective sends it: NCCL has no int16, so int16 codes
    (dithering's widest) cross as their bytes."""
    return t.view(torch.uint8) if t.dtype == torch.int16 else t


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` from every replica of ``group``, in rank order; [t] without
    a group (world 1)."""
    if group is None:
        return [t]
    w = _wire(t.contiguous())
    out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, w, group=group)
    return [o.view(t.dtype) for o in out]


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row i of ``t`` [world, ...] to replica i; row j of the result from
    replica j. ``t`` itself without a group (world 1)."""
    if group is None:
        return t
    w = _wire(t.contiguous())
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out.view(t.dtype)


class CompressionPlan:
    """Per-bucket compressors over a fixed list of gradient leaves."""

    def __init__(self, specs: Sequence[LeafSpec], partition_bytes: int,
                 kwargs: Dict[str, str], min_compress_bytes: int = 65536,
                 world: int = 1):
        kwargs = dict(kwargs)
        self.exchange = kwargs.pop("exchange", "gather")
        if self.exchange not in ("gather", "rs"):
            raise ValueError(f"compression exchange must be gather|rs, "
                             f"got {self.exchange!r}")
        if self.exchange == "rs" and world < 1:
            raise ValueError("exchange='rs' needs the reduction world "
                             "size (trainers pass it automatically)")
        self.world = world
        self.specs = list(specs)     # the leaves, in the order reduce takes them
        self.buckets: List[Bucket] = plan_buckets(specs, partition_bytes,
                                                  reverse_order=True)
        self.compressors: List[Optional[base.Compressor]] = []
        self.merge_compressors: List[Optional[base.Compressor]] = []
        self.shard_sizes: List[int] = []
        # the merge recompression plays the server's role, whose chain
        # skips only momentum (compressor_registry.cc:40-56): the worker
        # chain would apply momentum a second time to the merged shard
        merge_kwargs = {k: v for k, v in kwargs.items()
                        if k != "momentum_type"}
        for b in self.buckets:
            if b.size * itemsize(b.dtype) < min_compress_bytes:
                comp = merge = None
                shard = 0
            elif self.exchange == "rs":
                shard = -(-b.size // world)          # ceil: zero-padded
                comp = base.create(kwargs, shard, b.dtype)
                merge = base.create(merge_kwargs, shard, b.dtype)
            else:
                comp, merge, shard = base.create(kwargs, b.size, b.dtype), \
                    None, 0
            self.compressors.append(comp)
            self.merge_compressors.append(merge)
            self.shard_sizes.append(shard)

    @property
    def n_compressed(self) -> int:
        return sum(c is not None for c in self.compressors)

    def init_state(self, device=None) -> list:
        """One state per bucket: () for a plain bucket; the compressor's
        for the gather exchange; for rs, (a list of ``world`` per-shard
        states, the merge chain's state)."""
        if self.exchange == "rs":
            return [() if c is None else
                    ([c.init_state(device) for _ in range(self.world)],
                     mc.init_state(device))
                    for c, mc in zip(self.compressors,
                                     self.merge_compressors)]
        return [() if c is None else c.init_state(device)
                for c in self.compressors]

    def reduce(self, tensors: Sequence[torch.Tensor], states: list,
               group=None, average: bool = True) -> list:
        """Bucketed compressed all-reduce, IN PLACE on ``tensors`` (the
        leaves in the order of the plan's specs) over ``group`` (default:
        the data group). Returns the new compressor states. Its work is
        the profiler range ``bps::compressed_reduce``."""
        if group is None:
            group = data_group()
        n = dp_size(group)
        if self.exchange == "rs" and n != self.world:
            raise ValueError(
                f"exchange='rs' plan was built for world {self.world} but "
                f"the group reduces over {n} replicas; rebuild the plan "
                "(trainers do)")
        flat = [t.view(-1) for t in tensors]
        new_states = []
        with torch.profiler.record_function("bps::compressed_reduce"):
            for b, comp, mcomp, shard, st in zip(
                    self.buckets, self.compressors, self.merge_compressors,
                    self.shard_sizes, states):
                buf = _pack_bucket(flat, b)
                if comp is None:
                    red = psum_reducer(buf, group)
                    if average:
                        red = red / n
                elif self.exchange == "rs":
                    red, st = self._reduce_rs(buf, comp, mcomp, shard, st,
                                              group, b, n, average)
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

    def _reduce_rs(self, buf, comp, mcomp, shard: int, st, group, b, n: int,
                   average: bool):
        """The reduce-scatter-shaped exchange of one bucket (module
        docstring); returns (the reduced bucket, its new state)."""
        world = self.world
        shard_states, merge_state = st
        padded = buf.new_zeros(shard * world)
        padded[:b.size] = buf
        payloads, new_shard_states = [], []
        for i, x in enumerate(padded.view(world, shard)):
            p, s = comp.compress(x, shard_states[i])
            payloads.append(p)
            new_shard_states.append(s)
        # the leading dim is the destination shard
        recv = {k: _all_to_all(torch.stack([p[k] for p in payloads]), group)
                for k in payloads[0]}
        merged = torch.zeros(shard, dtype=buf.dtype, device=buf.device)
        for i in range(world):
            merged = merged + comp.decompress({k: v[i]
                                               for k, v in recv.items()})
        # the pad tail decompresses to garbage (onebit: +scale) that would
        # inflate the merge compressor's scale and poison its error
        # feedback; only the last shards hold padding
        my = 0 if group is None else dist.get_rank(group)
        real = b.size - my * shard
        if real < shard:
            merged[max(real, 0):] = 0
        if average:
            merged = merged / n        # averaged before the recompress
        mpay, new_merge_state = mcomp.compress(merged, merge_state)
        gathered = {k: _all_gather(v.reshape(-1), group)
                    for k, v in mpay.items()}
        full = torch.cat([mcomp.decompress(
            {k: v[i].reshape(mpay[k].shape) for k, v in gathered.items()})
            for i in range(world)])
        return full[:b.size], (new_shard_states, new_merge_state)
