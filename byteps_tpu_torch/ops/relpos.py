"""T5 relative-position bucketing for the port (its own copy of
``byteps_tpu/ops/relpos.py``), shared by the T5 model and the flash
kernels' rel-table form.

The bucket depends only on the offset key - query, so a [sq, sk] bucket
map holds only sq + sk - 1 distinct values. ``offset_buckets`` computes
them once, on the CPU, in float32 with truncation exactly as the JAX
function does; the Hopper kernels index that vector (``bucket_vector``
caches it on the card) and never compute a logarithm themselves. The
bucket expression lands exactly on integers at some offsets (|n| = 16, 32
and 64 in the bidirectional 32-bucket, max-distance-128 form), where a
device ``logf`` one ulp low would put the offset one bucket down.
``relative_bias`` (the materialized [h, sq, sk] form) serves the naive
attention path and the tests.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["relative_position_bucket", "relative_bias", "offset_buckets",
           "bucket_vector", "bucket_map"]


def relative_position_bucket(rel: torch.Tensor, bidirectional: bool,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's log-spaced bucketing of ``rel`` = key - query (an int tensor).
    Bidirectional (encoder): half the buckets for each sign; causal
    (decoder): future offsets collapse to bucket 0. Near offsets get exact
    buckets, far ones log-spaced up to ``max_distance``. Float32 with the
    logarithm's divisor rounded to float32 and a truncating cast, as the
    JAX function computes it."""
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.tensor(math.log(max_distance / max_exact),
                             dtype=torch.float32)
    val_large = max_exact + (
        torch.log(n.clamp_min(1).to(torch.float32) / max_exact)
        / log_ratio * (num_buckets - max_exact)).to(rel.dtype)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def offset_buckets(sq: int, sk: int, bidirectional: bool,
                   num_buckets: int = 32,
                   max_distance: int = 128) -> torch.Tensor:
    """int32 [sq + sk - 1] on the CPU: entry ``off + sq - 1`` is the bucket
    of offset ``off`` = key - query, for off in [-(sq - 1), sk - 1]."""
    rel = torch.arange(-(sq - 1), sk, dtype=torch.int32)
    return relative_position_bucket(rel, bidirectional, num_buckets,
                                     max_distance)


@functools.lru_cache(maxsize=64)
def bucket_vector(sq: int, sk: int, bidirectional: bool, num_buckets: int,
                  max_distance: int, device: str) -> torch.Tensor:
    """``offset_buckets`` on ``device``, computed once per geometry: O(s)
    memory, the only bucket data the kernels read."""
    return offset_buckets(sq, sk, bidirectional, num_buckets,
                          max_distance).to(device)


def bucket_map(sq: int, sk: int, bidirectional: bool, num_buckets: int = 32,
               max_distance: int = 128, device="cpu") -> torch.Tensor:
    """int64 [sq, sk] bucket of every (query, key): the offset vector
    gathered at key - query + sq - 1 (the plain versions' view)."""
    vec = bucket_vector(sq, sk, bool(bidirectional), int(num_buckets),
                        int(max_distance), str(torch.device(device)))
    idx = (torch.arange(sk, device=vec.device)[None, :]
           - torch.arange(sq, device=vec.device)[:, None] + sq - 1)
    return vec.long()[idx]


def relative_bias(table: torch.Tensor, sq: int, sk: int, bidirectional: bool,
                  num_buckets: int = 32,
                  max_distance: int = 128) -> torch.Tensor:
    """[num_buckets, heads] table -> the MATERIALIZED [heads, sq, sk] fp32
    additive score bias: O(h·sq·sk) memory, for the naive path and the
    tests; the flash kernels read the table and the offset vector
    instead."""
    bucket = bucket_map(sq, sk, bidirectional, num_buckets, max_distance,
                        table.device)
    return table.float()[bucket].permute(2, 0, 1)
