"""The port's T5 relative-position bucketing (``byteps_tpu_torch/ops/
relpos.py``) held against the JAX package's, on the CPU.

The bucket is the one value the flash kernels' table form cannot compute
themselves without risk: the float32 expression lands exactly on integers
at some offsets (|n| = 16, 32, 64 in the bidirectional 32-bucket form),
where a logarithm one ulp low truncates one bucket down. So the port
computes it once on the CPU in float32, as the JAX function does, and the
kernels index that vector. Every comparison here is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import relpos as jrel
from byteps_tpu_torch.ops import relpos as trel

OFFSETS = np.arange(-4096, 4097, dtype=np.int32)
GEOMETRIES = [(32, 128), (16, 64), (128, 512)]


@pytest.mark.parametrize("nb,maxd", GEOMETRIES,
                         ids=[f"nb{n}-maxd{m}" for n, m in GEOMETRIES])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
def test_bucket_is_the_jax_packages_over_4096_offsets(bidirectional, nb,
                                                      maxd):
    want = np.asarray(jrel.relative_position_bucket(
        jnp.asarray(OFFSETS), bidirectional, nb, maxd))
    got = trel.relative_position_bucket(torch.from_numpy(OFFSETS),
                                        bidirectional, nb, maxd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_exact_log_boundaries_land_in_their_own_bucket():
    """|n| = 16, 32, 64 are the float32 boundaries of buckets 10, 12, 14
    (16 more for keys after the query); the causal form starts its log
    range at n = 16 (bucket 16) and maps keys after the query to 0."""
    rel = torch.tensor([-64, -32, -16, 16, 32, 64], dtype=torch.int32)
    assert trel.relative_position_bucket(rel, True).tolist() == \
        [14, 12, 10, 26, 28, 30]
    assert trel.relative_position_bucket(rel, False).tolist() == \
        [26, 21, 16, 0, 0, 0]


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 320), (320, 64)])
def test_relative_bias_is_the_jax_packages(bidirectional, sq, sk):
    table = np.random.RandomState(sq + sk).randn(32, 4).astype(np.float32)
    want = np.asarray(jrel.relative_bias(jnp.asarray(table), sq, sk,
                                         bidirectional))
    got = trel.relative_bias(torch.from_numpy(table), sq, sk, bidirectional)
    assert got.dtype == torch.float32 and got.shape == (4, sq, sk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
def test_offset_vector_gives_the_bucket_of_every_query_key_pair(
        bidirectional):
    """The kernels' per-offset vector (sq + sk - 1 entries) indexed at
    key - query + sq - 1 is the [sq, sk] bucket map."""
    sq, sk = 192, 320
    vec = trel.offset_buckets(sq, sk, bidirectional)
    assert vec.dtype == torch.int32 and vec.shape == (sq + sk - 1,)
    rel = (torch.arange(sk)[None, :] - torch.arange(sq)[:, None]).int()
    want = trel.relative_position_bucket(rel, bidirectional)
    got = trel.bucket_map(sq, sk, bidirectional)
    assert torch.equal(got, want.long())
    assert torch.equal(vec.long()[rel + sq - 1], want.long())


def test_bucket_vector_is_built_once_per_geometry():
    a = trel.bucket_vector(512, 512, False, 32, 128, "cpu")
    assert trel.bucket_vector(512, 512, False, 32, 128, "cpu") is a
    assert trel.bucket_vector(512, 512, True, 32, 128, "cpu") is not a
    assert torch.equal(a, trel.offset_buckets(512, 512, False))
