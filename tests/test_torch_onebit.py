"""The port's onebit compression (pack/unpack kernels' plain versions, the
compressor, its decorators and the compressed reduction) held against the
JAX package on the CPU.

On the CPU the port's ``onebit_pack`` / ``onebit_unpack`` take their plain
versions; the JAX Pallas kernels run in interpret mode (their own module
picks it off the TPU), and the JAX ``jnp`` path runs as well. The same
numpy inputs go through all of them.

Tolerances, with their reasons:
  - packed words and unpacked signs: bit for bit (the contract is bytes);
  - the scale mean|x|, the error-feedback memory, the momentum and the
    reduced gradient: 1e-5 relative + 1e-5 absolute, fp32. The two sides
    take the mean in another summation order, which moves the scale by an
    ulp or so, XLA may fuse the decorators' multiply-adds where PyTorch
    rounds twice, and three steps of momentum and error feedback carry
    both forward (10 ulp, 1.2e-6 at |x| ~ 2, is the largest seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from byteps_tpu.common.partition import LeafSpec as JLeafSpec
from byteps_tpu.ops.compression import base as jbase
from byteps_tpu.ops.compression import pallas_kernels as jpk
from byteps_tpu.ops.compression.onebit import OnebitCompressor as JOnebit
from byteps_tpu.ops.compression.reducer import CompressionPlan as JPlan
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu_torch.common.partition import LeafSpec
from byteps_tpu_torch.ops.compression import base, kernels
from byteps_tpu_torch.ops.compression.reducer import CompressionPlan

README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _adversarial():
    """±0.0, NaN, ±inf, denormals and the smallest normals of both signs,
    then random values; 77 elements (not a multiple of 32)."""
    f = np.float32
    tiny = np.finfo(f).tiny
    head = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                     tiny / 4, -tiny / 4, tiny, -tiny, 1.0, -1.0], f)
    rest = np.random.RandomState(0).randn(77 - head.size).astype(f)
    return np.concatenate([head, rest])


CASES = {
    "adversarial_77": _adversarial,
    "one_element": lambda: np.array([-3.0], np.float32),
    "one_word": lambda: np.random.RandomState(1).randn(32).astype(np.float32),
    "bucket_1024000": lambda: np.random.RandomState(2).randn(
        4_096_000 // 4).astype(np.float32),
}


def _words(jwords):
    return np.asarray(jwords).view(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_is_bit_identical_to_pallas_and_jnp(case):
    x = CASES[case]()
    n = x.size
    chunks = (n + 31) // 32
    got = kernels.onebit_pack(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (chunks,)
    pallas = _words(jpk.onebit_pack(jnp.asarray(x), chunks))
    jnp_path = _words(JOnebit(n, backend="jnp").compress(
        jnp.asarray(x))[0]["packed"])
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), jnp_path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unpack_is_bit_identical_to_pallas_and_jnp(case):
    x = CASES[case]()
    n = x.size
    words = kernels.onebit_pack(torch.from_numpy(x))
    got = kernels.onebit_unpack(words, n).numpy()
    jwords = jax.lax.bitcast_convert_type(jnp.asarray(words.numpy()),
                                          jnp.uint32)
    pallas = np.asarray(jpk.onebit_unpack(jwords, n))
    jnp_path = np.asarray(JOnebit(n, backend="jnp").decompress(
        {"packed": jwords, "scale": jnp.float32(1.0)}))
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  jnp_path.view(np.int32))


def test_pack_msb_first_and_comparison_not_sign_bit():
    x = torch.zeros(64)
    x[0] = -1.0            # element 0 -> top bit of word 0
    x[33] = -2.0           # element 1 of word 1
    x[2] = -0.0            # -0.0 < 0 is false: packs as 0
    x[3] = float("nan")    # NaN < 0 is false: packs as 0
    words = kernels.onebit_pack(x).tolist()
    assert words == [-(1 << 31), 1 << 30]
    signs = kernels.onebit_unpack(torch.tensor(words, dtype=torch.int32), 64)
    assert signs[0] == -1.0 and signs[33] == -1.0
    assert (signs[[1, 2, 3, 32]] == 1.0).all()


def _chain(c):
    names = []
    while c is not None:
        names.append((type(c).__name__, getattr(c, "mu", None),
                      getattr(c, "use_scale", None)))
        c = getattr(c, "inner", None)
    return names


@pytest.mark.parametrize("ef", [None, "vanilla"])
@pytest.mark.parametrize("mom", [None, "nesterov"])
@pytest.mark.parametrize("scaling", ["true", "false"])
def test_create_builds_the_jax_packages_chain(ef, mom, scaling):
    kw = {"compressor_type": "onebit", "compressor_onebit_scaling": scaling,
          "momentum_mu": "0.8"}
    if ef:
        kw["ef_type"] = ef
    if mom:
        kw["momentum_type"] = mom
    assert _chain(base.create(kw, 100)) == _chain(jbase.create(kw, 100))
    assert base.create({}, 100) is None


@pytest.mark.parametrize("kind", ["topk", "randomk", "dithering"])
def test_unported_compressors_raise(kind):
    """The JAX package's other three compressors, refused until their
    port, now build: ``create`` gives the JAX package's chain (momentum
    -> error feedback -> the compressor) and the chain round-trips a
    buffer; only a name neither package registers raises."""
    assert base.registered_names() == jbase.registered_names()
    kw = {"compressor_type": kind, "ef_type": "vanilla",
          "momentum_type": "nesterov", "compressor_k": "0.5"
          if kind != "dithering" else "4"}
    comp = base.create(kw, 100)
    assert _chain(comp) == _chain(jbase.create(kw, 100))
    assert comp.payload_nbytes() == jbase.create(kw, 100).payload_nbytes()
    x = torch.from_numpy(np.random.RandomState(1).randn(100)
                         .astype(np.float32))
    pay, st = comp.compress(x, comp.init_state())
    y = comp.decompress(pay)
    assert y.shape == x.shape and y.dtype == x.dtype and bool(y.any())
    assert torch.allclose(st["inner"]["error"], x * 1.9 - y,   # (1 + μ)x
                          atol=1e-5)
    with pytest.raises(ValueError, match="no compressor"):
        base.create({"compressor_type": "bogus"}, 100)


@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_three_compress_calls_match_jax(backend):
    """README chain (onebit + scale, vanilla EF, Nesterov): three
    compress/decompress rounds on the same inputs. Packed words bit for
    bit; scale, EF error and momentum within the fp32 tolerance."""
    n = 1000
    kw = dict(README_KW, compressor_backend=backend)
    jkw = dict(README_KW, compressor_backend="pallas" if backend == "auto"
               else "jnp")
    comp, jcomp = base.create(kw, n), jbase.create(jkw, n)
    st, jst = comp.init_state(), jcomp.init_state()
    rng = np.random.RandomState(3)
    for step in range(3):
        x = rng.randn(n).astype(np.float32)
        pay, st = comp.compress(torch.from_numpy(x), st)
        jpay, jst = jcomp.compress(jnp.asarray(x), jst)
        np.testing.assert_array_equal(pay["packed"].numpy(),
                                      _words(jpay["packed"]),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(pay["scale"].item(), float(jpay["scale"]),
                                   **TOL)
        np.testing.assert_allclose(comp.decompress(pay).numpy(),
                                   np.asarray(jcomp.decompress(jpay)), **TOL)
        np.testing.assert_allclose(st["m"].numpy(), np.asarray(jst["m"]),
                                   **TOL)
        np.testing.assert_allclose(st["inner"]["error"].numpy(),
                                   np.asarray(jst["inner"]["error"]), **TOL)
        assert float(st["inner"]["lr_prev"]) == float(jst["inner"]["lr_prev"])


def _specs(sizes):
    return ([LeafSpec(f"l{i}", s, "float32") for i, s in enumerate(sizes)],
            [JLeafSpec(f"l{i}", s, "float32") for i, s in enumerate(sizes)])


def test_plan_compresses_the_buckets_the_jax_plan_does():
    sizes = [3000, 17, 40000, 5, 12000]
    specs, jspecs = _specs(sizes)
    plan = CompressionPlan(specs, 16384, README_KW, min_compress_bytes=8192)
    jplan = JPlan(jspecs, 16384, README_KW, min_compress_bytes=8192)
    assert [(b.size, b.dtype, [tuple(vars(s).values()) for s in b.segments])
            for b in plan.buckets] == \
        [(b.size, b.dtype, [tuple(vars(s).values()) for s in b.segments])
         for b in jplan.buckets]
    assert [c is None for c in plan.compressors] == \
        [c is None for c in jplan.compressors]
    assert 0 < plan.n_compressed < len(plan.buckets)


def test_plan_refuses_the_rs_exchange():
    """The rs exchange builds (``test_torch_compress_rs.py`` holds it
    against the JAX plan); the plan refuses it only without a world to
    shard over, and refuses an unknown exchange, as the JAX plan does."""
    specs, jspecs = _specs([100, 5000])
    kw = dict(README_KW, exchange="rs")
    plan = CompressionPlan(specs, 4096, kw, min_compress_bytes=1024, world=3)
    jplan = JPlan(jspecs, 4096, kw, min_compress_bytes=1024, world=3)
    assert plan.shard_sizes == jplan.shard_sizes and plan.n_compressed > 0
    assert [_chain(c) for c in plan.merge_compressors] == \
        [_chain(c) for c in jplan.merge_compressors]
    with pytest.raises(ValueError, match="world"):
        CompressionPlan(specs, 4096, kw, world=0)
    with pytest.raises(ValueError, match="gather"):
        CompressionPlan(specs, 4096, dict(README_KW, exchange="bogus"))


def test_world_one_reduction_matches_jax_reduce_tree():
    """Three reductions at world 1: the JAX plan inside shard_map over a
    1-device mesh (the size-1 axis is kept, as the JAX trainer keeps it on
    lossy paths) against the port's plan with no process group. Small
    buckets take the plain (identity) sum, the rest compress and
    decompress."""
    sizes = [3000, 17, 40000, 5, 12000]
    specs, jspecs = _specs(sizes)
    plan = CompressionPlan(specs, 16384, README_KW, min_compress_bytes=8192)
    jplan = JPlan(jspecs, 16384, README_KW, min_compress_bytes=8192)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])

    def jstep(leaves, states):
        tree, st = jplan.reduce_tree(list(leaves), states, ("data",))
        return tree, st

    jfn = jax.jit(jax.shard_map(jstep, mesh=mesh, in_specs=(P(), P()),
                                out_specs=(P(), P()), check_vma=False))
    jst, st = jplan.init_state(), plan.init_state()
    rng = np.random.RandomState(4)
    for step in range(3):
        grads = [rng.randn(s).astype(np.float32) for s in sizes]
        jout, jst = jfn([jnp.asarray(g) for g in grads], jst)
        tgrads = [torch.from_numpy(g.copy()) for g in grads]
        st = plan.reduce(tgrads, st)
        for i, (t, j) in enumerate(zip(tgrads, jout)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=f"step {step} leaf {i}", **TOL)
        for i, (c, s) in enumerate(zip(plan.compressors, st)):
            if c is None:
                continue
            np.testing.assert_allclose(s["m"].numpy(), np.asarray(jst[i]["m"]),
                                       **TOL)
            np.testing.assert_allclose(
                s["inner"]["error"].numpy(),
                np.asarray(jst[i]["inner"]["error"]), **TOL)
