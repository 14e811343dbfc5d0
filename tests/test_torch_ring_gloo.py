"""The port's ring attention over a gloo ring of 2 and of 4 processes on
the CPU, held against the JAX ring on a 2- and a 4-device CPU mesh.

Each rank (``_torch_sp_worker.py``, mode "ring") takes its sequence shard
of the same seeded q, k, v (b 1, s 512, h 2, d 16, fp32:
``tests/test_ring.py``'s flash-ring shape), runs the port's flash ring
(the kernels' plain versions) and naive ring, causal and full, with the
per-rank loss sum(o · (o + 1)), and saves its output and gradient
shards. Both are held against the JAX flash ring (Pallas interpret mode)
and the JAX naive ring, whose gradients are those of the sum of the
ranks' losses, as each rank's backward gives them here.

Tolerances as ``tests/test_ring.py``'s flash-vs-naive check: 1e-4 on the
summed loss, 2e-3 on out and gradients (fp32; the rings sum block by
block in different orders). Every wait is bounded (60 s rendezvous, 120 s
a rank); every process is reaped.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_sp_worker import Ranks
from byteps_tpu.parallel import ring as jring
from byteps_tpu.parallel.mesh import make_mesh as jmake_mesh

SHAPE = (1, 512, 2, 16)
SPS = (2, 4)


def _inputs():
    rng = np.random.RandomState(2)
    q = rng.randn(*SHAPE).astype(np.float32) * 0.5
    k = rng.randn(*SHAPE).astype(np.float32) * 0.5
    v = rng.randn(*SHAPE).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both gloo worlds, started before any JAX reference is computed."""
    tmp = tmp_path_factory.mktemp("ring_gloo")
    q, k, v = _inputs()
    np.savez(tmp / "inputs.npz", q=q, k=k, v=v)
    worlds = {sp: Ranks("ring", sp, tmp / "inputs.npz", tmp) for sp in SPS}
    yield worlds
    for w in worlds.values():
        w.close()


@functools.lru_cache(maxsize=None)
def _jax_ring(sp, impl, causal):
    """(summed loss, out, (dq, dk, dv)) of the JAX ring on ``sp`` CPU
    devices."""
    mesh = jmake_mesh({"seq": sp}, devices=jax.devices()[:sp])
    spec = P(None, "seq")

    def f(q, k, v):
        def loss(q, k, v):
            o = jring.ring_attention(q, k, v, "seq", causal=causal,
                                     impl=impl, interpret=True)
            return (o * (o + 1.0)).sum(), o
        (l, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
        return jax.lax.psum(l, "seq"), o, g

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=spec,
                               out_specs=(P(), spec, spec), check_vma=False))
    sh = NamedSharding(mesh, spec)
    l, o, g = fn(*(jax.device_put(jnp.asarray(x), sh) for x in _inputs()))
    return float(l), np.asarray(o), tuple(np.asarray(x) for x in g)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("sp", SPS)
def test_ring_over_gloo_matches_jax_rings(ranks, sp, impl, causal):
    # the JAX references first: the ranks run meanwhile
    refs = {jimpl: _jax_ring(sp, jimpl, causal) for jimpl in ("flash",
                                                              "naive")}
    res = ranks[sp].result()
    tag = f"{impl}_{int(causal)}"
    out = np.concatenate([r[f"o_{tag}"] for r in res], axis=1)
    grads = [np.concatenate([r[f"d{n}_{tag}"] for r in res], axis=1)
             for n in "qkv"]
    loss = float((out.astype(np.float64) * (out + 1.0)).sum())
    for jimpl, (jl, jo, jg) in refs.items():
        np.testing.assert_allclose(loss, jl, rtol=1e-4, err_msg=jimpl)
        np.testing.assert_allclose(out, jo, rtol=2e-3, atol=2e-3,
                                   err_msg=jimpl)
        for got, ref, n in zip(grads, jg, "qkv"):
            np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3,
                                       err_msg=f"{jimpl} d{n}")
