"""The port's reduce-scatter-shaped compressed exchange,
``CompressionPlan(exchange="rs")``, held against the JAX package's on the
CPU.

The rs plan runs at world 1 in this process, and at worlds 2 and 3 over
gloo processes (``_torch_sp_worker.py``, mode "rs"; world 3 gives buckets
that do not divide, so the zero-padded tail is masked before the merge
recompress), against the JAX plan inside ``shard_map`` on 1, 2 and 3 CPU
devices. Two chains over 3 rounds: topk (5%) with error feedback, and the
README's onebit (L1-mean scale, error feedback, Nesterov momentum on the
worker chain only). The reduced gradients, the per-shard states and the
merge chain's state are compared.

Tolerance: the exchanges' outputs and states 1e-5 relative + 1e-5
absolute (fp32; the onebit scale is a mean taken in another order, and
XLA may fuse the decorators' multiply-adds where PyTorch rounds twice, as
``test_torch_onebit.py`` states). Every wait on a gloo rank is bounded
(60 s rendezvous, 120 s a rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_sp_worker import Ranks
from byteps_tpu.common.partition import LeafSpec as JLeafSpec
from byteps_tpu.ops.compression.reducer import CompressionPlan as JPlan
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu_torch.common.partition import LeafSpec
from byteps_tpu_torch.ops.compression.reducer import CompressionPlan

TOL = dict(rtol=1e-5, atol=1e-5)
README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov",
             "exchange": "rs"}
CASES = {"topk": {"compressor_type": "topk", "compressor_k": "0.05",
                  "ef_type": "vanilla", "exchange": "rs"},
         "onebit": README_KW}
SIZES = [3000, 17, 40000, 5, 12001]
PARTITION, MIN_COMPRESS, ROUNDS = 16384, 8192, 3


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(world):
    """[rounds, world, total]: each rank's gradient leaves, concatenated."""
    rng = np.random.RandomState(50 + world)
    return rng.randn(ROUNDS, world, sum(SIZES)).astype(np.float32)


def _state_leaves(st, prefix, out):
    """{dotted path: array} of a state tree (dicts by sorted key, lists
    and tuples by position), as the gloo worker saves it."""
    if isinstance(st, dict):
        for k in sorted(st):
            _state_leaves(st[k], f"{prefix}.{k}", out)
    elif isinstance(st, (list, tuple)):
        for i, v in enumerate(st):
            _state_leaves(v, f"{prefix}.{i}", out)
    else:
        out[prefix] = np.asarray(st)
    return out


def _jax_rs(world, kw, grads):
    """The JAX plan in ``shard_map`` over ``world`` CPU devices, each
    device its own compressor state (a leading device axis, as the JAX
    trainer shards it): each round's reduced rows [world, total] and the
    final states."""
    jspecs = [JLeafSpec(f"l{i}", n, "float32") for i, n in enumerate(SIZES)]
    jplan = JPlan(jspecs, PARTITION, kw, MIN_COMPRESS, world=world)
    mesh = make_mesh({"data": world}, devices=jax.devices()[:world])

    def step(leaves, states):
        st = jax.tree.map(lambda x: x[0], states)
        out, st = jplan.reduce_tree([x[0] for x in leaves], st, ("data",))
        return [x[None] for x in out], jax.tree.map(lambda x: x[None], st)

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P("data"),
                                                          P("data")),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    st = jax.tree.map(lambda z: jnp.broadcast_to(z, (world,) + z.shape),
                      jplan.init_state())
    outs = []
    cuts = np.cumsum(SIZES)[:-1]
    for rows in grads:
        leaves = [jnp.asarray(x) for x in np.split(rows, cuts, axis=1)]
        got, st = fn(leaves, st)
        outs.append(np.concatenate([np.asarray(x) for x in got], axis=1))
    return outs, st, jplan


def _compare(case, world, port, jouts, jst, jplan):
    """``port``: one {key: array} a rank (the gloo worker's layout)."""
    for r in range(ROUNDS):
        for rank in range(world):
            np.testing.assert_allclose(port[rank][f"{case}.out{r}"],
                                       jouts[r][rank],
                                       err_msg=f"round {r} rank {rank}",
                                       **TOL)
    compared = 0
    for i, s in enumerate(jst):
        if jplan.compressors[i] is None:
            continue
        shard, merge = (_state_leaves(x, "", {}) for x in s)
        for rank in range(world):
            for path, a in shard.items():
                for j in range(world):
                    np.testing.assert_allclose(
                        port[rank][f"{case}.state{i}.0.{j}{path}"],
                        a[rank, j], err_msg=f"bucket {i} shard {j}{path}",
                        **TOL)
                    compared += 1
            for path, a in merge.items():
                np.testing.assert_allclose(
                    port[rank][f"{case}.state{i}.1{path}"], a[rank],
                    err_msg=f"bucket {i} merge{path}", **TOL)
                compared += 1
    assert compared > 0


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """Worlds 2 and 3 of gloo ranks, started before the JAX references
    are computed."""
    tmp = tmp_path_factory.mktemp("rs_gloo")
    worlds = {}
    for world in (2, 3):
        arrays = {"sizes": np.array(SIZES), "partition": PARTITION,
                  "min_compress": MIN_COMPRESS, "grads": _grads(world),
                  "cases": np.array(list(CASES))}
        for case, kw in CASES.items():
            arrays[f"{case}.keys"] = np.array(list(kw))
            arrays[f"{case}.values"] = np.array(list(kw.values()))
        src = tmp / f"rs{world}.npz"
        np.savez(src, **arrays)
        worlds[world] = Ranks("rs", world, src, tmp)
    yield worlds
    for w in worlds.values():
        w.close()


@pytest.mark.parametrize("case", list(CASES))
def test_rs_plan_at_world_one_is_the_jax_plans(case):
    """In this process, no group: the compressions run, the collectives
    drop (a world of one)."""
    kw = CASES[case]
    specs = [LeafSpec(f"l{i}", n, "float32") for i, n in enumerate(SIZES)]
    plan = CompressionPlan(specs, PARTITION, kw, MIN_COMPRESS, world=1)
    grads = _grads(1)
    st = plan.init_state()
    port = {}
    for r, rows in enumerate(grads):
        flat = torch.from_numpy(rows[0].copy())
        st = plan.reduce(list(flat.split(SIZES)), st)
        port[f"{case}.out{r}"] = flat.numpy().copy()
    for i, s in enumerate(st):
        if s != ():
            _state_leaves(s, f"{case}.state{i}", port)
    jouts, jst, jplan = _jax_rs(1, kw, grads)
    assert plan.shard_sizes == jplan.shard_sizes and plan.n_compressed > 1
    _compare(case, 1, [port], jouts, jst, jplan)


@pytest.mark.parametrize("world", [2, 3])
def test_rs_plan_over_gloo_is_the_jax_plan_on_cpu_devices(world,
                                                         gloo_worlds):
    # the JAX references first: the ranks run meanwhile
    refs = {case: _jax_rs(world, kw, _grads(world))
            for case, kw in CASES.items()}
    port = gloo_worlds[world].result(timeout=120)
    for case, (jouts, jst, jplan) in refs.items():
        if world == 3:          # padded shards: the tail mask is exercised
            assert any(s * world > b.size for s, b, c in zip(
                jplan.shard_sizes, jplan.buckets, jplan.compressors) if c)
        _compare(case, world, port, jouts, jst, jplan)
        # every rank holds the same reduced gradient, bit for bit
        for r in range(ROUNDS):
            for rank in range(1, world):
                assert port[rank][f"{case}.out{r}"].tobytes() == \
                    port[0][f"{case}.out{r}"].tobytes()
