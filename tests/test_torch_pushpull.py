"""The port's BytePS API at world 1 on the CPU, held against the JAX
package in the same process: ``PushPullEngine`` plans and names,
``push_pull`` / handles, the PS hop at int8 and fp8, the telemetry
window, ``suspend``/``resume`` and the debug sampler.

The JAX engine is single-controller and takes stacked ``[dp, ...]``
leaves; here it runs on a one-device mesh, so its one row is the port's
tensor. Tolerance: none — plans, keys, names and payloads are exact, and
so are the sums (the same numpy codec on the same bytes).
"""

import collections
import logging

import jax
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.common.global_state import GlobalState as JGlobalState
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.collectives import PushPullEngine as JEngine
from byteps_tpu.parallel.mesh import make_mesh
import byteps_tpu_torch as bps
from byteps_tpu_torch.common.global_state import GlobalState
from byteps_tpu_torch.parallel.collectives import tree_flatten

_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BPS_COORDINATOR_ADDRESS", "DMLC_PS_ROOT_URI",
        "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS", "BPS_ENABLE_ASYNC",
        "BYTEPS_ENABLE_ASYNC", "BPS_SERVER_ADDRS", "BPS_COMPRESS",
        "BPS_COMPRESS_DEVICE", "BPS_SCHEDULING_CREDIT",
        "BYTEPS_SCHEDULING_CREDIT", "BPS_TELEMETRY_ON",
        "BYTEPS_TELEMETRY_ON", "BPS_DEBUG_SAMPLE_TENSOR",
        "BYTEPS_DEBUG_SAMPLE_TENSOR", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
        "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF", "BPS_MIN_COMPRESS_BYTES",
        "BPS_PARTITION_BYTES", "BPS_HOST_ONLY")
PART = 64 << 10          # bytes a bucket: BERT-tiny takes several


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_PARTITION_BYTES", str(PART))
    monkeypatch.setenv("BPS_APPLY_CHUNKED", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    bps.shutdown()
    jbps.shutdown()
    torch.set_num_threads(n)


def _mesh1():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


def _init_both():
    bps.init(device="cpu")
    jbps.init(mesh=_mesh1())


def _tiny_grads(seed=0):
    """A BERT-tiny gradient tree: the JAX parameter tree's structure with
    seeded values, as numpy."""
    params = jtr.init_params(jax.random.PRNGKey(0), jbert.bert_tiny())
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), params)


def _torch_tree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _stacked(tree):
    return jax.tree_util.tree_map(lambda x: x[None], tree)


def _bucket_fields(b):
    return (b.index, b.size, b.dtype, b.priority,
            tuple((s.leaf_index, s.leaf_offset, s.bucket_offset, s.length)
                  for s in b.segments))


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("overrides", [False, True],
                         ids=["default_priorities", "declared_priorities"])
def test_engine_plans_equal_the_jax_engines(overrides):
    """The same BERT-tiny gradient dict planned by both engines: the same
    buckets, segment for segment, with every priority at its default
    (reverse declaration order) and with ``declare_tensor`` overrides."""
    _init_both()
    grads = _tiny_grads()
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(grads)]
    if overrides:
        for i, p in enumerate(paths[::3]):
            for api in (bps, jbps):
                api.declare_tensor(f"g.{p}", priority=100 - 7 * i)
    port = GlobalState.get().engine
    tpaths, leaves, treedef = tree_flatten(_torch_tree(grads))
    ours = port._plan(tpaths, leaves, treedef, "g")
    jeng = JGlobalState.get().engine
    _, progs, _ = jeng._plan(_stacked(grads), True, "g")
    theirs = [b for _, _, b in progs]
    assert len(ours) > 4
    assert [_bucket_fields(b) for b in ours] \
        == [_bucket_fields(b) for b in theirs]
    names = GlobalState.get().registry.declared_names()
    assert names == JGlobalState.get().registry.declared_names()
    for n in names:
        assert GlobalState.get().registry.get(n).priority \
            == JGlobalState.get().registry.get(n).priority


Point = collections.namedtuple("Point", "x y")


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": [2, (3, 4)], "c": {"z": 5, "y": None}},
    [Point(1, {"k": 2}), (3,)],
    collections.OrderedDict([("z", 1), ("a", [2, 3])]),
    {"bert": {"w": 1, "ln": {"scale": 2}}, "head": [(5, 6)]},
], ids=["dict", "namedtuple", "ordereddict", "nested"])
def test_leaf_names_are_keystr(tree):
    paths, leaves, treedef = tree_flatten(tree)
    jl = jax.tree_util.tree_leaves_with_path(tree)
    assert paths == [jax.tree_util.keystr(p) for p, _ in jl]
    assert leaves == [v for _, v in jl]
    from byteps_tpu_torch.parallel.collectives import tree_unflatten
    assert tree_unflatten(treedef, leaves) == tree


def test_push_pull_declares_the_jax_engines_names_and_keys():
    _init_both()
    grads = _tiny_grads()
    bps.push_pull(_torch_tree(grads), name="grads")
    bps.push_pull(_torch_tree({"x": grads}))
    jbps.push_pull(_stacked(grads), name="grads")
    jbps.push_pull(_stacked({"x": grads}))
    reg, jreg = GlobalState.get().registry, JGlobalState.get().registry
    names = reg.declared_names()
    assert names == jreg.declared_names() and len(names) > 10
    assert [reg.get(n).declared_key for n in names] \
        == [jreg.get(n).declared_key for n in names]


# -------------------------------------------------------------- handles

def test_world_one_returns_new_tensors_equal_to_the_inputs():
    bps.init(device="cpu")
    x = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    out = bps.push_pull(x)
    for k in x:
        assert torch.equal(out[k], x[k])
        assert out[k].data_ptr() != x[k].data_ptr()
    assert GlobalState.get().engine.ps_exchange is None


def test_async_roundtrip_matches_sync():
    bps.init(device="cpu")
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    h = bps.push_pull_async(tree, average=True)
    out = bps.synchronize(h)
    ref = bps.push_pull(tree, average=True)
    for k in tree:
        assert torch.equal(out[k], ref[k])


def test_handle_is_single_use_and_poll_turns_true():
    bps.init(device="cpu")
    h = bps.push_pull_async({"x": torch.ones(16)})
    assert bps.poll(h)                 # world 1: nothing in flight
    out = bps.synchronize(h)
    assert torch.equal(out["x"], torch.ones(16))
    with pytest.raises(KeyError):
        bps.synchronize(h)
    with pytest.raises(KeyError):
        bps.poll(h)


def test_many_handles_in_flight():
    bps.init(device="cpu")
    hs = [bps.push_pull_async({"x": torch.full((8,), float(i))})
          for i in range(5)]
    for i, h in reversed(list(enumerate(hs))):
        assert torch.equal(bps.synchronize(h)["x"], torch.full((8,), float(i)))


# ------------------------------------------------------------- PS mode

def _ps_tree(seed):
    rng = np.random.RandomState(seed)
    return {"emb": (rng.randn(300, 97) * 3).astype(np.float32),
            "w": [rng.randn(40000).astype(np.float32),
                  (rng.randn(17, 33) * 0.1).astype(np.float32)],
            "b": rng.randn(5).astype(np.float32)}


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3"])
def test_ps_push_pull_is_the_jax_engines_bit_for_bit(codec, monkeypatch):
    """``BPS_ENABLE_PS=1`` at ``BPS_COMPRESS=codec``: three rounds through
    the sync and the async (deferred-hop) paths, and a second tree; every
    result the JAX engine's on the same values, bit for bit (error
    feedback carries between rounds)."""
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_COMPRESS", codec)
    _init_both()
    assert GlobalState.get().engine.ps_exchange.n_compressed() == 0
    for rnd in range(3):
        tree = _ps_tree(rnd)
        if rnd == 1:
            h = bps.push_pull_async(_torch_tree(tree), name="grads")
            g = bps.push_pull_async(_torch_tree({"o": tree["b"]}))
            ours = bps.synchronize(h)
            other = bps.synchronize(g)
            jh = jbps.push_pull_async(_stacked(tree), name="grads")
            jg = jbps.push_pull_async(_stacked({"o": tree["b"]}))
            theirs = jbps.synchronize(jh)
            jother = jbps.synchronize(jg)
            assert np.asarray(jother["o"])[0].tobytes() \
                == other["o"].numpy().tobytes()
        else:
            ours = bps.push_pull(_torch_tree(tree), name="grads")
            theirs = jbps.push_pull(_stacked(tree), name="grads")
        tl = jax.tree_util.tree_leaves(ours)
        jl = jax.tree_util.tree_leaves(theirs)
        for a, b, x in zip(tl, jl, jax.tree_util.tree_leaves(tree)):
            assert a.numpy().tobytes() == np.asarray(b)[0].tobytes()
            assert a.shape == x.shape
        # lossy: the codec did act
        assert any(not np.array_equal(a.numpy(), x) for a, x in zip(
            tl, jax.tree_util.tree_leaves(tree)))
    assert GlobalState.get().engine.ps_exchange.n_compressed() > 0


@pytest.mark.parametrize("average", [True, False])
def test_bucketed_allreduce_lands_in_place_as_push_pull_returns(
        average, monkeypatch):
    """A world of two (collectives faked: each doubles its bucket when
    waited on): the trainer's in-place ``bucketed_allreduce`` and the
    engine's ``push_pull`` go through the same bucket loop, so the leaves
    it writes in place are bit for bit the tensors ``push_pull`` returns,
    and every bucket is packed before any lands."""
    from byteps_tpu_torch.parallel import collectives
    events = []

    class Work:
        def __init__(self, buf):
            self.buf, self.done = buf, False

        def is_completed(self):
            return self.done

        def wait(self):
            if not self.done:
                self.buf.mul_(2)
                self.done = True
                events.append("land")

    def all_reduce(buf, op=None, group=None, async_op=False):
        events.append("send")
        return Work(buf)

    monkeypatch.setattr(collectives.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(collectives, "data_group", lambda: "two-ranks")
    monkeypatch.setattr(collectives, "dp_size", lambda group=None: 2)
    grads = _tiny_grads(3)
    paths, leaves, _ = tree_flatten(_torch_tree(grads))
    bps.init(device="cpu")
    want = tree_flatten(bps.push_pull(_torch_tree(grads), average=average,
                                      name="g"))[1]
    events.clear()
    inplace = [t.clone() for t in leaves]
    collectives.bucketed_allreduce(inplace, partition_bytes=PART,
                                   average=average,
                                   names=[f"g.{p}" for p in paths])
    n = events.count("send")
    assert n > 1 and events == ["send"] * n + ["land"] * n
    for a, b in zip(inplace, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# ------------------------------------------------ telemetry, replay, sampler

def test_pushpull_speed_gives_the_jax_numbers(monkeypatch):
    from byteps_tpu.telemetry import PushPullSpeed as JSpeed
    from byteps_tpu_torch.telemetry import PushPullSpeed
    clock = [1000.0]
    monkeypatch.setattr("time.time", lambda: clock[0])
    ours, theirs = PushPullSpeed(), JSpeed()
    rng = np.random.RandomState(5)
    for _ in range(60):
        clock[0] += float(rng.exponential(0.4))
        nbytes, dur = int(rng.randint(1, 1 << 24)), float(rng.exponential(2))
        ours.record(nbytes, dur)
        theirs.record(nbytes, dur)
        assert ours.mbps() == theirs.mbps()
        assert list(ours._events) == list(theirs._events)
    clock[0] += 11.0
    assert ours.mbps() == theirs.mbps() == 0.0


def test_telemetry_on_records_push_pulls(monkeypatch):
    monkeypatch.setenv("BPS_TELEMETRY_ON", "1")
    bps.init(device="cpu")
    assert bps.get_pushpull_speed() == 0.0
    bps.push_pull({"x": torch.ones(1 << 16)})
    assert bps.get_pushpull_speed() > 0.0


def test_suspend_resume_keeps_every_key_jax_keeps():
    _init_both()
    grads = _tiny_grads()
    for api, conv in ((bps, _torch_tree), (jbps, _stacked)):
        api.declare_tensor("first")
        api.declare_tensor("second", priority=42)
        api.push_pull(conv(grads), name="g")
    bps.suspend()
    jbps.suspend()
    assert not GlobalState.initialized()
    bps.resume()
    jbps.resume(mesh=_mesh1())
    for api, conv in ((bps, _torch_tree), (jbps, _stacked)):
        api.declare_tensor("third")
        api.push_pull(conv({"late": grads}), name="h")
    reg, jreg = GlobalState.get().registry, JGlobalState.get().registry
    names = reg.declared_names()
    assert names == jreg.declared_names()
    for n in names:
        a, b = reg.get(n), jreg.get(n)
        assert (a.declared_key, a.priority) == (b.declared_key, b.priority)
    assert reg.get("second").priority == 42


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_debug_sampler_logs_the_jax_mean_and_std(monkeypatch):
    from byteps_tpu.common.logging import get_logger as jlog
    from byteps_tpu_torch.common.logging import get_logger
    monkeypatch.setenv("BPS_DEBUG_SAMPLE_TENSOR", "grads")
    _init_both()
    ours, theirs = _Lines(), _Lines()
    get_logger().addHandler(ours)
    jlog().addHandler(theirs)
    try:
        tree = _ps_tree(7)
        for name in ("grads.a", "other"):
            bps.push_pull(_torch_tree(tree), name=name)
            jbps.push_pull(_stacked(tree), name=name)
    finally:
        get_logger().removeHandler(ours)
        jlog().removeHandler(theirs)
    sample = [x for x in ours.lines if x.startswith("SAMPLE")]
    assert len(sample) == len(jax.tree_util.tree_leaves(tree))
    assert sample == [x for x in theirs.lines if x.startswith("SAMPLE")]
    assert all("grads.a" in x for x in sample)


# ------------------------------------------------- the name shadowing trap

def test_top_level_api_works_after_importing_the_plugin():
    """``import byteps_tpu_torch.torch`` binds the plugin as the package's
    attribute ``torch``; every top-level function still works."""
    import byteps_tpu_torch.torch as plugin
    assert bps.torch is plugin
    bps.init(device="cpu")
    x = {"w": torch.arange(4.0)}
    assert torch.equal(bps.push_pull(x)["w"], x["w"])
    h = bps.push_pull_async(x)
    assert bps.poll(h)
    assert torch.equal(bps.synchronize(h)["w"], x["w"])
    assert bps.declare_tensor("k") >= 0
    assert torch.equal(bps.broadcast_parameters(x)["w"], x["w"])
    assert bps.broadcast_optimizer_state({"state": {}, "lr": 0.1}) \
        == {"state": {}, "lr": 0.1}
    assert bps.get_pushpull_speed() == 0.0
    assert "ps/push_bytes" in bps.get_metrics().names()
    assert (bps.rank(), bps.size(), bps.local_rank(), bps.local_size(),
            list(bps.replica_ranks())) == (0, 1, 0, 1, [0])
    model = torch.nn.Linear(3, 2)
    opt = bps.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=model.named_parameters())
    assert opt.inner is not None
    bps.suspend()
    bps.resume(device="cpu")
    assert GlobalState.get().registry.get("k") is not None
    for name in ("MirroredStrategy",
                 "DistributedDataParallel", "DistributedGradientTape",
                 "Compression"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(bps, name)(None, None, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bps.Compression.fp16
    bps.shutdown()
    assert not GlobalState.initialized()


def test_the_exports_are_the_jax_packages():
    import byteps_tpu.torch as jplugin

    import byteps_tpu_torch.torch as plugin
    assert set(bps.__all__) == set(jbps.__all__) | {"get_metrics"}
    assert sorted(plugin.__all__) == sorted(jplugin.__all__)
    for name in plugin.__all__:
        assert callable(getattr(plugin, name))
