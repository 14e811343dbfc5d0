"""The port's torch plugin (``byteps_tpu_torch.torch``) on the CPU.

At world 1 it is held against the JAX package's plugin
(``byteps_tpu.torch``) on the same CPU tensors: handles, in-place
write-back, the duplicate-name error, ``push_pull.noname.{i}`` names,
the keys ``declare_model_keys`` declares, ``Compression.fp16``, and, with
``BPS_ENABLE_PS=1`` at int8 and fp8, every exchanged tensor bit for bit
(the same numpy codec on the same bytes, keys and noise seeds).

At world 2 over gloo (``_torch_api_worker.py``, mode "plugin") BERT-tiny
(fp32, naive attention, ``convert.params_from_jax`` weights) takes 3 steps
on each rank's own batches through ``DistributedOptimizer``,
``DistributedDataParallel`` and ``CrossBarrier``. After each reduction
every rank's gradients equal, bit for bit, JAX ``push_pull`` of the two
ranks' gradients stacked on a two-device mesh (a sum of two and its half
do not depend on the order); all three end with the same parameters on
both ranks, bit for bit; ``backward_passes_per_step=2`` and ``no_sync``
reduce the summed gradients of two passes.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_api_worker import MAX_PRED, ROWS, SEQ, TINY, Ranks
import byteps_tpu as jbps
import byteps_tpu.torch as jbt
from byteps_tpu.common.global_state import GlobalState as JGlobalState
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh
import byteps_tpu_torch.torch as bt
from byteps_tpu_torch import convert
from byteps_tpu_torch.common.global_state import GlobalState

_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
        "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC", "BPS_SERVER_ADDRS",
        "BPS_COMPRESS", "BPS_COMPRESS_DEVICE", "BPS_SCHEDULING_CREDIT",
        "BPS_TELEMETRY_ON", "BPS_DEBUG_SAMPLE_TENSOR", "BPS_PS_PIPELINE",
        "BPS_MIN_COMPRESS_BYTES", "BPS_PARTITION_BYTES", "BPS_HOST_ONLY",
        "BPS_TORCH_CHANNELS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_PARTITION_BYTES", str(64 << 10))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    bt.shutdown()
    jbt.shutdown()
    torch.set_num_threads(n)


def _init_both():
    bt.init(device="cpu")
    jbt.init()


def _registry_keys(gs):
    reg = gs.registry
    return [(n, reg.get(n).declared_key) for n in reg.declared_names()]


# ---------------------------------------------------------- world 1

def test_handles_and_in_place_write_back_match_the_jax_plugin():
    _init_both()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for api in (bt, jbt):
        out = api.push_pull(x, average=True, name="t")
        assert torch.equal(out, x) and out is not x
        h = api.push_pull_async(x, name="t2")
        out2 = api.synchronize(h)
        assert torch.equal(out2, x)
        y = torch.ones(5)
        h = api.push_pull_async_inplace(y, average=False, name="ip")
        assert api.synchronize(h) is y
        with pytest.raises(RuntimeError, match="unknown push_pull handle"):
            api.synchronize(h)
    assert _registry_keys(GlobalState.get()) \
        == _registry_keys(JGlobalState.get())


def test_poll_turns_true():
    bt.init(device="cpu")
    h = bt.push_pull_async(torch.ones(7), name="p")
    assert bt.poll(h)
    assert torch.equal(bt.synchronize(h), torch.ones(7))


def _lin():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Tanh(),
                               torch.nn.Linear(3, 2))


def test_duplicate_names_raise_as_in_the_jax_plugin():
    _init_both()
    m = _lin()
    named = [("w", m[0].weight), ("w", m[2].weight)]
    for api in (bt, jbt):
        with pytest.raises(ValueError, match="unique"):
            api.DistributedOptimizer(torch.optim.SGD(m.parameters(), 0.1),
                                     named_parameters=named)
        with pytest.raises(ValueError, match="tuples"):
            api.DistributedOptimizer(torch.optim.SGD(m.parameters(), 0.1),
                                     named_parameters=[m[0].weight])


def test_declare_model_keys_and_noname_keys_are_the_jax_plugins():
    """``DistributedOptimizer`` with names (``Gradient.*`` then
    ``Parameter.*``, each sorted), one without (``push_pull.noname.{i}``
    across all groups), ``DistributedDataParallel`` and an unnamed
    push_pull: the registries hold the same names under the same keys."""
    _init_both()
    for api in (bt, jbt):
        m = _lin()
        api.DistributedOptimizer(torch.optim.SGD(m.parameters(), 0.1),
                                 named_parameters=m.named_parameters())
        groups = [{"params": list(m[0].parameters())},
                  {"params": list(m[2].parameters()), "lr": 0.5}]
        api.DistributedOptimizer(torch.optim.SGD(groups, 0.1))
        api.DistributedDataParallel(_lin())
        api.push_pull(torch.ones(3))
        api.declare("extra", priority=3)
    keys = _registry_keys(GlobalState.get())
    assert keys == _registry_keys(JGlobalState.get())
    names = [n for n, _ in keys]
    assert names[:4] == ["Gradient.0.bias", "Gradient.0.weight",
                         "Gradient.2.bias", "Gradient.2.weight"]
    assert "Gradient.push_pull.noname.3" in names
    assert "push_pull.noname.0" in names
    assert GlobalState.get().registry.get("extra").priority == 3


def test_world_one_optimizer_is_the_plain_optimizer():
    bt.init(device="cpu")
    m1, m2 = _lin(), _lin()
    o1 = torch.optim.AdamW(m1.parameters(), lr=0.1)
    o2 = bt.DistributedOptimizer(torch.optim.AdamW(m2.parameters(), lr=0.1),
                                 named_parameters=m2.named_parameters())
    assert not o2._hook_handles
    x = torch.randn(8, 4)
    for _ in range(3):
        for m, o in ((m1, o1), (m2, o2)):
            o.zero_grad()
            m(x).square().sum().backward()
            o.step()
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_compression_fp16_round_trip_is_the_jax_plugins():
    x = torch.randn(33) * 100
    for c, jc in ((bt.Compression.fp16, jbt.Compression.fp16),
                  (bt.Compression.none, jbt.Compression.none)):
        y, ctx = c.compress(x)
        jy, jctx = jc.compress(x)
        assert y.dtype == jy.dtype and torch.equal(y, jy) and ctx == jctx
        back = c.decompress(y, ctx)
        assert back.dtype == torch.float32
        assert torch.equal(back, jc.decompress(jy, jctx))
    i = torch.arange(4)
    assert bt.Compression.fp16.compress(i)[0] is i


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3"])
def test_ps_push_pull_is_the_jax_plugins_bit_for_bit(codec, monkeypatch):
    """``BPS_ENABLE_PS=1`` at ``BPS_COMPRESS=codec``: model keys declared,
    then three rounds of every gradient through ``push_pull_async`` with
    priorities (the PS pool) and one ``push_pull``; every result the JAX
    plugin's, bit for bit (error feedback and noise carry across rounds)."""
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_COMPRESS", codec)
    _init_both()
    rng = np.random.RandomState(3)
    shapes = {"emb": (300, 97), "w": (40000,), "b": (5,), "ln": (17, 33)}
    for api in (bt, jbt):
        api.ops.declare_model_keys(sorted(shapes))
    for rnd in range(3):
        grads = {k: torch.from_numpy((rng.randn(*s) * (rnd + 1))
                                     .astype(np.float32))
                 for k, s in shapes.items()}
        outs = []
        for api in (bt, jbt):
            hs = {k: api.push_pull_async(g, name="Gradient." + k,
                                         priority=-i)
                  for i, (k, g) in enumerate(grads.items())}
            outs.append({k: api.synchronize(h) for k, h in hs.items()})
        for k in shapes:
            assert outs[0][k].numpy().tobytes() \
                == outs[1][k].numpy().tobytes(), (rnd, k)
        assert not torch.equal(outs[0]["w"], grads["w"])   # lossy
        one = torch.from_numpy(rng.randn(20000).astype(np.float32))
        a = bt.push_pull(one, name=f"single{rnd}")
        b = jbt.push_pull(one, name=f"single{rnd}")
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert GlobalState.get().engine.ps_exchange.n_compressed() > 0


# ---------------------------------------------------------- world 2

STEPS = 3


def _batches():
    """[rank, step] batches: STEPS steps and one more for accumulation."""
    b = [[jbert.synth_mlm_batch(np.random.RandomState(100 + 10 * r + s),
                                ROWS, SEQ, TINY["vocab_size"])
          for s in range(STEPS + 1)] for r in range(2)]
    return (np.array([[x[0] for x in row] for row in b]),
            np.array([[x[1] for x in row] for row in b]))


@pytest.fixture(scope="module")
def plugin_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plugin_gloo")
    params = jtr.init_params(jax.random.PRNGKey(0), jbert.bert_config(
        dtype="float32", attn_impl="naive", **TINY))
    tokens, targets = _batches()
    src = tmp / "plugin.npz"
    np.savez(src, tokens=tokens, targets=targets, **{
        f"p.{k}": v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, params)).items()})
    w = Ranks("plugin", 2, src, tmp)
    w.src = src
    yield w
    w.close()


def jax_mean(pairs):
    """JAX push_pull (average) of two ranks' arrays on a two-device mesh,
    by name; each rank's row."""
    jbps.init(mesh=make_mesh({"data": 2}, devices=jax.devices()[:2]))
    try:
        out = jbps.push_pull({k: np.stack(v) for k, v in pairs.items()})
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jbps.shutdown()


def _synced_vs_jax(res, tag):
    names = [k[len(tag) + 5:] for k in res[0] if k.startswith(f"{tag}.raw.")]
    assert len(names) > 10
    ref = jax_mean({n: [r[f"{tag}.raw.{n}"] for r in res] for n in names})
    for n in names:
        for r, out in enumerate(res):
            got = out[f"{tag}.synced.{n}"]
            assert got.tobytes() == ref[n][r].tobytes(), (tag, n, r)
    # the ranks' own gradients differ: the reduction did something
    assert any(not np.array_equal(res[0][f"{tag}.raw.{n}"],
                                  res[1][f"{tag}.raw.{n}"]) for n in names)


@pytest.mark.parametrize("wrapper", ["opt", "ddp"])
def test_gradients_after_each_reduction_are_jax_push_pull(
        plugin_world, wrapper):
    res = plugin_world.result(timeout=240)
    for s in range(STEPS):
        _synced_vs_jax(res, f"{wrapper}{s}")


@pytest.mark.parametrize("wrapper", ["opt", "ddp"])
def test_accumulation_reduces_the_summed_gradients(plugin_world, wrapper):
    """``backward_passes_per_step=2`` (optimizer) and ``no_sync`` (DDP):
    the reduced gradient is the mean over ranks of each rank's sum of its
    two passes, as the hook saw it on the second pass."""
    _synced_vs_jax(plugin_world.result(timeout=240), f"{wrapper}_acc")


@pytest.mark.parametrize("wrapper", ["opt", "ddp", "cb"])
def test_every_wrapper_ends_with_the_same_parameters_on_both_ranks(
        plugin_world, wrapper):
    res = plugin_world.result(timeout=240)
    start = np.load(plugin_world.src)
    keys = [k for k in res[0] if k.startswith(f"{wrapper}.params")]
    assert len(keys) > 10
    for k in keys:
        assert res[0][k].tobytes() == res[1][k].tobytes(), k
    # the steps moved the weights
    assert all(not np.array_equal(res[0][k], start["p." + k[len(wrapper)
                                                             + 9:-2]])
               for k in keys)
