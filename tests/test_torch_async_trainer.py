"""The async PS step of the port's ``DistributedTrainer``
(``BPS_ENABLE_PS=1 BPS_ENABLE_ASYNC=1``) against the JAX trainer's
(``byteps_tpu/training.py:179-227``, ``_async_ps_step`` at ``:1019-1046``;
oracles ``tests/test_ps_trainer.py:203``, ``tests/test_ps_mode.py:90``), at
world 1 in process (set-up of ``_torch_ps_routes.py``: BERT at 2 layers,
hidden 128, fp32, weights from the JAX package's ``init_params``), with the
fp32 and the bf16 delta wire and ``backward_passes_per_step`` 1 and 2:
losses and parameters within the PS trainer tolerances of
``test_torch_lag_trainer.py`` (at the bf16 wire up to 1 in 1000 elements a
bf16 step of a delta apart, where the two fp32 deltas straddle a rounding
tie), and the server's store at the end the
trainer's weights bit for bit.

An async pull may read the store before the engine thread folded this
worker's own delta (both packages; kept from the reference). Both sides
therefore run through ``Quiesced``, a backend wrapper of this test that,
before each pull, waits (bounded) until the key's round equals the pushes
made to it, so each pull reads every delta pushed so far.

Then the refusals (a custom reducer and ``compression=`` raise ValueError,
``BPS_MAX_LAG`` > 1 and ``BPS_SHARDED_UPDATE=1`` NotImplementedError,
``BPS_ENABLE_ASYNC`` without ``BPS_ENABLE_PS`` ValueError), what async
mode does not build (no exchange, no staging, no cross-step driver), and
``push_pull`` in async mode, which is this worker's own values in both
packages.
"""

import time

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_ps_routes import (_JCFG, _TCFG, EPS, LR, MAX_PRED, WAIT, _batch,
                              _loss, _ps_env, _within, jparams)  # noqa: F401
import byteps_tpu as jbps
from byteps_tpu.common.global_state import GlobalState as JGlobalState
from byteps_tpu.models import bert as jbert
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
import byteps_tpu_torch as bps
from byteps_tpu_torch import convert
from byteps_tpu_torch.common.global_state import GlobalState
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

STEPS = 3


class Quiesced:
    """A PS backend whose pulls first wait until every push made through
    it has been folded (the key's round equals its pushes)."""

    def __init__(self, backend):
        self._be = backend
        self.pushes = {}

    def __getattr__(self, name):
        return getattr(self._be, name)

    def push(self, key, data):
        self._be.push(key, data)
        self.pushes[key] = self.pushes.get(key, 0) + 1

    def pull(self, key, out, round=0, timeout_ms=30000):
        want = self.pushes.get(key, 0)
        deadline = time.monotonic() + WAIT
        while (got := self._be.round(key)) != want:
            assert got < want, f"key {key}: {got} folds, {want} pushes"
            assert time.monotonic() < deadline, f"key {key} never folded"
            time.sleep(0.001)
        self._be.pull(key, out, round, timeout_ms)


@pytest.fixture
def async_env(monkeypatch):
    monkeypatch.setenv("BPS_ENABLE_ASYNC", "1")
    for name in ("BPS_ASYNC_WIRE_DTYPE", "BPS_ASYNC_PULL_DTYPE",
                 "BPS_SHARDED_UPDATE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_COMPRESS", "none")


def _port(jp, k, micro):
    bps.shutdown()
    bps.init(device="cpu")
    gs = GlobalState.get()
    gs.ps_backend = Quiesced(gs.ps_backend)
    model = tbert.Transformer(_TCFG)
    model.load_state_dict(convert.params_from_jax(jp))
    tt = DistributedTrainer(_loss, model, adamw(model.parameters(), LR,
                                                eps=EPS),
                            backward_passes_per_step=k, device="cpu",
                            name="async-net")
    losses = [_within(lambda i=i: tt.step(_batch(i)).item())
              for i in range(micro)]
    store = [w.reshape(-1) for w in tt._async_worker.pull_weights()]
    mine = [p.detach().reshape(-1).numpy() for _, p in tt._ps_params]
    return losses, convert.params_to_jax_layout(tt.model), store, mine, tt


def _jax(jp, k, micro, monkeypatch):
    monkeypatch.setenv("BPS_BWD_STAGED", "0")
    monkeypatch.setenv("BPS_CROSS_STEP", "0")
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        gs = JGlobalState.get()
        gs.ps_backend = Quiesced(gs.ps_backend)
        jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, _JCFG, b,
                                                    max_predictions=MAX_PRED),
                        jp, optax.adamw(LR, eps=EPS), mesh=mesh,
                        backward_passes_per_step=k, name="async-net")
        assert jt._async_worker is not None
        losses = [float(jt.step(_batch(i))) for i in range(micro)]
        return losses, jax.tree.map(np.asarray, jt.params)
    finally:
        jbps.shutdown()


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("wire", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_async_step_is_the_jax_trainers(wire, k, jparams, async_env,
                                        monkeypatch):
    if wire:
        monkeypatch.setenv("BPS_ASYNC_WIRE_DTYPE", wire)
    micro = STEPS * k
    losses, params, store, mine, tt = _port(jparams, k, micro)
    assert tt._async_worker.wire_dtype == wire
    be = GlobalState.get().ps_backend
    assert all(n == STEPS for n in be.pushes.values())
    assert len(be.pushes) == len(tt._ps_params)
    # the trainer's weights are the store's after the last pull
    for a, b in zip(store, mine):
        assert a.tobytes() == b.tobytes()
    jl, jp_after = _jax(jparams, k, micro, monkeypatch)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    a, b, init = _flat(params), _flat(jp_after), _flat(jparams)
    off = np.count_nonzero(np.abs(a - b) > 1e-5)
    if wire is None:
        assert off == 0
    else:
        # the fp32 deltas agree to ~1e-7; where one sits at a bf16 tie
        # the two roundings go apart by one bf16 step of the delta, at
        # most 2^-8 of it (the ports' 1-in-1000 convention, ROADMAP)
        assert off <= a.size // 1000
        assert np.abs(a - b).max() <= 1e-5 + 2 ** -8 * np.abs(a - init).max()
    # the weights moved: a delta was folded
    assert np.count_nonzero(a != init) > a.size // 2


def test_async_mode_builds_no_exchange_staging_or_driver(jparams, async_env,
                                                         monkeypatch):
    from byteps_tpu_torch import cross_step, staging
    from byteps_tpu_torch.server import ps_mode

    def refuse(*a, **kw):
        raise AssertionError("built in async mode")

    monkeypatch.setattr(ps_mode, "PSGradientExchange", refuse)
    monkeypatch.setattr(cross_step, "CrossStepDriver", refuse)
    monkeypatch.setattr(staging, "PinnedPool", refuse)
    monkeypatch.setattr(DistributedTrainer, "_ensure_streamed_tail", refuse)
    monkeypatch.setattr(DistributedTrainer, "_ensure_sharded", refuse)
    *_, tt = _port(jparams, 1, 2)
    gs = GlobalState.get()
    assert tt.ps_exchange is None and tt._cross_driver is None
    assert gs.exchanges == [] and gs.engine.ps_factory is None
    assert gs.engine.ps_exchange is None and gs.engine.ps_world == 1
    assert gs.ps_backend.async_mode


def _trainer(**kw):
    model = tbert.Transformer(_TCFG)
    return DistributedTrainer(_loss, model, adamw(model.parameters(), LR),
                              device="cpu", **kw)


@pytest.mark.parametrize("case", ["reducer", "compression", "max_lag",
                                  "sharded_update", "no_ps"])
def test_async_refusals(case, async_env, monkeypatch):
    """The JAX trainer's two ValueErrors; the two knobs its async branch
    never reads raise NotImplementedError; async without PS raises."""
    if case == "no_ps":
        monkeypatch.delenv("BPS_ENABLE_PS")
        with pytest.raises(ValueError, match="BPS_ENABLE_ASYNC=1 needs "
                                             "BPS_ENABLE_PS=1"):
            bps.init(device="cpu")
        with pytest.raises(ValueError, match="ROADMAP"):
            _trainer()
        return
    if case == "max_lag":
        monkeypatch.setenv("BPS_MAX_LAG", "2")
    if case == "sharded_update":
        monkeypatch.setenv("BPS_SHARDED_UPDATE", "1")
    bps.init(device="cpu")
    if case == "reducer":
        with pytest.raises(ValueError, match="async-PS mode"):
            _trainer(reducer=lambda buf, group: buf)
    elif case == "compression":
        with pytest.raises(ValueError, match="compression is not supported "
                                             "in async-PS mode"):
            _trainer(compression={"compressor_type": "onebit"})
    else:
        knob = "BPS_MAX_LAG=2" if case == "max_lag" else \
            "BPS_SHARDED_UPDATE=1"
        with pytest.raises(NotImplementedError,
                           match=rf"{knob} with BPS_ENABLE_ASYNC=1.*queue 1, "
                                 rf"item 6"):
            _trainer()


def test_push_pull_in_async_mode_is_this_workers_own(async_env):
    """No PS exchange backs ``push_pull`` in async mode: both packages
    reduce over this worker alone and return its values."""
    x = np.random.RandomState(5).randn(1, 33).astype(np.float32)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        assert JGlobalState.get().engine.ps_exchange is None
        want = np.asarray(jbps.push_pull({"a": x}, name="pp")["a"])
    finally:
        jbps.shutdown()
    bps.init(device="cpu")
    t = torch.from_numpy(x)
    got = bps.push_pull({"a": t}, name="pp")["a"]
    assert got is not t
    assert got.numpy().tobytes() == want.tobytes() == x.tobytes()
