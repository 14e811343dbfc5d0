"""The torch plugin's async ``DistributedOptimizer`` (``BPS_ENABLE_PS=1
BPS_ENABLE_ASYNC=1``) against the JAX package's plugin on the CPU (oracle
``tests/test_torch_plugin.py:139``): the same model and data, both
plugins' ``size()`` patched to 2 (at world 1 the wrapper is the plain
optimizer), the in-process async server. Each step is the local update,
then per parameter the weight delta pushed into an fp32 store under
``AsyncParam.<name>`` and the store's weights pulled into the parameter.

An async pull may read the store before the engine folded this worker's
delta; both sides run through ``test_torch_async_trainer.Quiesced``, which
waits until a key's round equals its pushes before it pulls. Then every
parameter ends bit for bit the JAX plugin's, at the fp32 and the bf16
delta wire, near the plain optimizer's (the store's fold old + (new - old)
rounds, and the bf16 wire rounds each delta). The gradient hooks dispatch nothing in async mode,
``skip_synchronize`` and ``CrossBarrier`` refuse an async optimizer, as in
the JAX plugin, and ``broadcast_parameters`` raises there (the JAX
plugin's would zero every other worker's parameters).
"""

import numpy as np
import pytest
import torch

import byteps_tpu.torch as jbt
import byteps_tpu.torch.ops as jops
import byteps_tpu.torch.optimizer as jopt
import byteps_tpu_torch.torch as bt
import byteps_tpu_torch.torch.optimizer as topt
from byteps_tpu.common.global_state import GlobalState as JGlobalState
from byteps_tpu_torch.common.global_state import GlobalState
from test_torch_async_trainer import Quiesced

_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BYTEPS_ENABLE_ASYNC", "BPS_SERVER_ADDRS",
        "BPS_COMPRESS", "BPS_PARTITION_BYTES", "BPS_TORCH_CHANNELS",
        "BPS_ASYNC_WIRE_DTYPE", "BPS_ASYNC_PULL_DTYPE", "BPS_MAX_LAG",
        "BPS_SHARDED_UPDATE")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_ENABLE_ASYNC", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    jops._async_inited.clear()     # the JAX plugin's, never cleared there
    yield
    bt.shutdown()
    jbt.shutdown()
    torch.set_num_threads(n)


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(24, 64), torch.nn.Tanh(),
                               torch.nn.Linear(64, 24))


def _train(api, wrap, steps=4):
    model = _model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    if wrap:
        opt = api.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        assert opt._enable_async and len(opt._hook_handles) == 4
    rng = np.random.RandomState(7)
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(16, 24).astype(np.float32))
        opt.zero_grad()
        (model(x) - x).square().mean().backward()
        if wrap:
            assert all(h is None for h, _ in opt._handles.values())
        opt.step()
    return [p.detach().clone() for p in model.parameters()], opt


def _init_both(monkeypatch):
    bt.init(device="cpu")
    jbt.init()
    for gs in (GlobalState.get(), JGlobalState.get()):
        assert gs.ps_backend.async_mode and gs.engine.ps_exchange is None
        gs.ps_backend = Quiesced(gs.ps_backend)
    monkeypatch.setattr(topt, "size", lambda: 2)
    monkeypatch.setattr(jopt, "size", lambda: 2)


@pytest.mark.parametrize("wire", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_async_optimizer_is_the_jax_plugins(wire, monkeypatch):
    if wire:
        monkeypatch.setenv("BPS_ASYNC_WIRE_DTYPE", wire)
    _init_both(monkeypatch)
    got, _ = _train(bt, True)
    want, _ = _train(jbt, True)
    plain, _ = _train(bt, False)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    pushes = GlobalState.get().ps_backend.pushes
    assert len(pushes) == 4 and set(pushes.values()) == {4}
    names = GlobalState.get().registry.declared_names()
    assert {"AsyncParam.0.weight", "AsyncParam.2.bias"} <= set(names)
    # the store folds old + (new - old): at fp32 the plain update up to
    # that rounding, at bf16 away from it
    for a, c in zip(got, plain):
        torch.testing.assert_close(a, c, rtol=1e-5 if wire is None else 2e-2,
                                   atol=1e-6 if wire is None else 1e-3)
    if wire:
        assert any(not torch.equal(a, c) for a, c in zip(got, plain))


def test_async_optimizer_refusals(monkeypatch):
    _init_both(monkeypatch)
    model = _model()
    opt = bt.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                  named_parameters=model.named_parameters())
    with pytest.raises(AssertionError, match="async training"):
        with opt.skip_synchronize():
            pass
    with pytest.raises(ValueError, match="async-PS mode has no barrier"):
        bt.CrossBarrier(model, opt)
    jmodel = _model()
    jo = jbt.DistributedOptimizer(torch.optim.SGD(jmodel.parameters(),
                                                  lr=0.1),
                                  named_parameters=jmodel.named_parameters())
    with pytest.raises(ValueError, match="async-PS mode has no barrier"):
        jbt.CrossBarrier(jmodel, jo)
    monkeypatch.setattr(bt.optimizer, "size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.broadcast_parameters(model.state_dict(), root_rank=0)
