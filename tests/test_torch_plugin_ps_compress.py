"""The torch plugin's ``DistributedOptimizer`` in PS mode with compression
kwargs, against the JAX package's plugin on the CPU.

Each parameter's gradient name is declared with the README's onebit kwargs
(``bps.declare("Gradient." + name, **kwargs)``, the reference's
``byteps_declare_tensor``) before the optimizer is wrapped, so the PS
exchange gives each of its buckets the legacy host chain (momentum -> error
feedback -> onebit) on the worker and the server. Both plugins take the
wrapper's hooked path (their ``size()`` seen by the optimizer module is
patched to 2, since at world 1 the wrapper is the plain optimizer); the
in-process server at world 1 sums one worker. A small MLP takes 3 AdamW
steps on seeded batches: every parameter ends bit for bit the JAX plugin's,
and away from a plain optimizer's (the chains compressed).
"""

import numpy as np
import pytest
import torch

import byteps_tpu.torch as jbt
import byteps_tpu.torch.optimizer as jopt
import byteps_tpu_torch.torch as bt
import byteps_tpu_torch.torch.optimizer as topt
from byteps_tpu.common.global_state import GlobalState as JGlobalState
from byteps_tpu_torch.common.global_state import GlobalState

README = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
          "ef_type": "vanilla", "momentum_type": "nesterov"}
_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC",
        "BPS_SERVER_ADDRS", "BPS_COMPRESS", "BPS_PS_PIPELINE",
        "BPS_PARTITION_BYTES", "BPS_TORCH_CHANNELS")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_MIN_COMPRESS_BYTES", "1024")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    bt.shutdown()
    jbt.shutdown()
    torch.set_num_threads(n)


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(48, 256), torch.nn.Tanh(),
                               torch.nn.Linear(256, 48))


def _train(api, wrap):
    model = _model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    if wrap:
        for name, _ in model.named_parameters():
            api.declare("Gradient." + name, **README)
        opt = api.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        assert len(opt._hook_handles) == 4
    rng = np.random.RandomState(7)
    for _ in range(3):
        x = torch.from_numpy(rng.randn(32, 48).astype(np.float32))
        opt.zero_grad()
        (model(x) - x).square().mean().backward()
        opt.step()
    return [p.detach().clone() for p in model.parameters()]


def test_optimizer_with_declared_onebit_kwargs_is_the_jax_plugins(
        monkeypatch):
    bt.init(device="cpu")
    jbt.init()
    monkeypatch.setattr(topt, "size", lambda: 2)
    monkeypatch.setattr(jopt, "size", lambda: 2)
    got = _train(bt, True)
    want = _train(jbt, True)
    plain = _train(bt, False)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    n = GlobalState.get().engine.ps_exchange.n_chained()
    assert n == len(JGlobalState.get().engine.ps_exchange._chains) >= 2
    assert any(not torch.equal(a, c) for a, c in zip(got, plain))
