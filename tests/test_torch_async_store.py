"""The async store of the port's server (``byteps_tpu_torch/server/engine.py``,
``PSServer(..., async_mode=True)`` and ``HostPSBackend(..., async_mode=
True)``) against the JAX package's on the same scripted pushes (oracles
``tests/test_server.py:128``, ``tests/test_ps_mode.py:165``): a pull before
any push, fp32 folds, the rounds, bf16 pushes into an fp32 store, narrow
pulls, ``push_pull`` at round 0, bit for bit; and ``launch --server`` with
``BPS_ENABLE_ASYNC=1`` (or the legacy spelling) serving an async store.

An async push only enqueues: the engine thread folds it later. Every
comparison waits until the key's round (the pushes folded) equals the
pushes made, bounded, before it pulls.
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest

from byteps_tpu.server import engine as jengine
from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.launcher import launch
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

WAIT = 20.0
N = 4099                  # not a multiple of any vector width


def _quiesce(be, key, pushes):
    deadline = time.monotonic() + WAIT
    while (rnd := be.round(key)) != pushes:
        assert rnd < pushes, "more folds than pushes"
        assert time.monotonic() < deadline, "the engine never folded"
        time.sleep(0.002)


def _make(kind, mod):
    if kind == "server":
        return mod.PSServer(num_workers=2, engine_threads=2, async_mode=True)
    return mod.HostPSBackend(num_servers=2, num_workers=2, engine_threads=2,
                             async_mode=True)


def _deltas(seed, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(N) * 10.0 ** rng.randint(-6, 2)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["server", "backend"])
def test_async_folds_are_the_jax_stores(kind):
    rng = np.random.RandomState(0)
    init = rng.randn(N).astype(np.float32)
    fp32, narrow = _deltas(1), _deltas(2)
    stores = {}
    for side, mod in (("port", pengine), ("jax", jengine)):
        be = _make(kind, mod)
        try:
            assert be.async_mode
            keys = (5, 70001)
            seen = []
            for key in keys:
                be.init_key(key, init.nbytes, "float32", init=init)
                out = np.empty(N, np.float32)
                be.pull(key, out)         # before any push: the init
                seen.append(out.copy())
                pushes = 0
                for d in fp32:
                    be.push(key, d)
                    pushes += 1
                    _quiesce(be, key, pushes)
                    be.pull(key, out)
                    seen.append(out.copy())
                for d in narrow:          # the bf16 delta wire
                    be.push(key, bf16.narrow(d) if side == "port"
                            else d.astype(ml_dtypes.bfloat16))
                    pushes += 1
                _quiesce(be, key, pushes)
                be.pull(key, out)
                seen.append(out.copy())
                assert be.round(key) == len(fp32) + len(narrow)
                # a narrow pull: the store cast on the way out
                n16 = np.empty(N, bf16.BF16 if side == "port"
                               else ml_dtypes.bfloat16)
                be.pull(key, n16)
                seen.append(n16.view(np.uint16).copy())
            stores[side] = seen
        finally:
            be.close()
    assert len(stores["port"]) == len(stores["jax"])
    for a, b in zip(stores["port"], stores["jax"]):
        assert a.tobytes() == b.tobytes()
    # and the numpy replay of the same folds, in fp32 in push order
    want = init.copy()
    assert stores["port"][0].tobytes() == want.tobytes()
    for i, d in enumerate(fp32):
        want = want + d
        assert stores["port"][1 + i].tobytes() == want.tobytes()
    for d in narrow:
        want = want + bf16.widen(bf16.narrow(d))
    assert stores["port"][len(fp32) + 1].tobytes() == want.tobytes()
    assert stores["port"][len(fp32) + 2].tobytes() == \
        want.astype(ml_dtypes.bfloat16).view(np.uint16).tobytes()


def test_async_pull_before_init_raises_and_init_is_first_wins():
    s = pengine.PSServer(num_workers=2, engine_threads=1, async_mode=True)
    try:
        a, b = np.ones(8, np.float32), np.full(8, 7.0, np.float32)
        s.init_key(3, a.nbytes, "float32")          # no initial value
        with pytest.raises(RuntimeError, match="rc=-3"):
            s.pull(3, np.empty(8, np.float32))
        s.init_key(4, a.nbytes, "float32", init=a)
        s.init_key(4, b.nbytes, "float32", init=b)  # a later worker's: no-op
        out = np.empty(8, np.float32)
        s.pull(4, out)
        assert out.tobytes() == a.tobytes()
        with pytest.raises(RuntimeError, match="rc=-4"):
            s.init_key(4, 64, "float32")            # another size
    finally:
        s.close()


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_push_pull_pulls_round_zero_in_async_mode(mode, monkeypatch):
    """``HostPSBackend.push_pull`` (reference ``engine.py:868-876``) on a
    blocking engine, where a push folds before it returns: async mode
    reads the store as it is, sync mode the round this push completes."""
    monkeypatch.setenv("BPS_SERVER_ENGINE_BLOCKING", "1")
    outs = {}
    for side, mod in (("port", pengine), ("jax", jengine)):
        be = mod.HostPSBackend(num_servers=1, num_workers=1,
                               async_mode=mode == "async")
        try:
            x = np.arange(16, dtype=np.float32)
            be.init_key(9, x.nbytes, "float32", init=np.full(16, 0.5,
                                                             np.float32))
            outs[side] = [be.push_pull(9, x * k).copy() for k in (1, 2, 3)]
        finally:
            be.close()
    for a, b in zip(outs["port"], outs["jax"]):
        assert a.tobytes() == b.tobytes()
    got = outs["port"][-1]
    want = (0.5 + 6 * np.arange(16, dtype=np.float32) if mode == "async"
            else 3 * np.arange(16, dtype=np.float32))
    assert got.tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("env", [{"BPS_ENABLE_ASYNC": "1"},
                                 {"BYTEPS_ENABLE_ASYNC": "1"},
                                 {"BPS_ENABLE_ASYNC": "0",
                                  "BYTEPS_ENABLE_ASYNC": "1"}])
def test_launcher_serves_an_async_store(env, monkeypatch):
    """``launch --server`` with the async knob builds ``PSServer(...,
    async_mode=True)``; ``BPS_ENABLE_ASYNC`` wins over the legacy
    spelling, as in the worker's ``Config``."""
    made = []
    real = pengine.PSServer

    def spy(*a, **kw):
        s = real(*a, **kw)
        made.append(s)
        return s

    monkeypatch.setattr(pengine, "PSServer", spy)
    monkeypatch.setattr(launch, "RSS_SAMPLE_S", 0.05)
    monkeypatch.delenv("BPS_ENABLE_ASYNC", raising=False)
    monkeypatch.delenv("BYTEPS_ENABLE_ASYNC", raising=False)
    stop = threading.Event()
    full = dict(env, BPS_NUM_WORKER="2", BPS_SERVER_PORT="0")
    th = threading.Thread(target=launch.run_server, args=(full, stop),
                          daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + WAIT
        while not made or not hasattr(made[0], "_h"):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        want = env.get("BPS_ENABLE_ASYNC", env.get("BYTEPS_ENABLE_ASYNC"))
        assert made[0].async_mode is (want == "1")
    finally:
        stop.set()
        th.join(WAIT)
    assert not th.is_alive()


def test_a_remote_async_backend_folds_over_tcp(monkeypatch):
    """Two async clients of one async server: every push folds, a pull
    never waits, the rounds count the folds, and ``push_pull`` reads round
    0."""
    srv_be = pengine.PSServer(num_workers=2, engine_threads=1,
                              async_mode=True)
    srv = ptransport.PSTransportServer(srv_be, host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{srv.port}"
    clients = [ptransport.RemotePSBackend([addr], async_mode=True)
               for _ in range(2)]
    try:
        init = np.zeros(64, np.float32)
        for c in clients:
            c.init_key(1, init.nbytes, "float32", init=init)
        for i, c in enumerate(clients):
            c.push(1, np.full(64, i + 1, np.float32))
        _quiesce(clients[0], 1, 2)
        out = clients[1].push_pull(1, np.full(64, 4, np.float32))
        assert out.min() >= 3.0
        _quiesce(clients[1], 1, 3)
        final = np.empty(64, np.float32)
        clients[0].pull(1, final, round=5)      # no round waited for
        assert (final == 7.0).all()
    finally:
        for c in clients:
            c.close()
        srv.close()
        srv_be.close()
