"""Bounded staleness in the port's exchange (``server/ps_mode.py``) against
the JAX package's, on the CPU: which keys ride the lag store, what K=1 and
K=2 leave of the sums, the capability check, and the ``lag_admit`` events
of the server and the worker.

Sums are compared bit for bit. Two workers over one in-process backend
are scripted: worker 1's round is pushed only after worker 0's pull
sealed it (grace 0), so every verdict is fixed by the order of events.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from byteps_tpu.common.naming import NameRegistry as JNameRegistry
from byteps_tpu.compress import device as jdev
from byteps_tpu.obs import flight as jflight
from byteps_tpu.server.engine import HostPSBackend as JBackend
from byteps_tpu.server.ps_mode import PSGradientExchange as JExchange
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.obs import flight as pflight
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.server import admission as padm
from byteps_tpu_torch.server.engine import HostPSBackend, PSServer
from byteps_tpu_torch.server.ps_mode import PSGradientExchange

README = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
          "ef_type": "vanilla", "momentum_type": "nesterov"}
SHAPES = [(700,), (40, 30), (2500,), (64,)]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    for name in ("BPS_COMPRESS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
                 "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF", "BPS_WORKER_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    monkeypatch.setenv("BPS_LAG_GRACE_MS", "0")
    tdev.reset_probe()
    jdev.reset_probe()
    yield
    for rec in (pflight.get_recorder(), jflight.get_recorder()):
        rec.clear()
        rec.configure(enabled=False)
    tdev.reset_probe()
    jdev.reset_probe()
    torch.set_num_threads(n)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {f"l{i}": (rng.randn(*s) * (i + 1)).astype(np.float32)
            for i, s in enumerate(SHAPES)}


def _port_tree(t):
    return [(k, torch.from_numpy(v)) for k, v in t.items()]


def _port(be, K, reg=None, partition=4 << 10, **kw):
    return PSGradientExchange(be, partition_bytes=partition,
                              registry=reg or NameRegistry(), max_lag=K,
                              device="cpu", **kw)


def _jax(be, K, reg=None, partition=4 << 10, **kw):
    return JExchange(be, partition_bytes=partition,
                     registry=reg or JNameRegistry(), max_lag=K, **kw)


def test_k1_never_allocates_a_lag_store():
    """K=1 (as JAX ``test_exchange_k1_never_routes_lag``): nothing is
    declared, pushed or pulled through the store, which is never made."""
    for Backend, make, tree in ((HostPSBackend, _port, _port_tree),
                                (JBackend, _jax, None)):
        be = Backend(num_servers=1, num_workers=1, engine_threads=1)
        ex = make(be, 1)
        try:
            t = _tree(0)
            out = ex.exchange(tree(t) if tree else
                              {k: jnp.asarray(v) for k, v in t.items()},
                              name="g")
            assert be._stale is None
            if tree:
                for o, v in zip(out, t.values()):
                    assert o.tobytes() == v.tobytes()
        finally:
            ex.close()
            be.close()


def test_k2_at_world_one_is_k1_bit_for_bit():
    """World 1: every round completes, so three rounds at K=2 (through
    the lag store) are the K=1 sums and the JAX exchange's at K=2, bit for
    bit; every pull's verdict is complete."""
    trees = [_tree(10 + r) for r in range(3)]
    got = {}
    reg = get_registry()
    for K in (1, 2):
        be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
        ex = _port(be, K)
        c0 = reg.counter("ps/lag_complete").value
        try:
            got[K] = [[o.copy() for o in ex.exchange(_port_tree(t), "g")]
                      for t in trees]
            (_, keyed), = ex._plans.values()
            if K == 2:
                assert all(be._stale.managed(k) for k, _ in keyed)
                assert be._stale.round(keyed[0][0]) == 3
                assert reg.counter("ps/lag_complete").value - c0 == \
                    3 * len(keyed)
        finally:
            ex.close()
            be.close()
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    jex = _jax(jbe, 2)
    try:
        for r, t in enumerate(trees):
            want = jex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                                name="g")
            for a, b, k in zip(got[1][r], got[2][r], sorted(t)):
                assert a.tobytes() == b.tobytes()
                assert b.tobytes() == np.asarray(want[k]).tobytes()
        assert jbe._stale is not None
    finally:
        jex.close()
        jbe.close()


@pytest.mark.parametrize("kind", ["chain", "int8-plane"])
def test_only_dense_keys_ride_the_store(kind):
    """K=2: a declaration with a legacy chain, or buckets the int8 plane
    compresses, keep those keys at K=1 (their codecs assume complete
    sums); the dense keys beside them are declared. The JAX exchange
    routes the same keys, and the sums agree bit for bit."""
    floor = 6 << 10
    kw = ({"min_compress_bytes": floor} if kind == "chain"
          else {"min_compress_bytes": floor, "compress": "int8"})
    kw["partition"] = 8 << 10
    reg, jreg = NameRegistry(), JNameRegistry()
    if kind == "chain":
        reg.declare("g", **README)
        jreg.declare("g", **README)
    trees = [_tree(20 + r) for r in range(2)]
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    ex = _port(be, 2, reg, **kw)
    try:
        got = [[o.copy() for o in ex.exchange(_port_tree(t), "g")]
               for t in trees]
        (_, keyed), = ex._plans.values()
        keys = [k for k, _ in keyed]
        lagged = {k for k in keys if be._stale.managed(k)}
        skipped = (set(ex._chains) if kind == "chain"
                   else {k for k in keys if ex._cplane.active(k)})
        assert skipped and lagged and lagged == set(keys) - skipped
        assert lagged == {k for k in keys if ex._lag_routes(k)}
    finally:
        ex.close()
        be.close()
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    jex = _jax(jbe, 2, jreg, **kw)
    try:
        for t, g in zip(trees, got):
            want = jex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                                name="g")
            for o, k in zip(g, sorted(t)):
                assert o.tobytes() == np.asarray(want[k]).tobytes()
        assert {k for k in keys if jbe._stale.managed(k)} == lagged
    finally:
        jex.close()
        jbe.close()


def test_a_backend_without_the_lag_surface_raises_at_construction():
    """K=2 over a raw engine (no ``push_lag``) would train at K=1 while
    the worker runs ahead: both exchanges refuse it."""
    srv = PSServer(num_workers=1, engine_threads=1)
    try:
        with pytest.raises(ValueError, match="BPS_MAX_LAG=2 needs a backend"):
            _port(srv, 2)
        _port(srv, 1).close()           # K=1 needs no lag surface
    finally:
        srv.close()
    from byteps_tpu.server.engine import PSServer as JPSServer
    jsrv = JPSServer(num_workers=1, engine_threads=1)
    try:
        with pytest.raises(ValueError, match="BPS_MAX_LAG=2 needs a backend"):
            _jax(jsrv, 2)
    finally:
        jsrv.close()


def _two_workers(Backend, make, to_tree, monkeypatch):
    """Round 1 of both workers at once, on a thread each, under a grace
    far above any scheduling jitter: a complete round. Then grace 0.
    Round 2: worker 0 exchanges alone, and its pulls
    seal without worker 1 (grace 0); then worker 1 exchanges its round 2,
    whose pushes late-fold into round 3 and whose pulls read the sealed
    snapshots. Round 3 of worker 0 completes with worker 1's late push.
    Returns each worker's outputs by (worker, round) and the trees."""
    be = Backend(num_servers=1, num_workers=2, engine_threads=1)
    ex = [make(be, 2, worker_id=w, pipeline_depth=1) for w in (0, 1)]
    trees = {(w, r): _tree(100 * w + r) for w in (0, 1) for r in (1, 2, 3)}
    try:
        for e in ex:                # both declare before either pushes
            e.plan_for(to_tree(trees[0, 1]), "g")
        monkeypatch.setenv("BPS_LAG_GRACE_MS", "60000")
        outs = {}

        def first(w):
            outs[w, 1] = ex[w].exchange(to_tree(trees[w, 1]), "g")

        threads = [threading.Thread(target=first, args=(w,), daemon=True)
                   for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive(), "round 1 did not complete"
        monkeypatch.setenv("BPS_LAG_GRACE_MS", "0")
        outs[0, 2] = ex[0].exchange(to_tree(trees[0, 2]), "g")
        outs[1, 2] = ex[1].exchange(to_tree(trees[1, 2]), "g")
        outs[0, 3] = ex[0].exchange(to_tree(trees[0, 3]), "g")
        return outs, trees
    finally:
        for e in ex:
            e.close()
        be.close()


def test_lag_admit_events_on_the_server_and_the_worker(monkeypatch):
    """Two in-process workers at K=2, grace 0, in a scripted order: the
    server's ``lag_admit`` decisions (round 2 sealed without worker 1)
    and each worker's ``lag_admit`` note of its stale verdicts are flight
    events, key-less, the JAX package's detail for detail; the sums are
    the JAX exchanges' bit for bit, and the verdicts are counted."""
    reg = get_registry()
    before = {n: reg.counter(f"ps/lag_{n}").value
              for n in ("complete", "stale", "barrier")}
    events, results = {}, {}
    for side, rec, Backend, make, to_tree in (
            ("port", pflight.get_recorder(), HostPSBackend, _port,
             _port_tree),
            ("jax", jflight.get_recorder(), JBackend, _jax,
             lambda t: {k: jnp.asarray(v) for k, v in t.items()})):
        rec.configure(enabled=True)
        rec.clear()
        results[side], trees = _two_workers(Backend, make, to_tree,
                                            monkeypatch)
        lag = [e for e in rec.events() if e["kind"] == "lag_admit"]
        assert lag and all("key" not in e for e in lag)
        events[side] = [e["detail"] for e in lag]
        rec.configure(enabled=False)
    assert events["port"] == events["jax"]
    served = [d for d in events["port"] if d.endswith("(served)")]
    decided = [d for d in events["port"] if not d.endswith("(served)")]
    nkeys = len(decided)
    assert nkeys > 1 and len(served) == 2 * nkeys
    assert all(d.startswith("verdict=stale") and " round=2 " in d
               and "missing=[1]" in d for d in decided)
    assert all(d.startswith("verdict=stale") and " round=2 " in d
               for d in served)
    for key, got in results["port"].items():
        want = results["jax"][key]
        for o, k in zip(got, sorted(want)):
            assert o.tobytes() == np.asarray(want[k]).tobytes()
    port = results["port"]
    for i, k in enumerate(sorted(trees[0, 1])):
        np.testing.assert_array_equal(port[0, 1][i],
                                      trees[0, 1][k] + trees[1, 1][k])
        # round 2: worker 0's alone, the same snapshot for worker 1
        assert port[0, 2][i].tobytes() == port[1, 2][i].tobytes() \
            == trees[0, 2][k].tobytes()
        # round 3: worker 1's late round 2 and worker 0's round 3
        np.testing.assert_array_equal(port[0, 3][i],
                                      trees[1, 2][k] + trees[0, 3][k])
    after = {n: reg.counter(f"ps/lag_{n}").value - before[n]
             for n in before}
    assert after == {"complete": 3 * nkeys, "stale": 2 * nkeys,
                     "barrier": 0}


def test_plane_worker_id_reaches_the_wire_packing(monkeypatch):
    """The exchange's worker id is the plane's: from ``worker_id=``, else
    ``BPS_WORKER_ID``."""
    be = HostPSBackend(num_servers=1, num_workers=4, engine_threads=1)
    try:
        monkeypatch.setenv("BPS_WORKER_ID", "3")
        ex = _port(be, 2)
        assert ex.plane.worker_id == 3 and ex.plane.gate.depth == 2
        ex.close()
        ex = _port(be, 2, worker_id=1)
        assert ex.plane.worker_id == 1
        ex.close()
        assert padm.AdmissionPlane(max_lag=2).gate_round(5) == 3
    finally:
        be.close()
