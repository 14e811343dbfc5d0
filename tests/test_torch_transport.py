"""The port's TCP transport (``byteps_tpu_torch/server/transport.py``)
against the JAX package's (``byteps_tpu/server/transport.py``): the cases
of ``tests/test_transport.py`` for the ported ops, each run in the four
pairings {port, JAX} client x {port, JAX} server, so a frame either side
writes is one the other side reads; the golden frames of every ported op,
byte for byte; a push whose connection drops before its ACK (reconnect,
init replay, the same token, applied once); and the unported ops, which
the port's server answers with an error frame naming their ROADMAP item.

Sums here are of one or two arrivals, exact in fp32, so every comparison
is exact but the bf16 transcode's, whose tolerance is the JAX test's
(bf16 keeps 8 bits of mantissa).
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

REPO = Path(__file__).resolve().parent.parent

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]
pairs = pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)

_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}
_REGISTRY = {"port": pregistry, "jax": jregistry}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_SHM", "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT",
                 "BPS_KEY_LOG", "PS_KEY_LOG", "BPS_REDUCE_ROOTS"):
        monkeypatch.delenv(name, raising=False)


class _Srv:
    def __init__(self, kind, workers=2, host_backend=False):
        eng = _ENGINE[kind]
        self.backend = (eng.HostPSBackend(num_servers=1, num_workers=workers,
                                          engine_threads=1)
                        if host_backend else
                        eng.PSServer(num_workers=workers, engine_threads=2))
        self.srv = _TRANSPORT[kind].PSTransportServer(
            self.backend, host="127.0.0.1", port=0)
        self.addr = f"127.0.0.1:{self.srv.port}"

    def close(self):
        self.srv.close()
        self.backend.close()


@pytest.fixture
def server2(server):
    s = _Srv(server)
    yield s
    s.close()


def _client(kind, addrs, **kw):
    return _TRANSPORT[kind].RemotePSBackend(list(addrs), **kw)


def _both(fn, *args_per_thread):
    ts = [threading.Thread(target=fn, args=a) for a in args_per_thread]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts), "a worker thread hung"


# -- the cases of tests/test_transport.py, in every pairing ------------------

@pairs
def test_remote_push_pull_sums_two_workers(client, server, server2):
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    a = np.arange(1024, dtype=np.float32)
    w1.init_key(7, a.nbytes)
    w2.init_key(7, a.nbytes)
    outs = [np.empty_like(a), np.empty_like(a)]

    def worker(be, out):
        be.push(7, a)
        be.pull(7, out, round=1)

    _both(worker, (w1, outs[0]), (w2, outs[1]))
    for o in outs:
        np.testing.assert_array_equal(o, 2 * a)
    w1.close()
    w2.close()


@pairs
def test_remote_multiple_rounds(client, server, server2):
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    x = np.ones(256, np.float32)
    for w in (w1, w2):
        w.init_key(3, x.nbytes)
    for rnd in range(1, 4):
        outs = [np.empty_like(x), np.empty_like(x)]

        def go(w, o):
            w.push(3, x * rnd)
            w.pull(3, o, round=rnd)

        _both(go, (w1, outs[0]), (w2, outs[1]))
        for o in outs:
            np.testing.assert_array_equal(o, 2.0 * rnd)
    assert w1.round(3) == 3
    w1.close()
    w2.close()


@pairs
def test_key_sharding_across_servers(client, server):
    """Keys spread over two transport servers by djb2: both clients place
    them alike (each key lands where the other framework put it)."""
    s1, s2 = _Srv(server, workers=1), _Srv(server, workers=1)
    try:
        w = _client(client, [s1.addr, s2.addr])
        data = {k: np.full(64, float(k), np.float32) for k in range(8)}
        for k, v in data.items():
            w.init_key(k, v.nbytes)
            w.push(k, v)
        for k, v in data.items():
            out = np.empty_like(v)
            w.pull(k, out, round=1)
            np.testing.assert_array_equal(out, v)
        # the engine of each server holds the keys djb2 gave it
        from byteps_tpu_torch.common.naming import place_key
        for k in data:
            shard = (s1, s2)[place_key(k, 2)]
            assert shard.backend.round(k) == 1
        w.close()
    finally:
        s1.close()
        s2.close()


@pairs
def test_gradient_exchange_over_wire(client, server, server2):
    """The client's own framework's ``PSGradientExchange`` over the wire."""
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    if client == "port":
        from byteps_tpu_torch.server.ps_mode import PSGradientExchange
        tree = [("a", np.ones((100, 30), np.float32)),
                ("b", np.full((64,), 2.0, np.float32))]
    else:
        import jax.numpy as jnp

        from byteps_tpu.server.ps_mode import PSGradientExchange
        tree = {"a": jnp.ones((100, 30)), "b": jnp.full((64,), 2.0)}
    res = [None, None]
    exs = [PSGradientExchange(w, partition_bytes=4096) for w in (w1, w2)]

    def go(i):
        res[i] = exs[i].exchange(tree)

    _both(go, (0,), (1,))
    for r in res:
        a, b = (r[0], r[1]) if client == "port" else (r["a"], r["b"])
        np.testing.assert_array_equal(np.asarray(a), 2.0)
        np.testing.assert_array_equal(np.asarray(b), 4.0)
    for ex in exs:
        ex.close()
    w1.close()
    w2.close()


@pairs
def test_cross_process_server(client, server):
    """Workers in this process, the server a process of its own, started
    by each framework's launcher (``--server``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    module = ("byteps_tpu_torch.launcher.launch" if server == "port"
              else "byteps_tpu.launcher.launch")
    env = dict(os.environ, BPS_SERVER_PORT=str(port), BPS_NUM_PROCESSES="2",
               JAX_PLATFORMS="cpu")
    env.pop("BPS_NUM_WORKER", None)
    proc = subprocess.Popen([sys.executable, "-m", module, "--server"],
                            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while True:
            try:
                w1 = _client(client, [f"127.0.0.1:{port}"])
                break
            except OSError:
                assert proc.poll() is None, "the server process died"
                assert time.time() < deadline, "server never came up"
                time.sleep(0.2)
        w2 = _client(client, [f"127.0.0.1:{port}"])
        x = np.arange(512, dtype=np.float32)
        outs = [np.empty_like(x), np.empty_like(x)]
        for w in (w1, w2):
            w.init_key(1, x.nbytes)

        def go(w, o):
            w.push(1, x)
            w.pull(1, o, round=1)

        _both(go, (w1, outs[0]), (w2, outs[1]))
        for o in outs:
            np.testing.assert_array_equal(o, 2 * x)
        w1.close()
        w2.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@pairs
def test_error_frames_keep_connection_alive(client, server, server2):
    w = _client(client, [server2.addr], conns_per_shard=1)
    good = np.ones(128, np.float32)
    w.init_key(5, good.nbytes)
    with pytest.raises(RuntimeError, match="rejected"):
        w.push(5, np.ones(999, np.float32))        # wrong length
    w.push(5, good)                                # the connection survives
    w2 = _client(client, [server2.addr])
    w2.init_key(5, good.nbytes)
    w2.push(5, good)
    out = np.empty_like(good)
    w.pull(5, out, round=1)
    np.testing.assert_array_equal(out, 2.0)
    w.close()
    w2.close()


@pairs
def test_pull_into_2d_array(client, server, server2):
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    a = np.arange(64, dtype=np.float32).reshape(8, 8)
    for w in (w1, w2):
        w.init_key(9, a.nbytes)
    outs = [np.empty_like(a), np.empty_like(a)]

    def go(w, o):
        w.push(9, a)
        w.pull(9, o, round=1)

    _both(go, (w1, outs[0]), (w2, outs[1]))
    for o in outs:
        np.testing.assert_array_equal(o, 2 * a)
    w1.close()
    w2.close()


@pairs
def test_push_pull_round_counter(client, server):
    s = _Srv(server, workers=1)
    try:
        w = _client(client, [s.addr])
        x = np.ones(32, np.float32)
        w.init_key(2, x.nbytes)
        for i in range(1, 4):
            np.testing.assert_array_equal(w.push_pull(2, x * i), x * i)
        assert w.round(2) == 3
        w.close()
    finally:
        s.close()


def _raw_push(client, w, key, token, arr):
    t = _TRANSPORT[client]
    w._rpc(t.OP_PUSH, key, token, 0, 0, "float32", t._as_bytes(arr))


@pairs
def test_duplicate_push_retry_is_deduplicated(client, server, server2):
    """A push retried after a lost ACK (the same token) is applied once."""
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    a = np.arange(64, dtype=np.float32)
    b = 10 * np.ones(64, np.float32)
    w1.init_key(5, a.nbytes)
    w2.init_key(5, a.nbytes)
    w1.push(5, a)                          # seq 1
    _raw_push(client, w1, 5, (w1._wid << 32) | 1, a)
    w2.push(5, b)
    out = np.empty_like(a)
    w1.pull(5, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, a + b)      # not 2a + b
    w1.close()
    w2.close()


@pairs
def test_untokened_pushes_keep_at_least_once_semantics(client, server,
                                                       server2):
    w = _client(client, [server2.addr])
    a = np.ones(32, np.float32)
    w.init_key(9, a.nbytes)
    _raw_push(client, w, 9, 0, a)
    _raw_push(client, w, 9, 0, a)
    out = np.empty_like(a)
    w.pull(9, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, 2 * a)
    w.close()


@pairs
def test_dedup_tokens_are_per_incarnation(client, server, server2):
    """A restarted worker's seq starts over under a new incarnation."""
    w1 = _client(client, [server2.addr])
    a = np.ones(16, np.float32)
    w1.init_key(2, a.nbytes)
    w1.push(2, a)
    w1.close()
    w1b = _client(client, [server2.addr])
    w1b.push(2, 2 * a)
    out = np.empty_like(a)
    w1b.pull(2, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, 3 * a)
    w1b.close()


@pairs
def test_duplicate_racing_inflight_apply_blocks_then_dedups(client, server,
                                                            server2):
    """A retry landing while the original's apply runs waits for its
    outcome: one contribution either way."""
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    a = np.ones(128, np.float32)
    w1.init_key(21, a.nbytes)
    w2.init_key(21, a.nbytes)
    real_push = server2.backend.push

    def slow_push(key, data):
        time.sleep(0.3)
        real_push(key, data)

    server2.backend.push = slow_push
    try:
        tok = (w1._wid << 32) | 1
        t = threading.Thread(target=_raw_push, args=(client, w1, 21, tok, a))
        t.start()
        time.sleep(0.05)            # the original is inside slow_push
        _raw_push(client, w2, 21, tok, a)
        t.join(30)
    finally:
        server2.backend.push = real_push
    w2.push(21, 2 * a)
    out = np.empty_like(a)
    w1.pull(21, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, 3 * a)      # not 4a
    w1.close()
    w2.close()


@pairs
def test_out_of_order_tokened_pushes_both_apply(client, server, server2):
    """Exact-membership dedup: seq 2 landing before seq 1 drops neither."""
    w = _client(client, [server2.addr])
    a = np.ones(32, np.float32)
    w.init_key(31, a.nbytes)
    _raw_push(client, w, 31, (w._wid << 32) | 2, 2 * a)
    _raw_push(client, w, 31, (w._wid << 32) | 1, a)
    out = np.empty_like(a)
    w.pull(31, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, 3 * a)
    w.close()


@pairs
def test_pull_timeout_is_global_across_slices(client, server, server2,
                                              monkeypatch):
    """A round that never fills times out at the caller's one deadline
    (here three server-side slices), loudly."""
    monkeypatch.setattr(_TRANSPORT[client].RemotePSBackend,
                        "_PULL_SLICE_MS", 500)
    w = _client(client, [server2.addr])
    x = np.ones(64, np.float32)
    w.init_key(41, x.nbytes)
    w.push(41, x)                      # 1 of 2 workers: never completes
    out = np.empty_like(x)
    t0 = time.time()
    with pytest.raises(TimeoutError):
        w.pull(41, out, round=1, timeout_ms=1500)
    dt = time.time() - t0
    assert 1.2 < dt < 6.0, dt
    w.close()


@pairs
def test_wire_dtype_transcode_over_tcp(client, server):
    """A bf16 push frame lands in an fp32 store, and a bf16 pull gets the
    store downcast (the server fronts its framework's ``HostPSBackend``)."""
    import ml_dtypes
    s = _Srv(server, workers=1, host_backend=True)
    try:
        w = _client(client, [s.addr])
        base = np.linspace(-4, 4, 256).astype(np.float32)
        w.init_key(11, base.nbytes, "float32")
        w.push(11, base.astype(ml_dtypes.bfloat16))
        out = np.empty(256, np.float32)
        w.pull(11, out, round=1)
        np.testing.assert_allclose(out, base, rtol=1e-2)
        assert not np.allclose(out, base, rtol=1e-7)
        np.testing.assert_array_equal(
            out, base.astype(ml_dtypes.bfloat16).astype(np.float32))
        out16 = np.empty(256, ml_dtypes.bfloat16)
        w.pull(11, out16, round=1)
        np.testing.assert_array_equal(out16.astype(np.float32), out)
        w.close()
    finally:
        s.close()


@pairs
def test_fused_and_legacy_planes_over_the_wire(client, server, server2):
    """The fused plane (OP_PUSH_F/OP_PULL_F, int8 payloads) and a legacy
    onebit chain (OP_INIT_C/PUSH_C/PULL_C) between the pairing: the merged
    payloads both clients pull are the same bytes."""
    from byteps_tpu_torch.compress import wire
    from byteps_tpu_torch.ops.compression import host
    w1, w2 = _client(client, [server2.addr]), _client(client, [server2.addr])
    n = 4096
    g = [np.random.RandomState(i).standard_normal(n).astype(np.float32)
         for i in (0, 1)]
    kw = {"compressor_type": "onebit", "compressor_onebit_scaling": "true"}
    for w in (w1, w2):
        w.init_key(100, 4 * n, "float32", fused=True)
        w.init_key(101, 4 * n, "float32", compression=kw)
    outs = [None, None]

    def go(i, w):
        w.push_fused(100, wire.encode(wire.CODEC_INT8, g[i], seed=0))
        chain = host.create_host_chain(kw, n, "float32")
        w.push_bytes(101, chain.compress(g[i]))
        outs[i] = (w.pull_fused(100, 4 * n, "float32", wire.CODEC_INT8,
                                round=1),
                   w.pull_bytes(101, round=1))

    _both(go, (0, w1), (1, w2))
    assert outs[0] == outs[1]
    dense = sum(wire.decode(wire.encode(wire.CODEC_INT8, x, seed=0), n,
                            np.float32) for x in g)
    assert outs[0][0] == wire.encode(wire.CODEC_INT8, dense,
                                     seed=wire.sr_seed(100, 1))
    assert w1.round(100) == 1 and w1.round(101) == 1
    w1.close()
    w2.close()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_a_late_fused_declaration_keeps_the_early_arrival(client):
    """Every worker declares every key, and a slow worker's declaration may
    land after a fast worker's push: the port's server keeps the buffered
    arrival (the JAX front would start a new tenancy and wedge the
    round; ROADMAP.md queue 3), and a replayed declaration keeps the
    key's rounds."""
    from byteps_tpu_torch.compress import wire
    s = _Srv("port")
    try:
        w1, w2 = _client(client, [s.addr]), _client(client, [s.addr])
        g = [np.full(1024, 1.0 + i, np.float32) for i in (0, 1)]
        w1.init_key(8, 4096, "float32", fused=True)
        w1.push_fused(8, wire.encode(wire.CODEC_INT8, g[0]))
        w2.init_key(8, 4096, "float32", fused=True)      # the late one
        w2.push_fused(8, wire.encode(wire.CODEC_INT8, g[1]))
        got = [w.pull_fused(8, 4096, "float32", wire.CODEC_INT8, round=1,
                            timeout_ms=5000) for w in (w1, w2)]
        assert got[0] == got[1]
        np.testing.assert_array_equal(
            wire.decode(got[0], 1024, np.float32), 3.0)
        w1.init_key(8, 4096, "float32", fused=True)      # a replay
        assert w1.round(8) == 1
        w1.close()
        w2.close()
    finally:
        s.close()


# -- the wire credit gate (BPS_SCHEDULING_CREDIT) ---------------------------

def _admission_order(mod):
    """One frame holds the whole credit while frames of other priorities
    and keys queue behind it; the order they are admitted in."""
    sc = mod.SendScheduler(credit_bytes=1 << 16)
    first = sc.acquire(mod.CLASS_GRAD, 0, 99, 1 << 16)
    order, ts = [], []
    for prio, key in ((1, 5), (7, 3), (7, 2), (3, 1)):
        def take(prio=prio, key=key):
            t = sc.acquire(mod.CLASS_GRAD, prio, key, 1 << 15)
            order.append((prio, key))
            sc.release(t)
        ts.append(threading.Thread(target=take))
        ts[-1].start()
        while sc.queued() < len(ts):          # enqueued in this order
            time.sleep(0.001)
    sc.release(first)
    for t in ts:
        t.join(10)
    assert not any(t.is_alive() for t in ts)
    return order, [e["class"] for e in sc.trace()]


def test_send_scheduler_admits_in_the_jax_order():
    from byteps_tpu.server import admission as jadm
    from byteps_tpu_torch.server import admission as padm
    mine, ref = _admission_order(padm), _admission_order(jadm)
    assert mine == ref
    assert mine[0] == [(7, 2), (7, 3), (3, 1), (1, 5)]   # prio, then key
    assert padm.MIN_SCHED_BYTES == jadm.MIN_SCHED_BYTES
    assert padm.ACT_PRIO_BASE == jadm.ACT_PRIO_BASE
    assert (padm.CLASS_GRAD, padm.CLASS_ACT) == (jadm.CLASS_GRAD,
                                                 jadm.CLASS_ACT)


def test_scheduling_credit_gates_the_clients_gradient_frames(monkeypatch):
    """With ``BPS_SCHEDULING_CREDIT`` the port's client takes a ticket for
    each gradient frame above the floor (its key's send priority on it)
    and none for pulls or small frames."""
    from byteps_tpu_torch.server import admission
    monkeypatch.setenv("BPS_SCHEDULING_CREDIT", str(1 << 16))
    monkeypatch.setattr(admission, "_send_configured", False)
    s = _Srv("port", workers=1)
    try:
        w = ptransport.RemotePSBackend([s.addr])
        big, small = np.ones(8192, np.float32), np.ones(64, np.float32)
        for key, x in ((1, big), (2, small)):
            w.init_key(key, x.nbytes)
        w.set_send_priority(1, 9)
        np.testing.assert_array_equal(w.push_pull(1, big), big)
        np.testing.assert_array_equal(w.push_pull(2, small), small)
        trace = admission.send_scheduler().trace()
        assert [(e["class"], e["key"], e["prio"], e["nbytes"])
                for e in trace] == [("grad", 1, 9, big.nbytes)]
        w.close()
    finally:
        s.close()
        admission.configure_send(0)


# -- golden frames ----------------------------------------------------------

def _frames():
    from byteps_tpu_torch.ops.compression.host import serialize_kwargs
    init = np.arange(8, dtype=np.float32)
    kw = serialize_kwargs({"compressor_type": "onebit"})
    t = ptransport
    return {
        "INIT": (t.OP_INIT, 3, 1, 32, 0, "float32", init.view(np.uint8)),
        "INIT_nopayload": (t.OP_INIT, 3, 0, 32, 0, "float32", None),
        "PUSH": (t.OP_PUSH, 1 << 16 | 2, (77 << 32) | 5, 0, 0, "float32",
                 init.view(np.uint8)),
        "PULL": (t.OP_PULL, 65538, 4, 4096, 2000, "float32", None),
        "CLOSE": (t.OP_CLOSE, 0, 0, 0, 0, "", None),
        "INIT_C": (t.OP_INIT_C, 9, 0, 16388, 0, "float32",
                   memoryview(kw)),
        "PUSH_C": (t.OP_PUSH_C, 9, (3 << 32) | 1, 0, 0, "uint8",
                   memoryview(b"\x01\x02\x03\x04payload")),
        "PULL_C": (t.OP_PULL_C, 9, 2, 0, 1500, "uint8", None),
        "ROUND": (t.OP_ROUND, 12345, 0, 0, 0, "uint8", None),
        "PUSH_F": (t.OP_PUSH_F, 7, (9 << 32) | 3, 0, 0, "uint8",
                   memoryview(bytes(range(40)))),
        "PULL_F": (t.OP_PULL_F, 7, 3, 16384, 2000, "float32",
                   b"\x02" + (8).to_bytes(2, "little")),
        "PULL_bf16": (t.OP_PULL, 11, 1, 512, 2000, "bfloat16", None),
    }


def _written(send_req, args) -> bytes:
    a, b = socket.socketpair()
    try:
        send_req(a, *args)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", sorted(_frames()))
def test_golden_frames_match_the_jax_package(name):
    args = _frames()[name]
    mine = _written(ptransport._send_req, args)
    ref = _written(jtransport._send_req, args)
    assert mine == ref
    assert len(mine) == ptransport._HDR.size + (
        0 if args[-1] is None else len(memoryview(args[-1]).cast("B")))
    # and the JAX server's parser reads the port's frame back
    a, b = socket.socketpair()
    try:
        a.sendall(mine)
        got = jtransport._recv_req(b)
        assert got[:6] == (args[0], args[1], args[2], args[3], args[4],
                           args[5])
    finally:
        a.close()
        b.close()


def test_ported_op_numbers_are_the_jax_packages():
    for name in ("OP_INIT", "OP_PUSH", "OP_PULL", "OP_CLOSE", "OP_INIT_C",
                 "OP_PUSH_C", "OP_PULL_C", "OP_PUSH_RS", "OP_ROUND",
                 "OP_PUSH_SHM", "OP_PULL_SHM", "OP_PUSH_PART", "OP_PULL_PART",
                 "OP_PUSH_F", "OP_PULL_F", "ST_OK", "ST_ERR", "ST_TIMEOUT", "ST_GONE"):
        assert getattr(ptransport, name) == getattr(jtransport, name), name
    assert ptransport._HDR.format == jtransport._HDR.format
    assert ptransport._PART.format == jtransport._PART.format
    assert ptransport._RSP.format == jtransport._RSP.format
    jops = {v for k, v in vars(jtransport).items() if k.startswith("OP_")}
    ported = {v for k, v in vars(ptransport).items() if k.startswith("OP_")}
    assert jops == ported | set(ptransport.UNPORTED_OPS)
    assert not ported & set(ptransport.UNPORTED_OPS)


# -- a dropped connection under a push --------------------------------------

@pairs
def test_push_resent_after_a_dropped_ack_applies_once(client, server,
                                                       server2):
    """The server applies a push, then its connection drops before the
    ACK: the client redials, replays its inits, and re-sends the push with
    the same token, which the server acknowledges without applying it
    again. ``transport/resends`` counts the one resend."""
    real = server2.srv._handle
    dropped = []

    class _Dropping:
        def __init__(self, conn):
            self.conn = conn

        def sendall(self, data):
            self.conn.shutdown(socket.SHUT_RDWR)
            raise ConnectionResetError("dropped before the ACK")

        def __getattr__(self, item):
            return getattr(self.conn, item)

    def handle(conn, op, key, *rest):
        if op == _TRANSPORT[server].OP_PUSH and key == 5 and not dropped:
            dropped.append(1)
            return real(_Dropping(conn), op, key, *rest)
        return real(conn, op, key, *rest)

    server2.srv._handle = handle
    resends = _REGISTRY[client]().counter("transport/resends")
    before = resends.value
    w1 = _client(client, [server2.addr], conns_per_shard=1)
    w2 = _client(client, [server2.addr])
    a = np.arange(64, dtype=np.float32)
    b = np.full(64, 10.0, np.float32)
    w1.init_key(5, a.nbytes)
    w2.init_key(5, a.nbytes)
    w1.push(5, a)                 # applied, ACK lost, resent, deduplicated
    assert dropped
    assert resends.value - before == 1
    w2.push(5, b)
    out = np.empty_like(a)
    w1.pull(5, out, round=1, timeout_ms=5000)
    np.testing.assert_array_equal(out, a + b)      # not 2a + b
    w1.close()
    w2.close()


# -- the ops the port does not serve -----------------------------------------

@pytest.mark.parametrize("op", sorted(ptransport.UNPORTED_OPS))
def test_unported_ops_get_an_error_frame_and_the_connection_lives(op):
    s = _Srv("port", workers=1)
    try:
        w = ptransport.RemotePSBackend([s.addr], conns_per_shard=1)
        x = np.ones(16, np.float32)
        w.init_key(4, x.nbytes)
        what, item = ptransport.UNPORTED_OPS[op]
        with pytest.raises(RuntimeError,
                           match=f"not ported.*ROADMAP.*item {item}"):
            w._rpc(op, 4, 1, 0, 0, "uint8", memoryview(b"\0" * 24))
        # the same (only) connection serves the next request
        np.testing.assert_array_equal(w.push_pull(4, x), x)
        w.close()
    finally:
        s.close()
