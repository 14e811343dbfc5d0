"""The shared-memory data plane (``BPS_ENABLE_SHM``, ops 10-11) of the
port's transport against the JAX package's, in the four pairings {port,
JAX} client x {port, JAX} server: sums, a resent push, a segment that
grows, the server's segment cache, the counted fallback when a segment
cannot be made or attached, two real worker processes, and the one
deliberate difference, where the bf16 wire transcode happens.

Sums here are of one or two fp32 arrivals, exact, so every comparison is
exact."""

import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

REPO = Path(__file__).resolve().parent.parent

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]
pairs = pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)

_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}

WAIT_S = 60


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_ENABLE_SHM", "1")
    # a short directory: a Unix socket's path holds at most 107 bytes
    d = tempfile.mkdtemp(dir="/tmp", prefix="bps-")
    os.chmod(d, 0o700)
    monkeypatch.setenv("BPS_IPC_DIR", d)
    yield
    for f in os.listdir(d):
        os.unlink(os.path.join(d, f))
    os.rmdir(d)


class _Srv:
    def __init__(self, kind, workers=2):
        self.backend = _ENGINE[kind].PSServer(num_workers=workers,
                                              engine_threads=2)
        self.srv = _TRANSPORT[kind].PSTransportServer(
            self.backend, host="127.0.0.1", port=0)
        self.addr = f"127.0.0.1:{self.srv.port}"

    def close(self):
        self.srv.close()
        self.backend.close()


@pytest.fixture
def srv(server):
    s = _Srv(server)
    yield s
    s.close()


def _client(kind, addr, **kw):
    return _TRANSPORT[kind].RemotePSBackend([addr], **kw)


def _both(fn, *args_per_thread):
    ts = [threading.Thread(target=fn, args=a) for a in args_per_thread]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ts), "a worker thread hung"


def _segments():
    return {f for f in os.listdir("/dev/shm") if f.startswith("bps-shm-")}


def _shm_counts():
    reg = pregistry()
    return (reg.counter("server/shm_pushes").value,
            reg.counter("server/shm_pulls").value,
            reg.counter("server/push_frames").value,
            reg.counter("server/pull_frames").value)


@pairs
def test_shm_push_pull_gives_the_jax_sums(client, server, srv):
    """Two workers push over their segments and pull round 1 and 2 into
    them: the exact sums; the port's server counts ops 10-11 and no op 2
    or 3; no client fell back to the socket."""
    ws = [_client(client, srv.addr) for _ in range(2)]
    rng = np.random.RandomState(0)
    xs = [rng.randn(3, 40000).astype(np.float32) for _ in range(2)]
    for w in ws:
        w.init_key(11, xs[0].nbytes)
    before = _shm_counts()
    outs = [[], []]

    def run(i):
        for r in (1, 2):
            outs[i].append(ws[i].push_pull(11, xs[i] * r))

    _both(run, (0,), (1,))
    for i in (0, 1):
        for r, out in zip((1, 2), outs[i]):
            assert out.shape == xs[0].shape
            np.testing.assert_array_equal(out, xs[0] * r + xs[1] * r)
        assert ws[i]._shm_shards == [True]
    got = [a - b for a, b in zip(_shm_counts(), before)]
    if server == "port":
        assert got == [4, 4, 0, 0]
    names = set()
    for w in ws:
        for _ in range(w._nconns):
            ch = w._pools[0].get()
            if ch.shm is not None:
                names.add(ch.shm.name.lstrip("/"))
            w._pools[0].put(ch)
    assert names <= _segments()
    for w in ws:
        w.close()
    assert not names & _segments()          # close() unlinks them


@pairs
def test_a_resent_shm_push_with_the_same_token_folds_once(client, server,
                                                          srv):
    w1, w2 = _client(client, srv.addr), _client(client, srv.addr)
    a = np.arange(300_000, dtype=np.float32)      # past the first 1 MiB
    w1.init_key(4, a.nbytes)
    w2.init_key(4, a.nbytes)
    w1.push(4, a)
    # the same token again, as a retry after a lost ACK sends it
    w1._shm_rpc(_TRANSPORT[client].OP_PUSH_SHM, 4, (w1._wid << 32) | 1,
                arr=a)
    w2.push(4, 2 * a)
    out = np.empty_like(a)
    w1.pull(4, out, round=1, timeout_ms=10000)
    np.testing.assert_array_equal(out, 3 * a)
    w1.close()
    w2.close()


@pairs
def test_a_segment_grows_for_a_larger_op(client, server, srv):
    """A channel's segment is at least 1 MiB; an op past it makes a larger
    one and unlinks the old name (the server keeps its mapping until it
    evicts it); ``close`` unlinks the rest."""
    w = _client(client, srv.addr, conns_per_shard=1)
    w1 = _client(client, srv.addr)
    small = np.ones(1000, np.float32)
    big = np.arange(1 << 19, dtype=np.float32)          # 2 MiB
    for c in (w, w1):
        c.init_key(1, small.nbytes)
        c.init_key(2, big.nbytes)
    w.push(1, small)
    ch = w._pools[0].get()
    first = ch.shm.name
    assert ch.shm.size == 1 << 20
    w._pools[0].put(ch)
    assert first.lstrip("/") in _segments()
    w.push(2, big)
    ch = w._pools[0].get()
    second = ch.shm.name
    assert ch.shm.size == big.nbytes and second != first
    w._pools[0].put(ch)
    assert first.lstrip("/") not in _segments()
    assert second.lstrip("/") in _segments()
    w1.push(1, small)
    w1.push(2, big)
    out = np.empty_like(big)
    w.pull(2, out, round=1, timeout_ms=10000)
    np.testing.assert_array_equal(out, 2 * big)
    w.close()
    w1.close()
    assert second.lstrip("/") not in _segments()


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_the_server_cache_evicts_by_count_and_by_bytes(kind):
    """``_ShmCache`` keeps the most recent segments: at most ``cap`` of
    them and at most ``cap_bytes`` (but always the one just viewed); a
    view still held keeps its segment mapped after the eviction."""
    t = _TRANSPORT[kind]
    segs = [ptransport._PosixShm(create=True, size=(1 << 20) * (i + 1))
            for i in range(4)]
    try:
        for i, s in enumerate(segs):
            s.buf[:4] = bytes([i]) * 4
        cache = t._ShmCache(cap=2, cap_bytes=1 << 40)
        held = cache.view(segs[0].name, 4)
        for s in segs[1:3]:
            cache.view(s.name, 4)
        assert list(cache._segs) == [segs[1].name, segs[2].name]
        assert bytes(held) == b"\0" * 4        # evicted, still mapped
        # bytes: 3 MiB + 4 MiB > 5 MiB, so segment 2 goes
        cache = t._ShmCache(cap=64, cap_bytes=5 << 20)
        cache.view(segs[2].name, 4)
        cache.view(segs[3].name, 4)
        assert list(cache._segs) == [segs[3].name]
        # the one just viewed stays even alone above the bound
        cache = t._ShmCache(cap=64, cap_bytes=1 << 20)
        assert bytes(cache.view(segs[3].name, 4)) == b"\3" * 4
        assert list(cache._segs) == [segs[3].name]
        with pytest.raises(ValueError, match="exceeds segment"):
            cache.view(segs[0].name, 2 << 20)
        del held
        cache.close()
    finally:
        for s in segs:
            s.unlink()
            s.close()


@pairs
@pytest.mark.parametrize("where", ["client-side", "server-side"])
def test_an_attach_failure_falls_back_to_the_socket_once(client, server,
                                                         where, srv,
                                                         monkeypatch):
    """A segment the worker cannot make (a full ``/dev/shm``) or the
    server cannot attach (no shared ``/dev/shm``) turns the plane off for
    that server once; the ops go over the socket with the same sums, and
    the port's client counts the fallback."""
    t = _TRANSPORT[client]
    if where == "client-side":
        def no_room(self, nbytes):
            raise OSError(28, "No space left on device")
        monkeypatch.setattr(t._Channel, "ensure_shm", no_room)
    else:
        def no_attach(name, nbytes):
            raise FileNotFoundError(2, "No such file or directory", name)
        monkeypatch.setattr(srv.srv._shm, "view", no_attach)
    fallbacks = pregistry().counter("transport/shm_fallbacks")
    before = fallbacks.value
    w1, w2 = _client(client, srv.addr), _client(client, srv.addr)
    x = np.arange(5000, dtype=np.float32)
    for w in (w1, w2):
        w.init_key(3, x.nbytes)
    for r in (1, 2, 3):
        w1.push(3, x * r)
        w2.push(3, x)
        out = np.empty_like(x)
        w1.pull(3, out, round=r, timeout_ms=10000)
        np.testing.assert_array_equal(out, x * r + x)
    assert w1._shm_shards == [False] and w2._shm_shards == [False]
    if client == "port":
        assert fallbacks.value - before == 2       # once a client
    w1.close()
    w2.close()


_WORKER = r"""
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
kind, addr, wid = sys.argv[1], sys.argv[2], int(sys.argv[3])
if kind == "port":
    from byteps_tpu_torch.server.transport import RemotePSBackend
else:
    from byteps_tpu.server.transport import RemotePSBackend
be = RemotePSBackend([addr])
sizes = (1000, 70000, 300000)
for k, n in enumerate(sizes):
    be.init_key(k, 4 * n)
for r in (1, 2, 3):
    for k, n in enumerate(sizes):
        be.push(k, np.full(n, (wid + 1) * r, np.float32))
    for k, n in enumerate(sizes):
        out = np.empty(n, np.float32)
        be.pull(k, out, round=r, timeout_ms=60000)
        assert (out == 3 * r).all(), (k, r, out[:4])
assert be._shm_shards == [True]
be.close()
print("DONE", flush=True)
"""


@pairs
def test_two_worker_processes_sum_over_shm(client, server, srv):
    """Two real worker processes, each with its own segments, three keys
    over three rounds: every pull is the exact sum and neither fell back
    (``tests/test_transport.py::test_shm_data_plane_cross_process``)."""
    before = _shm_counts()
    code = _WORKER.format(repo=str(REPO))
    env = dict(os.environ, BPS_ENABLE_SHM="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code, client, srv.addr,
                               str(w)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for w in (0, 1)]
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0 and "DONE" in out, (i, out[-2000:])
    if server == "port":
        got = [a - b for a, b in zip(_shm_counts(), before)]
        assert got == [18, 18, 0, 0]


class _Recording:
    """A ``PSServer`` that records the dtype of every push it is handed."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def push(self, key, data):
        self.seen.append(bf16.dtype_name(data))
        return self.inner.push(key, data)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_bf16_frames_over_shm_and_where_they_are_transcoded(server):
    """An async worker's bf16 delta over shm into an fp32 store. The JAX
    package's op 10 hands the bf16 array to the backend, whose engine
    casts it (its ``PSServer.push`` transcodes too); the port's handler
    casts it first, as its op 2 does, so the backend sees fp32 on every
    route. The stores agree bit for bit, and a bf16 pull over shm reads
    the store rounded to bf16 in both."""
    import ml_dtypes
    eng = _ENGINE[server].PSServer(num_workers=1, engine_threads=1,
                                   async_mode=True)
    rec = _Recording(eng)
    t = _TRANSPORT[server]
    srv = t.PSTransportServer(rec, host="127.0.0.1", port=0)
    try:
        w = ptransport.RemotePSBackend([f"127.0.0.1:{srv.port}"],
                                       async_mode=True)
        x0 = np.linspace(-2, 2, 6000).astype(np.float32)
        d = (np.random.RandomState(1).randn(6000) * 1e-2).astype(np.float32)
        w.init_key(5, x0.nbytes, "float32", init=x0)
        w.push(5, bf16.narrow(d))
        want = x0 + bf16.widen(bf16.narrow(d))
        store = np.empty_like(x0)
        deadline = time.time() + WAIT_S
        while True:     # an async engine folds the push on its own thread
            w.pull(5, store)
            if store.tobytes() == want.tobytes() or time.time() > deadline:
                break
            time.sleep(0.01)
        np.testing.assert_array_equal(store, want)
        narrow = np.empty(x0.size, bf16.BF16)
        w.pull(5, narrow)
        assert narrow.tobytes() == store.astype(ml_dtypes.bfloat16).tobytes()
        assert w._shm_shards == [True]
        assert rec.seen == (["bfloat16"] if server == "jax"
                            else ["float32"])
        w.close()
    finally:
        srv.close()
        eng.close()
