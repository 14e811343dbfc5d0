"""Bounded staleness on the wire: ops 26-28 (``OP_LAG_DECL``,
``OP_PUSH_LAG``, ``OP_PULL_LAG``) of the port's transport against the JAX
package's, in the four pairings {port, JAX} client x {port, JAX} server,
as ``test_torch_transport.py`` runs the other ops: the request frames and
the server's replies byte for byte (the packed ``worker << 48 | round``,
the verdict byte before the sum), a retried push folded once (the packed
round is the dedup token), ``OP_ROUND`` answered from a transport-owned
store, and the declarations replayed to a restarted server.

Every decision is scripted: grace 0 seals at once, and every pull is one
the decision table resolves without waiting.
"""

import socket
import threading

import numpy as np
import pytest

from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import admission as padm
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]
pairs = pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)

_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}
_REGISTRY = {"port": pregistry, "jax": jregistry}
K = 2
N = 64


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_SHM", "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT",
                 "BPS_KEY_LOG", "PS_KEY_LOG", "BPS_REDUCE_ROOTS",
                 "BPS_MAX_LAG"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_LAG_GRACE_MS", "0")


class _Srv:
    def __init__(self, kind, workers=2, host_backend=False, port=0):
        eng = _ENGINE[kind]
        self.backend = (eng.HostPSBackend(num_servers=1, num_workers=workers,
                                          engine_threads=1)
                        if host_backend else
                        eng.PSServer(num_workers=workers, engine_threads=2))
        self.srv = _TRANSPORT[kind].PSTransportServer(
            self.backend, host="127.0.0.1", port=port)
        self.addr = f"127.0.0.1:{self.srv.port}"

    def store(self):
        """The lag store that serves this server's rounds."""
        return (self.backend._stale if hasattr(self.backend, "push_lag")
                else self.srv._stale)

    def close(self):
        self.srv.close()
        self.backend.close()


def _client(kind, addrs, **kw):
    return _TRANSPORT[kind].RemotePSBackend(list(addrs), **kw)


def _grad(seed):
    return np.random.RandomState(seed).randn(N).astype(np.float32)


def test_lag_op_numbers_and_round_packing_are_the_jax_packages():
    for name in ("OP_LAG_DECL", "OP_PUSH_LAG", "OP_PULL_LAG"):
        assert getattr(ptransport, name) == getattr(jtransport, name), name
    assert ptransport._LAG_ROUND_MASK == jtransport._LAG_ROUND_MASK
    assert not {26, 27, 28} & set(ptransport.UNPORTED_OPS)
    for name in ("LAG_COMPLETE", "LAG_STALE", "LAG_BARRIER"):
        from byteps_tpu.server import admission as jadm
        assert getattr(padm, name) == getattr(jadm, name)


def _record_frames(monkeypatch, mod, log):
    real = mod._send_req

    def send_req(sock, *args):
        a, b = socket.socketpair()
        try:
            real(a, *args)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
        finally:
            a.close()
            b.close()
        if args[0] in (26, 27, 28):
            log.append(b"".join(chunks))
        return real(sock, *args)

    monkeypatch.setattr(mod, "_send_req", send_req)


@pytest.mark.parametrize("server", ["port", "jax"])
def test_client_frames_are_the_jax_packages_byte_for_byte(server,
                                                          monkeypatch):
    """The same calls from the port's client and the JAX client write the
    same bytes: the declaration (``round`` = K), the push (``round`` =
    worker << 48 | round, the gradient), the pull (the same packing and
    the pull slice as ``timeout``)."""
    frames = {}
    for kind in ("port", "jax"):
        frames[kind] = []
        _record_frames(monkeypatch, _TRANSPORT[kind], frames[kind])
        s = _Srv(server, workers=1)
        try:
            w = _client(kind, [s.addr], conns_per_shard=1)
            w.init_key(5, N * 4)
            w.declare_lag(5, K)
            w.push_lag(5, 3, 1, _grad(1))
            out = np.empty(N, np.float32)
            # worker 3 of a one-worker server: worker 0 is missing, and
            # the round seals without it
            assert w.pull_lag(5, 3, 1, out) == padm.LAG_STALE
            np.testing.assert_array_equal(out, _grad(1))
            w.close()
        finally:
            s.close()
    assert len(frames["port"]) == 3
    assert frames["port"] == frames["jax"]
    hdr = ptransport._HDR
    op, key, rnd, *_ = hdr.unpack(frames["port"][1][:hdr.size])
    assert (op, key, rnd >> 48, rnd & ptransport._LAG_ROUND_MASK) == \
        (27, 5, 3, 1)


def _raw(addr, frame: bytes) -> bytes:
    """One request on a fresh socket; the whole reply's bytes."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port))) as s:
        s.sendall(frame)
        head = b""
        while len(head) < ptransport._RSP.size:
            head += s.recv(ptransport._RSP.size - len(head))
        _, n = ptransport._RSP.unpack(head)
        body = b""
        while len(body) < n:
            body += s.recv(n - len(body))
    return head + body


def _frame(op, key, rnd, nbytes, timeout, dtype, payload=None) -> bytes:
    a, b = socket.socketpair()
    try:
        ptransport._send_req(a, op, key, rnd, nbytes, timeout, dtype, payload)
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


@pytest.mark.parametrize("host_backend", [False, True],
                         ids=["raw-engine", "host-backend"])
def test_server_replies_are_the_jax_packages_byte_for_byte(host_backend):
    """The same raw request frames to a port server and a JAX server get
    the same reply bytes: acknowledgements, ``OP_ROUND`` and each pull's
    verdict byte and sum (a complete round, a sealed one, the sealed one
    read again after the late push folded past it)."""
    t = ptransport
    g = [_grad(i).view(np.uint8) for i in range(4)]
    script = [
        (t.OP_INIT, 9, 0, N * 4, 0, "float32", None),
        (t.OP_LAG_DECL, 9, K, 0, 0, "uint8", None),
        (t.OP_PUSH_LAG, 9, (0 << 48) | 1, 0, 0, "float32", g[0]),
        (t.OP_PUSH_LAG, 9, (1 << 48) | 1, 0, 0, "float32", g[1]),
        (t.OP_PULL_LAG, 9, (0 << 48) | 1, N * 4, 2000, "float32", None),
        (t.OP_PUSH_LAG, 9, (0 << 48) | 2, 0, 0, "float32", g[2]),
        (t.OP_PULL_LAG, 9, (0 << 48) | 2, N * 4, 2000, "float32", None),
        (t.OP_PUSH_LAG, 9, (1 << 48) | 2, 0, 0, "float32", g[3]),
        (t.OP_ROUND, 9, 0, 0, 0, "uint8", None),
        (t.OP_PULL_LAG, 9, (1 << 48) | 2, N * 4, 2000, "float32", None),
    ]
    replies = {}
    for kind in ("port", "jax"):
        s = _Srv(kind, workers=2, host_backend=host_backend)
        try:
            replies[kind] = [_raw(s.addr, _frame(*f)) for f in script]
        finally:
            s.close()
    assert replies["port"] == replies["jax"]
    rsp = ptransport._RSP.size
    r1, r2, rnd, r2b = (replies["port"][i] for i in (4, 6, 8, 9))
    assert r1[rsp] == padm.LAG_COMPLETE and r2[rsp] == padm.LAG_STALE
    np.testing.assert_array_equal(np.frombuffer(r1[rsp + 1:], np.float32),
                                  _grad(0) + _grad(1))
    np.testing.assert_array_equal(np.frombuffer(r2[rsp + 1:], np.float32),
                                  _grad(2))
    assert int.from_bytes(rnd[rsp:], "big") == 2
    assert r2b == r2          # the sealed snapshot, the same bytes


@pairs
def test_lag_rounds_in_every_pairing(client, server):
    """Two workers at K=2, grace 0: a complete round; a round sealed
    without worker 1 (worker 0 reads a stale verdict); worker 1's late
    push folding into round 3, and worker 1 reading round 2's sealed
    snapshot, the same bytes; ``OP_ROUND`` from the transport-owned store
    of a raw engine."""
    s = _Srv(server, workers=2)
    try:
        w0 = _client(client, [s.addr])
        w1 = _client(client, [s.addr])
        for w in (w0, w1):
            w.init_key(4, N * 4)
            w.declare_lag(4, K)
        assert s.srv._stale is not None and s.srv._stale.declared(4) == K
        outs = [np.empty(N, np.float32) for _ in range(2)]
        w0.push_lag(4, 0, 1, _grad(0))
        w1.push_lag(4, 1, 1, _grad(1))
        for wid, w in enumerate((w0, w1)):
            assert w.pull_lag(4, wid, 1, outs[wid]) == padm.LAG_COMPLETE
            np.testing.assert_array_equal(outs[wid], _grad(0) + _grad(1))
        w0.push_lag(4, 0, 2, _grad(2))
        assert w0.pull_lag(4, 0, 2, outs[0]) == padm.LAG_STALE
        np.testing.assert_array_equal(outs[0], _grad(2))
        assert w1.round(4) == 2
        w1.push_lag(4, 1, 2, _grad(3))                 # late: folds to 3
        assert w1.pull_lag(4, 1, 2, outs[1]) == padm.LAG_STALE
        assert outs[1].tobytes() == outs[0].tobytes()
        w0.push_lag(4, 0, 3, _grad(4))
        assert w0.pull_lag(4, 0, 3, outs[0]) == padm.LAG_COMPLETE
        np.testing.assert_array_equal(outs[0], _grad(3) + _grad(4))
        assert w0.round(4) == 3
        assert s.srv._stale._keys[4].late_folds == 1
        w0.close()
        w1.close()
    finally:
        s.close()


@pairs
def test_a_retried_lag_push_folds_once(client, server):
    """The server folds a lag push, then the connection drops before the
    ACK: the client redials, replays its inits and declarations, and
    re-sends the frame with the same packed round, which the server
    acknowledges without folding it again."""
    s = _Srv(server, workers=2, host_backend=True)
    real = s.srv._handle
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
        if op == 27 and key == 6 and not dropped:
            dropped.append(1)
            return real(_Dropping(conn), op, key, *rest)
        return real(conn, op, key, *rest)

    s.srv._handle = handle
    resends = _REGISTRY[client]().counter("transport/resends")
    before = resends.value
    try:
        w0 = _client(client, [s.addr], conns_per_shard=1)
        w1 = _client(client, [s.addr])
        for w in (w0, w1):
            w.init_key(6, N * 4)
            w.declare_lag(6, K)
        w0.push_lag(6, 0, 1, _grad(0))      # folded, ACK lost, resent
        assert dropped and resends.value - before == 1
        w1.push_lag(6, 1, 1, _grad(1))
        out = np.empty(N, np.float32)
        assert w0.pull_lag(6, 0, 1, out) == padm.LAG_COMPLETE
        np.testing.assert_array_equal(out, _grad(0) + _grad(1))
        w0.close()
        w1.close()
    finally:
        s.close()


def _drop_connections(w) -> None:
    for pool in w._pools:
        chans = []
        while not pool.empty():
            chans.append(pool.get_nowait())
        for ch in chans:
            if ch.sock is not None:
                ch.sock.shutdown(socket.SHUT_RDWR)
            pool.put(ch)


@pairs
def test_declarations_are_replayed_to_a_restarted_server(client, server):
    """A worker's server is replaced by a fresh one (an empty key table
    and no lag store): the worker's next lag push redials, replays its
    inits and then its declarations, so the push lands in a store that
    knows the key's bound, and the round completes there."""
    old = _Srv(server, workers=1)
    new = _Srv(server, workers=1)
    try:
        w = _client(client, [old.addr])
        w.init_key(8, N * 4)
        w.declare_lag(8, K)
        w.push_lag(8, 0, 1, _grad(0))
        out = np.empty(N, np.float32)
        assert w.pull_lag(8, 0, 1, out) == padm.LAG_COMPLETE
        w._addrs[0] = new.addr.rsplit(":", 1)
        _drop_connections(w)
        w.push_lag(8, 0, 2, _grad(1))
        assert new.store().declared(8) == K
        assert w.pull_lag(8, 0, 2, out) == padm.LAG_COMPLETE
        np.testing.assert_array_equal(out, _grad(1))
        assert new.store().round(8) == 2          # adopted round 1
        w.close()
    finally:
        old.close()
        new.close()


@pairs
def test_lag_frames_need_a_declaration(client, server):
    """A lag push for an undeclared key is refused with an error frame,
    and the connection serves the next request."""
    s = _Srv(server, workers=1)
    try:
        w = _client(client, [s.addr], conns_per_shard=1)
        w.init_key(2, N * 4)
        with pytest.raises(RuntimeError, match="rejected"):
            w.push_lag(2, 0, 1, _grad(0))
        w.declare_lag(2, K)
        w.push_lag(2, 0, 1, _grad(0))
        out = np.empty(N, np.float32)
        assert w.pull_lag(2, 0, 1, out) == padm.LAG_COMPLETE
        with pytest.raises(RuntimeError, match="rejected"):
            w.declare_lag(3, K)             # before its init
        w.close()
    finally:
        s.close()


def test_push_lag_rides_the_gradient_class():
    assert ptransport.OP_PUSH_LAG in \
        ptransport.RemotePSBackend._SCHED_GRAD_OPS
    assert ptransport.OP_PUSH_LAG in ptransport._REUSE_SAFE_OPS


def test_two_threads_pull_one_sealed_round_alike():
    """Two pulls of one sealed round from two connections, on a thread
    each, read the same bytes (published sums are immutable)."""
    s = _Srv("port", workers=2, host_backend=True)
    try:
        w = _client("port", [s.addr])
        w.init_key(1, N * 4)
        w.declare_lag(1, K)
        w.push_lag(1, 0, 1, _grad(0))
        outs = [np.empty(N, np.float32) for _ in range(2)]
        flags = [None, None]

        def pull(i):
            flags[i] = w.pull_lag(1, 0, 1, outs[i])

        ts = [threading.Thread(target=pull, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
            assert not t.is_alive()
        assert flags == [padm.LAG_STALE] * 2
        assert outs[0].tobytes() == outs[1].tobytes() == \
            _grad(0).tobytes()
        w.close()
    finally:
        s.close()
