"""Op 8 (``OP_PUSH_RS``, the row-sparse push) on both sides of the port's
transport against the JAX package's, in the four pairings {port, JAX}
client x {port, JAX} server: two workers' sparse pushes summed into one
dense round, a push resent after a lost ACK folded once, an index out of
range answered with an error frame on a connection that lives on, and the
client's frame byte for byte the JAX client's.

Tolerance: none (sums of two scatter-adds, the same fp32 adds on both
servers).
"""

import socket
import threading

import numpy as np
import pytest

from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu.server.rowsparse import scatter_dense
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

ROWS, COLS = 40, 16
NBYTES = ROWS * COLS * 4

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
                 "BPS_KEY_LOG", "PS_KEY_LOG", "BPS_REDUCE_ROOTS",
                 "BPS_FUSED_HOMOG"):
        monkeypatch.delenv(name, raising=False)


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
def server2(server):
    s = _Srv(server)
    yield s
    s.close()


def _client(kind, addr, **kw):
    return _TRANSPORT[kind].RemotePSBackend([addr], **kw)


def _push(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, ROWS, n).astype(np.int32),
            rng.randn(n, COLS).astype(np.float32))


@pairs
def test_two_workers_sparse_pushes_sum_into_one_round(client, server,
                                                      server2):
    ws = [_client(client, server2.addr) for _ in range(2)]
    for w in ws:
        w.init_key(11, NBYTES, "float32")
    for rnd in (1, 2):
        pushes = [_push(10 * rnd + w, 9) for w in (0, 1)]
        outs = [np.empty(ROWS * COLS, np.float32) for _ in ws]

        def go(w, p, o):
            w.push_rowsparse(11, p[0], p[1], NBYTES)
            w.pull(11, o, round=rnd, timeout_ms=10000)

        ts = [threading.Thread(target=go, args=a)
              for a in zip(ws, pushes, outs)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts), "a worker hung"
        want = sum(scatter_dense(i, r, ROWS, "float32") for i, r in pushes)
        for o in outs:
            assert o.tobytes() == want.reshape(-1).tobytes()
    assert ws[0].round(11) == 2
    for w in ws:
        w.close()


@pairs
def test_a_push_resent_after_a_lost_ack_folds_once(client, server, server2):
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
        if op == 8 and key == 5 and not dropped:
            dropped.append(1)
            return real(_Dropping(conn), op, key, *rest)
        return real(conn, op, key, *rest)

    server2.srv._handle = handle
    resends = _REGISTRY[client]().counter("transport/resends")
    before = resends.value
    w1 = _client(client, server2.addr, conns_per_shard=1)
    w2 = _client(client, server2.addr)
    w1.init_key(5, NBYTES, "float32")
    w2.init_key(5, NBYTES, "float32")
    a, b = _push(1, 6), _push(2, 4)
    w1.push_rowsparse(5, *a, NBYTES)     # applied, ACK lost, resent, deduped
    assert dropped
    assert resends.value - before == 1
    w2.push_rowsparse(5, *b, NBYTES)
    out = np.empty(ROWS * COLS, np.float32)
    w1.pull(5, out, round=1, timeout_ms=5000)
    want = scatter_dense(*a, ROWS, "float32") + scatter_dense(*b, ROWS,
                                                              "float32")
    assert out.tobytes() == want.reshape(-1).tobytes()     # not 2a + b
    w1.close()
    w2.close()


@pairs
def test_an_index_out_of_range_is_an_error_frame(client, server):
    s = _Srv(server, workers=1)
    try:
        w = _client(client, s.addr, conns_per_shard=1)
        w.init_key(9, NBYTES, "float32")
        with pytest.raises(RuntimeError, match="out of range"):
            w.push_rowsparse(9, np.array([ROWS], np.int32),
                             np.ones((1, COLS), np.float32), NBYTES)
        w.push_rowsparse(9, np.array([0], np.int32),
                         np.ones((1, COLS), np.float32), NBYTES)
        with pytest.raises(RuntimeError, match="cols"):     # pinned cols
            w.push_rowsparse(9, np.array([0], np.int32),
                             np.ones((1, COLS // 2), np.float32), NBYTES)
        # the same (only) connection serves the next request: round 1 is
        # the first good push, round 2 this one
        idx, rows = _push(3, 5)
        w.push_rowsparse(9, idx, rows, NBYTES)
        out = np.empty(ROWS * COLS, np.float32)
        w.pull(9, out, round=2, timeout_ms=5000)
        assert out.tobytes() == scatter_dense(
            idx, rows, ROWS, "float32").reshape(-1).tobytes()
        w.close()
    finally:
        s.close()


def test_the_clients_frame_is_the_jax_clients():
    """The push's request, as each client hands it to its framing (the
    dedup token's incarnation aside), and the framed bytes: the same."""
    idx = np.array([4, 4, 0], np.int64)
    rows = np.arange(3 * COLS, dtype=np.float64).reshape(3, COLS)
    calls = {}
    for kind, mod in (("port", ptransport), ("jax", jtransport)):
        c = object.__new__(mod.RemotePSBackend)
        rec = []
        c._rpc = lambda *a, rec=rec: rec.append(a)
        c._push_token = lambda key: (77 << 32) | 1
        c.push_rowsparse(9, idx, rows, ROWS * COLS * 8)
        (args,), = [rec]
        calls[kind] = args
    assert calls["port"][:6] == calls["jax"][:6]
    assert calls["port"][0] == ptransport.OP_PUSH_RS == jtransport.OP_PUSH_RS
    assert bytes(calls["port"][6]) == bytes(calls["jax"][6])
    frames = []
    for mod, args in ((ptransport, calls["port"]), (jtransport, calls["jax"])):
        a, b = socket.socketpair()
        try:
            mod._send_req(a, args[0], args[1], args[2], args[3], args[4],
                          args[5], args[6])
            a.shutdown(socket.SHUT_WR)
            frames.append(b"".join(iter(lambda: b.recv(1 << 16), b"")))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    assert len(frames[0]) == ptransport._HDR.size + 4 + 3 * 4 + rows.nbytes


def test_the_port_server_counts_its_row_sparse_pushes():
    s = _Srv("port", workers=1)
    ctr = pregistry().counter("server/rowsparse_pushes")
    before = ctr.value
    try:
        w = _client("port", s.addr)
        w.init_key(3, NBYTES, "float32")
        for n in (4, 0):
            idx, rows = _push(n, n)
            w.push_rowsparse(3, idx, rows, NBYTES)
        assert w.round(3) == 2
        w.close()
    finally:
        s.close()
    assert ctr.value - before == 2
