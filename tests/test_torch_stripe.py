"""Connection striping (``BPS_STRIPE_MIN``, ops 12-13) of the port's
transport against the JAX package's (``tests/test_transport_stripe.py``),
in the four pairings {port, JAX} client x {port, JAX} server: the part
plan, striped pushes and pulls, a resent part, concurrent striped async
pulls, and the server's sweep of abandoned stages.

Sums here are of one or two fp32 arrivals, exact, so every comparison is
exact."""

import os
import struct
import tempfile
import threading
import time

import numpy as np
import pytest

from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]
pairs = pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)

_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}

WAIT_S = 60


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_ENABLE_SHM",
                 "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_STRIPE_MIN", str(1 << 20))
    d = tempfile.mkdtemp(dir="/tmp", prefix="bps-")
    os.chmod(d, 0o700)
    monkeypatch.setenv("BPS_IPC_DIR", d)
    yield
    for f in os.listdir(d):
        os.unlink(os.path.join(d, f))
    os.rmdir(d)


class _Srv:
    def __init__(self, kind, workers=2, async_mode=False):
        self.backend = _ENGINE[kind].PSServer(
            num_workers=workers, engine_threads=2, async_mode=async_mode)
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


def _ranges_of(t, stripe_min, conns, nbytes):
    """``t``'s ``_stripe_ranges`` on a client that dials nothing."""
    c = object.__new__(t.RemotePSBackend)
    c._stripe_min, c._nconns = stripe_min, conns
    return c._stripe_ranges(nbytes)


_SIZES = (0, 4, 1000, (512 << 10) - 16, 512 << 10, (512 << 10) + 4,
          1 << 20, (1 << 20) + 4, 3_999_996, 4_096_000, 4_194_304,
          (8 << 20) + 12, 1_000_003 * 4, (1 << 32) - 4, 1 << 32)


@pytest.mark.parametrize("stripe_min,conns", [
    (0, 4), (1, 4), (262144, 4), (524288, 4), (1048576, 4), (1048576, 1),
    (1048576, 2), (1048576, 8), (4194304, 4), (4194305, 4), (1 << 30, 4)])
def test_stripe_ranges_are_the_jax_packages(stripe_min, conns):
    for nbytes in _SIZES:
        mine = _ranges_of(ptransport, stripe_min, conns, nbytes)
        assert mine == _ranges_of(jtransport, stripe_min, conns, nbytes), \
            nbytes
        if mine:
            assert sum(ln for _, ln in mine) == nbytes
            assert all(off % 16 == 0 for off, _ in mine)
    # the card's plan: BERT-large's full bucket in four parts
    if (stripe_min, conns) == (1048576, 4):
        assert _ranges_of(ptransport, stripe_min, conns, 4_096_000) == [
            (i * 1_024_000, 1_024_000) for i in range(4)]


def _frames():
    reg = pregistry()
    return tuple(reg.counter(n).value for n in (
        "server/part_pushes", "server/part_pulls", "server/push_frames",
        "server/pull_frames"))


@pairs
def test_striped_push_and_pull_give_the_dense_result(client, server, srv):
    """Two workers, sizes that do and do not divide into the parts, three
    rounds: every pull is the exact sum; the port's server counts a frame
    a part and none of ops 2 and 3 for the striped keys."""
    ws = [_client(client, srv.addr) for _ in range(2)]
    rs = np.random.RandomState(0)
    sizes = ((8 << 20) // 4, 1_000_003, 1000)
    xs = [[rs.randn(n).astype(np.float32) for n in sizes] for _ in ws]
    for w in ws:
        for k, n in enumerate(sizes):
            w.init_key(k, 4 * n)
    before = _frames()
    outs = [[], []]

    def run(i):
        for rnd in (1, 2, 3):
            got = []
            for k in range(len(sizes)):
                ws[i].push(k, xs[i][k] * rnd)
            for k, n in enumerate(sizes):
                out = np.empty(n, np.float32)
                ws[i].pull(k, out, round=rnd, timeout_ms=30000)
                got.append(out)
            outs[i].append(got)

    ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in ts)
    for i in (0, 1):
        for rnd, got in zip((1, 2, 3), outs[i]):
            for k in range(len(sizes)):
                np.testing.assert_array_equal(
                    got[k], xs[0][k] * rnd + xs[1][k] * rnd)
    if server == "port":
        parts = sum(len(ws[0]._stripe_ranges(4 * n) or ()) for n in sizes)
        whole = sum(not ws[0]._stripe_ranges(4 * n) for n in sizes)
        assert parts == 4 + 4 and whole == 1
        got = [a - b for a, b in zip(_frames(), before)]
        assert got[0] == 2 * 3 * parts and got[2] == 2 * 3 * whole
        assert got[1] >= 2 * 3 * parts and got[3] >= 2 * 3 * whole
    for w in ws:
        w.close()


@pairs
def test_a_resent_part_applies_once(client, server, srv):
    """Every part sent twice under one token (as a retry after lost ACKs
    would): the server stages per (key, token) and applies the op once."""
    w1, w2 = _client(client, srv.addr), _client(client, srv.addr)
    t = _TRANSPORT[client]
    x = np.arange((4 << 20) // 4, dtype=np.float32)
    for w in (w1, w2):
        w.init_key(0, x.nbytes)
    tok = w1._push_token(0)
    view = memoryview(x).cast("B")
    ranges = w1._stripe_ranges(len(view))
    assert ranges and len(ranges) == 4
    n = len(ranges)
    for _ in range(2):
        for pi, (off, ln) in enumerate(ranges):
            w1._rpc(t.OP_PUSH_PART, 0, tok, len(view), 0, "float32",
                    (t._PART.pack(off, ln, pi, n, 0), view[off:off + ln]))
    # one part again after the op applied: its stage is new, never
    # completes, and the token is applied already
    off, ln = ranges[1]
    w1._rpc(t.OP_PUSH_PART, 0, tok, len(view), 0, "float32",
            (t._PART.pack(off, ln, 1, n, 0), view[off:off + ln]))
    w2.push(0, x)
    out = np.empty_like(x)
    w1.pull(0, out, round=1, timeout_ms=30000)
    np.testing.assert_array_equal(out, 2 * x)     # not 3x
    w1.close()
    w2.close()


@pairs
def test_concurrent_striped_async_pulls_never_tear(client, server,
                                                   monkeypatch):
    """With a pusher bumping a uniform async store, two striped pullers
    each see a uniform tensor on every pull: each op's parts come from one
    fetch, its own (``tests/test_transport_stripe.py:121``)."""
    monkeypatch.setenv("BPS_STRIPE_MIN", "262144")
    s = _Srv(server, workers=1, async_mode=True)
    clis = [_client(client, s.addr, async_mode=True) for _ in range(2)]
    try:
        n = (2 << 20) // 4
        clis[0].init_key(0, n * 4, init=np.zeros(n, np.float32))
        stop = threading.Event()
        errs = []

        def pusher():
            one = np.ones(n, np.float32)
            while not stop.is_set():
                clis[0].push(0, one)

        def puller(cli):
            out = np.empty(n, np.float32)
            try:
                for _ in range(20):
                    cli.pull(0, out, round=0, timeout_ms=30000)
                    assert cli._stripe_ranges(out.nbytes)
                    if out.min() != out.max():
                        errs.append(f"torn: {out.min()} .. {out.max()}")
                        return
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(repr(e))

        ts = [threading.Thread(target=puller, args=(c,)) for c in clis]
        pt = threading.Thread(target=pusher)
        pt.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        stop.set()
        pt.join(WAIT_S)
        assert not any(t.is_alive() for t in ts + [pt])
        assert not errs, errs
    finally:
        for c in clis:
            c.close()
        s.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_the_sweep_drops_an_abandoned_stage_and_never_a_fetch(server):
    """A push stage whose op never completes goes after the TTL; a pull
    stage whose round-blocked fetch is still in flight stays past it, and
    its part is served once the round completes."""
    s = _Srv(server, workers=1)
    t = _TRANSPORT[server]
    try:
        w = ptransport.RemotePSBackend([s.addr])
        x = np.ones((2 << 20) // 4, np.float32)
        for k in (1, 2, 3):
            w.init_key(k, x.nbytes)
        view = memoryview(x).cast("B")
        ranges = w._stripe_ranges(len(view))
        n = len(ranges)
        off, ln = ranges[0]
        # key 1: one part of a push, then nothing
        w._rpc(t.OP_PUSH_PART, 1, w._push_token(1), len(view), 0,
               "float32", (t._PART.pack(off, ln, 0, n, 0),
                           view[off:off + ln]))
        assert list(s.srv._push_stage) == [(1, (w._wid << 32) | 1)]
        # key 2: a pull part of round 1, which nobody pushed yet
        got = {}

        def pull_part():
            got["data"] = w._rpc(t.OP_PULL_PART, 2, 1, len(view), 20000,
                                 "float32", (t._PART.pack(off, ln, 0, n,
                                                          7),))

        th = threading.Thread(target=pull_part)
        th.start()
        deadline = time.time() + 10
        while not s.srv._pull_stage and time.time() < deadline:
            time.sleep(0.01)
        assert list(s.srv._pull_stage) == [(2, 1, 7)]
        s.srv._STRIPE_TTL_SECS = 0.2
        s.srv._stripe_sweep_at = 0.0
        time.sleep(0.3)
        # any part frame sweeps: key 3's whole striped push
        w.push(3, x)
        assert not s.srv._push_stage
        assert list(s.srv._pull_stage) == [(2, 1, 7)]
        w.push(2, x)                     # round 1 completes: the fetch
        th.join(WAIT_S)
        assert not th.is_alive()
        assert got["data"] == bytes(view[off:off + ln])
        # one of n parts served: the stage waits for the rest
        assert list(s.srv._pull_stage) == [(2, 1, 7)]
        s.srv._stripe_sweep_at = 0.0
        time.sleep(0.3)
        w.push(3, x)
        assert not s.srv._pull_stage      # resolved and idle: swept
        w.close()
    finally:
        s.close()


def test_a_part_prefix_rides_in_front_of_its_slice_without_a_copy():
    """``_send_req`` takes the prefix and the data slice as two buffers:
    the frame is the JAX package's byte for byte."""
    import socket
    x = np.arange(1024, dtype=np.float32)
    view = memoryview(x).cast("B")
    args = (ptransport.OP_PUSH_PART, 5, (9 << 32) | 2, len(view), 0,
            "float32", (ptransport._PART.pack(1024, 2048, 1, 2, 0),
                        view[1024:3072]))
    frames = []
    for send in (ptransport._send_req, jtransport._send_req):
        a, b = socket.socketpair()
        send(a, *args)
        a.close()
        frames.append(b"".join(iter(lambda: b.recv(1 << 16), b"")))
        b.close()
    assert frames[0] == frames[1]
    hdr = ptransport._HDR.size
    assert struct.unpack("!IIHHQ", frames[0][hdr:hdr + 20]) == (
        1024, 2048, 1, 2, 0)
    assert frames[0][hdr + 20:] == bytes(view[1024:3072])
