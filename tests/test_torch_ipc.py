"""The Unix-socket listener and the client's upgrade to it
(``BPS_ENABLE_IPC`` / ``BYTEPS_ENABLE_IPC``, explicit ``unix:`` addresses)
of the port's transport against the JAX package's, in the four pairings
{port, JAX} client x {port, JAX} server, under a short ``BPS_IPC_DIR`` (a
socket path holds at most 107 bytes)."""

import os
import socket
import tempfile

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


@pytest.fixture(autouse=True)
def ipc_dir(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_SHM", "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT"):
        monkeypatch.delenv(name, raising=False)
    d = tempfile.mkdtemp(dir="/tmp", prefix="bps-")
    os.chmod(d, 0o700)
    monkeypatch.setenv("BPS_IPC_DIR", d)
    yield d
    for f in os.listdir(d):
        os.unlink(os.path.join(d, f))
    os.rmdir(d)


class _Srv:
    def __init__(self, kind, workers=1):
        self.backend = _ENGINE[kind].PSServer(num_workers=workers,
                                              engine_threads=1)
        self.srv = _TRANSPORT[kind].PSTransportServer(
            self.backend, host="127.0.0.1", port=0)
        self.addr = f"127.0.0.1:{self.srv.port}"

    def close(self):
        self.srv.close()
        self.backend.close()


def _families(w):
    """The address family of every dialed channel of ``w``'s first pool."""
    chans = [w._pools[0].get() for _ in range(w._nconns)]
    try:
        return {ch.sock.family for ch in chans if ch.sock is not None}
    finally:
        for ch in chans:
            w._pools[0].put(ch)


def _round_trip(w, key=9):
    x = np.arange(4096, dtype=np.float32)
    w.init_key(key, x.nbytes)
    np.testing.assert_array_equal(w.push_pull(key, x), x)


def _conns():
    reg = pregistry()
    return (reg.counter("server/ipc_conns").value,
            reg.counter("server/tcp_conns").value)


@pairs
def test_an_explicit_unix_address_works(client, server, monkeypatch):
    """``unix:/path.sock`` dials the Unix socket with either client, the
    knob off on the client."""
    monkeypatch.setenv("BPS_ENABLE_IPC", "1")
    s = _Srv(server)
    monkeypatch.delenv("BPS_ENABLE_IPC")
    try:
        assert s.srv.ipc_path and os.path.exists(s.srv.ipc_path)
        assert len(s.srv.ipc_path) < 108
        before = _conns()
        w = _TRANSPORT[client].RemotePSBackend([f"unix:{s.srv.ipc_path}"])
        _round_trip(w)
        assert _families(w) == {socket.AF_UNIX}
        if server == "port":
            got = [a - b for a, b in zip(_conns(), before)]
            assert got[0] >= 1 and got[1] == 0
        w.close()
    finally:
        s.close()


@pairs
@pytest.mark.parametrize("spelling", ["BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC"])
def test_loopback_upgrades_to_the_unix_socket(client, server, spelling,
                                              monkeypatch):
    monkeypatch.setenv(spelling, "1")
    s = _Srv(server)
    try:
        dials = pregistry().counter("transport/ipc_dials")
        before, conns = dials.value, _conns()
        w = _TRANSPORT[client].RemotePSBackend([s.addr])
        _round_trip(w)
        assert _families(w) == {socket.AF_UNIX}
        if client == "port":
            assert dials.value - before >= 1
        if server == "port":
            got = [a - b for a, b in zip(_conns(), conns)]
            assert got[0] >= 1 and got[1] == 0
        w.close()
    finally:
        s.close()


@pairs
@pytest.mark.parametrize("off", ["client", "server", "both"])
def test_the_connection_stays_tcp_with_the_knob_off(client, server, off,
                                                    monkeypatch):
    """Off on the server: no listener, and a client with the knob on finds
    no file and dials TCP. Off on the client: TCP to a server that
    listens on both."""
    monkeypatch.setenv("BPS_ENABLE_IPC", "1" if off == "client" else "0")
    s = _Srv(server)
    monkeypatch.setenv("BPS_ENABLE_IPC", "1" if off == "server" else "0")
    try:
        assert (s.srv.ipc_path is None) == (off != "client")
        w = _TRANSPORT[client].RemotePSBackend([s.addr])
        _round_trip(w)
        assert _families(w) == {socket.AF_INET}
        w.close()
    finally:
        s.close()


@pytest.mark.parametrize("kind", ["port", "jax"])
@pytest.mark.parametrize("fault", ["mode", "owner"])
def test_a_directory_of_the_wrong_mode_or_owner_is_refused(kind, fault,
                                                           ipc_dir,
                                                           monkeypatch):
    t = _TRANSPORT[kind]
    if fault == "mode":
        os.chmod(ipc_dir, 0o755)
    else:
        uid = os.getuid()
        monkeypatch.setattr(os, "getuid", lambda: uid + 1)
    with pytest.raises(RuntimeError, match="must be owned by uid"):
        t._ipc_path(1234)
    monkeypatch.setenv("BPS_ENABLE_IPC", "1")
    eng = _ENGINE[kind].PSServer(num_workers=1, engine_threads=1)
    try:
        with pytest.raises(RuntimeError, match="mode 0700"):
            t.PSTransportServer(eng, host="127.0.0.1", port=0)
    finally:
        eng.close()
        os.chmod(ipc_dir, 0o700)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_close_unlinks_the_socket_file_and_a_stale_one_is_replaced(
        kind, ipc_dir, monkeypatch):
    """A file left by a dead server on the same port is replaced at
    start, and ``close()`` removes the server's own."""
    monkeypatch.setenv("BPS_ENABLE_IPC", "1")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    stale = os.path.join(ipc_dir, f"bps-ipc-{port}.sock")
    with open(stale, "w") as f:
        f.write("stale")
    eng = _ENGINE[kind].PSServer(num_workers=1, engine_threads=1)
    srv = _TRANSPORT[kind].PSTransportServer(eng, host="127.0.0.1",
                                             port=port)
    try:
        assert srv.ipc_path == stale
        w = ptransport.RemotePSBackend([f"127.0.0.1:{port}"])
        _round_trip(w)
        assert _families(w) == {socket.AF_UNIX}
        w.close()
    finally:
        srv.close()
        eng.close()
    assert not os.path.exists(stale)
