"""Server snapshots (``BPS_SERVER_SNAPSHOT``): the port's
``snapshot_store`` / ``restore_snapshot`` against the JAX package's (each
restores the other's file, fp32 and bf16 keys), a sync key without a
round, embedding-store entries, and ``launch --server``: it restores
before it accepts, snapshots every ``BPS_SERVER_SNAPSHOT_SECS`` and at
SIGTERM, and an async server restarted from its snapshot serves a
reconnecting worker the store it had."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

REPO = Path(__file__).resolve().parent.parent
_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}
WAIT_S = 60


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_SHM", "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SERVER_SNAPSHOT",
                 "BPS_SERVER_SNAPSHOT_SECS", "BPS_ENABLE_ASYNC"):
        monkeypatch.delenv(name, raising=False)


def _values():
    """key -> (dtype, the bytes of its value)."""
    rs = np.random.RandomState(3)
    f32 = rs.randn(5000).astype(np.float32)
    b16 = rs.randn(3000).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {7: ("float32", f32.tobytes()), (1 << 16) | 2:
            ("bfloat16", b16.tobytes()), 9: ("float32", b"\0" * 64)}


def _array(kind, dtype, raw):
    if dtype == "bfloat16":
        return (np.frombuffer(raw, ml_dtypes.bfloat16) if kind == "jax"
                else bf16.frombuffer(raw, "bfloat16"))
    return np.frombuffer(raw, np.float32)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port"),
                                           ("jax", "jax")])
def test_each_package_restores_the_others_snapshot(writer, reader,
                                                   tmp_path):
    vals = _values()
    src = _ENGINE[writer].PSServer(num_workers=1, engine_threads=1,
                                   async_mode=True)
    meta = {}
    for key, (dtype, raw) in vals.items():
        arr = _array(writer, dtype, raw)
        src.init_key(key, arr.nbytes, dtype, init=arr)
        meta[key] = (arr.nbytes, dtype)
    path = str(tmp_path / "ps.npz")
    n = _TRANSPORT[writer].snapshot_store(src, list(meta.items()), path)
    src.close()
    assert n == len(vals) and os.path.exists(path)
    assert not os.path.exists(path + ".tmp.npz")
    with np.load(path) as f:
        assert sorted(f.files) == sorted(f"k{k}|{d}"
                                         for k, (d, _) in vals.items())
        for k, (d, raw) in vals.items():
            assert f[f"k{k}|{d}"].dtype == np.uint8
            assert f[f"k{k}|{d}"].tobytes() == raw
    dst = _ENGINE[reader].PSServer(num_workers=1, engine_threads=1,
                                   async_mode=True)
    try:
        got = _TRANSPORT[reader].restore_snapshot(dst, path)
        assert got == meta
        for key, (dtype, raw) in vals.items():
            out = np.empty_like(_array(reader, dtype, raw))
            dst.pull(key, out, round=0, timeout_ms=1000)
            assert out.tobytes() == raw
    finally:
        dst.close()


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_a_sync_key_without_a_round_is_skipped(kind, tmp_path):
    """A sync key pulled at round 0 waits for its first round: the
    snapshot skips it after its short timeout, with a warning, and keeps
    the key that has one."""
    eng = _ENGINE[kind].PSServer(num_workers=1, engine_threads=1)
    srv = _TRANSPORT[kind].PSTransportServer(eng, host="127.0.0.1", port=0)
    try:
        w = ptransport.RemotePSBackend([f"127.0.0.1:{srv.port}"])
        x = np.arange(256, dtype=np.float32)
        w.init_key(1, x.nbytes)
        w.init_key(2, x.nbytes)
        w.push_pull(1, x)
        before = pregistry().counter("server/snapshot_keys").value
        path = str(tmp_path / "s.npz")
        t = time.time()
        assert srv.snapshot(path, timeout_ms=200) == 1
        assert time.time() - t < 10
        with np.load(path) as f:
            assert f.files == ["k1|float32"]
            assert f["k1|float32"].tobytes() == x.tobytes()
        if kind == "port":
            assert pregistry().counter("server/snapshot_keys").value \
                - before == 1
        w.close()
    finally:
        srv.close()
        eng.close()


def test_embedding_entries_raise_and_nothing_is_restored(tmp_path):
    path = str(tmp_path / "e.npz")
    np.savez(path, **{"k3|float32": np.zeros(16, np.uint8),
                      "e5|meta": np.frombuffer(b"{}", np.uint8)})
    eng = pengine.PSServer(num_workers=1, engine_threads=1, async_mode=True)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"embedding store.*not ported.*item 8"):
            ptransport.restore_snapshot(eng, path)
        assert eng.round(3) == 0
        out = np.empty(4, np.float32)
        with pytest.raises(RuntimeError):
            eng.pull(3, out, timeout_ms=100)     # never initialised
    finally:
        eng.close()


class _Launch:
    """``launch --server`` in a process of its own, its stderr kept."""

    def __init__(self, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
             "--server"], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        self.lines = []

        def read():
            for line in self.proc.stderr:
                self.lines.append(line.rstrip())
        threading.Thread(target=read, daemon=True).start()
        self.port = int(self.wait(r"server up on :(\d+)").group(1))

    def wait(self, pattern, after=0):
        deadline = time.time() + WAIT_S
        while time.time() < deadline:
            for line in self.lines[after:]:
                m = re.search(pattern, line)
                if m:
                    return m
            if self.proc.poll() is not None:
                time.sleep(0.2)
                for line in self.lines[after:]:
                    m = re.search(pattern, line)
                    if m:
                        return m
                break
            time.sleep(0.02)
        self.stop()
        raise AssertionError(f"no {pattern!r} in:\n" + "\n".join(self.lines))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=WAIT_S)


def _launch_env(path, secs="1", port="0"):
    return dict(os.environ, BPS_SERVER_PORT=port, BPS_NUM_WORKER="1",
                BPS_ENABLE_ASYNC="1", BPS_SERVER_SNAPSHOT=path,
                BPS_SERVER_SNAPSHOT_SECS=secs, JAX_PLATFORMS="cpu")


def _stored(path):
    with np.load(path) as f:
        return {n: f[n].tobytes() for n in f.files}


def _folded(w, key, want):
    """Pull ``key`` from an async server until it reads ``want`` (the
    engine folds a push on its own thread)."""
    out = np.empty_like(want)
    deadline = time.time() + WAIT_S
    while True:
        w.pull(key, out)
        if out.tobytes() == want.tobytes() or time.time() > deadline:
            return out.tobytes()
        time.sleep(0.01)


def test_the_launcher_restores_before_it_accepts_and_snapshots(tmp_path):
    """A JAX snapshot restored before ``server up``: a worker's init with
    other values keeps the restored ones (first-wins); the store reaches
    the file within the period and again at SIGTERM; the stop line counts
    both."""
    path = str(tmp_path / "ps.npz")
    x0 = np.linspace(-1, 1, 2048).astype(np.float32)
    src = jengine.PSServer(num_workers=1, engine_threads=1, async_mode=True)
    src.init_key(4, x0.nbytes, "float32", init=x0)
    jtransport.snapshot_store(src, [(4, (x0.nbytes, "float32"))], path)
    src.close()
    srv = _Launch(_launch_env(path))
    try:
        restored = srv.wait(r"restored (\d+) PS keys from (\S+)")
        assert restored.group(1) == "1" and restored.group(2) == path
        assert srv.lines.index(restored.string) < next(
            i for i, x in enumerate(srv.lines) if "server up on" in x)
        w = ptransport.RemotePSBackend([f"127.0.0.1:{srv.port}"],
                                       async_mode=True)
        w.init_key(4, x0.nbytes, init=np.zeros_like(x0))
        out = np.empty_like(x0)
        w.pull(4, out)
        assert out.tobytes() == x0.tobytes()
        d = np.full_like(x0, 0.5)
        w.push(4, d)
        # a snapshot a second: one of them holds the push
        want = {"k4|float32": (x0 + d).tobytes()}
        deadline = time.time() + WAIT_S
        while _stored(path) != want and time.time() < deadline:
            time.sleep(0.1)
        assert _stored(path) == want
        assert srv.wait(r"\] snapshot: 1 PS keys, \d+ bytes in")
        w.push(4, d)
        _folded(w, 4, x0 + d + d)
        w.close()
        assert srv.stop() == 0
        srv.wait(r"final snapshot: 1 PS keys")
        assert _stored(path) == {"k4|float32": (x0 + d + d).tobytes()}
        stats = json.loads(srv.wait(r"server stats (\{.*\})").group(1))
        assert stats["server/restored_keys"] == 1
        assert stats["server/snapshot_keys"] >= 2
    finally:
        srv.stop()


def test_a_failed_snapshot_is_printed_and_the_server_keeps_serving(
        tmp_path):
    path = str(tmp_path / "missing-dir" / "ps.npz")
    srv = _Launch(_launch_env(path))
    try:
        w = ptransport.RemotePSBackend([f"127.0.0.1:{srv.port}"],
                                       async_mode=True)
        x = np.ones(64, np.float32)
        w.init_key(1, x.nbytes, init=x)
        srv.wait(r"snapshot failed: FileNotFoundError")
        w.push(1, x)
        assert _folded(w, 1, 2 * x) == (2 * x).tobytes()
        w.close()
        assert srv.stop() == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_an_async_server_restarts_from_its_snapshot_under_a_worker(
        client, tmp_path):
    """The worker pushes, the server stops (its final snapshot), a fresh
    one starts on the same port from the file; the worker's next op
    reconnects and replays its inits, which keep the restored values, and
    the store goes on from where it was."""
    path = str(tmp_path / "ps.npz")
    t = _TRANSPORT[client]
    srv = _Launch(_launch_env(path, secs="60"))
    port = srv.port
    w = t.RemotePSBackend([f"127.0.0.1:{port}"], async_mode=True)
    try:
        rs = np.random.RandomState(0)
        keys = {k: rs.randn(1000 * (k + 1)).astype(np.float32)
                for k in range(3)}
        for k, x in keys.items():
            w.init_key(k, x.nbytes, init=x)
        d = {k: rs.randn(x.size).astype(np.float32) for k, x in keys.items()}
        for k in keys:
            w.push(k, d[k])
        before = {k: _folded(w, k, x + d[k]) for k, x in keys.items()}
        for k, x in keys.items():
            assert before[k] == (x + d[k]).tobytes()
        assert srv.stop() == 0
        srv.wait(r"final snapshot: 3 PS keys")
        srv = _Launch(_launch_env(path, secs="60", port=str(port)))
        assert srv.port == port
        srv.wait(r"restored 3 PS keys from")
        reconnects = (pregistry() if client == "port" else
                      jregistry()).counter("transport/reconnects")
        r0 = reconnects.value
        for k, x in keys.items():
            out = np.empty_like(x)
            w.pull(k, out)
            assert out.tobytes() == before[k]
        assert reconnects.value - r0 >= 1
        for k in keys:
            w.push(k, d[k])
        for k, x in keys.items():
            want = np.frombuffer(before[k], np.float32) + d[k]
            assert _folded(w, k, want) == want.tobytes()
    finally:
        w.close()
        srv.stop()
