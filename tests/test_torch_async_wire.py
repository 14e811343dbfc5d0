"""Async PS over the TCP transport in the four {port, JAX} client x
{port, JAX} server pairings (oracle ``tests/test_transport.py:331``): an
async server, two workers' weight deltas at fp32 and at bf16 into one fp32
store, pulls at fp32 and bf16, the rounds; every pairing ends on the same
store, the fp32 replay of the deltas in push order, bit for bit. And the
frames: the port's client writes the JAX client's bytes for the same
async calls (init with weights, fp32 and bf16 pushes, fp32 and bf16
pulls at round 0, the round query), the push tokens' incarnation pinned,
on a blocking engine (``BPS_SERVER_ENGINE_BLOCKING=1``), which folds each
push before it answers.
"""

import socket
import time

import ml_dtypes
import numpy as np
import pytest

from byteps_tpu.server import engine as jengine
from byteps_tpu.server import transport as jtransport
from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import transport as ptransport

PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}
N = 1000
WAIT = 20.0


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("BPS_RECONNECT_SECS", "BPS_PS_CONNS", "BPS_STRIPE_MIN",
                 "BPS_ENABLE_SHM", "BPS_ENABLE_IPC", "BYTEPS_ENABLE_IPC",
                 "BPS_PULL_TIMEOUT_MS", "BPS_SCHEDULING_CREDIT"):
        monkeypatch.delenv(name, raising=False)


def _narrow(kind, x):
    return bf16.narrow(x) if kind == "port" else x.astype(ml_dtypes.bfloat16)


def _narrow_out(kind):
    return np.empty(N, bf16.BF16 if kind == "port" else ml_dtypes.bfloat16)


def _quiesce(be, key, pushes):
    deadline = time.monotonic() + WAIT
    while (rnd := be.round(key)) != pushes:
        assert rnd < pushes and time.monotonic() < deadline
        time.sleep(0.002)


def _data():
    rng = np.random.RandomState(11)
    init = rng.randn(N).astype(np.float32)
    deltas = [(rng.randn(N) * 1e-3).astype(np.float32) for _ in range(4)]
    return init, deltas


def _session(client, server):
    """Two workers of one async server: worker 0 pushes fp32 deltas,
    worker 1 bf16 ones, in a scripted order, each pull after the folds."""
    init, deltas = _data()
    be = _ENGINE[server].PSServer(num_workers=2, engine_threads=2,
                                  async_mode=True)
    srv = _TRANSPORT[server].PSTransportServer(be, host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{srv.port}"
    ws = [_TRANSPORT[client].RemotePSBackend([addr], async_mode=True)
          for _ in range(2)]
    seen = []
    try:
        for w in ws:                      # first init wins, the rest no-ops
            w.init_key(21, init.nbytes, "float32", init=init)
        out = np.empty(N, np.float32)
        ws[1].pull(21, out)               # before any push
        seen.append(out.copy())
        for i, d in enumerate(deltas):
            w = ws[i % 2]
            w.push(21, d if i % 2 == 0 else _narrow(client, d))
            _quiesce(w, 21, i + 1)
            w.pull(21, out)
            seen.append(out.copy())
        n16 = _narrow_out(client)
        ws[0].pull(21, n16)
        seen.append(n16.view(np.uint16).copy())
        seen.append(np.array([ws[0].round(21), ws[1].round(21)]))
    finally:
        for w in ws:
            w.close()
        srv.close()
        be.close()
    return seen


def test_async_sessions_agree_in_every_pairing():
    runs = {pair: _session(*pair) for pair in PAIRS}
    ref = runs[("jax", "jax")]
    for pair, seen in runs.items():
        assert len(seen) == len(ref)
        for a, b in zip(seen, ref):
            assert a.tobytes() == b.tobytes(), pair
    init, deltas = _data()
    want = init.copy()
    for i, d in enumerate(deltas):
        want = want + (d if i % 2 == 0 else bf16.widen(bf16.narrow(d)))
        assert ref[1 + i].tobytes() == want.tobytes()
    assert ref[-2].tobytes() == bf16.narrow(want).view(np.uint16).tobytes()
    assert list(ref[-1]) == [len(deltas)] * 2


def _written(send_req, args) -> bytes:
    a, b = socket.socketpair()
    try:
        send_req(a, *args)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while (c := b.recv(1 << 16)):
            chunks.append(c)
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_async_frames_are_the_jax_clients(server, monkeypatch):
    # a blocking engine folds each push before it is answered: no polled
    # round queries, whose number would vary, between the frames
    monkeypatch.setenv("BPS_SERVER_ENGINE_BLOCKING", "1")
    frames = {}
    for client in ("port", "jax"):
        mod = _TRANSPORT[client]
        orig = mod._send_req
        log = frames.setdefault(client, [])

        def rec(sock, *args, orig=orig, log=log):
            if args[0] != mod.OP_CLOSE:
                log.append(_written(orig, args))
            orig(sock, *args)

        monkeypatch.setattr(mod, "_send_req", rec)
        be = _ENGINE[server].PSServer(num_workers=1, engine_threads=1,
                                      async_mode=True)
        srv = _TRANSPORT[server].PSTransportServer(be, host="127.0.0.1",
                                                   port=0)
        w = mod.RemotePSBackend([f"127.0.0.1:{srv.port}"], async_mode=True)
        w._wid = 0x5EED
        try:
            init, deltas = _data()
            w.init_key(4, init.nbytes, "float32", init=init)
            w.push(4, deltas[0])
            w.push(4, _narrow(client, deltas[1]))
            assert w.round(4) == 2
            w.pull(4, np.empty(N, np.float32))
            w.pull(4, _narrow_out(client))
            w.push_pull(4, deltas[2])
        finally:
            w.close()
            srv.close()
            be.close()
    assert len(frames["port"]) == len(frames["jax"]) > 7
    for mine, ref in zip(frames["port"], frames["jax"]):
        assert mine == ref
    # the bf16 push frame names its dtype and carries half the bytes
    push16 = frames["port"][2]
    assert push16[41:49] == b"bfloat16"
    assert len(push16) == ptransport._HDR.size + 2 * N
