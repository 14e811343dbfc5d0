"""The engine-side fused route (``BPS_FUSED_HOMOG=0``; ``wire.decode_for_store``,
``wire.FusedPullCache``, ``wire.pull_encoded``) against the JAX package's:
the counterparts of ``tests/test_homog_sum.py:191-323``.

With the knob at 1 and at 0, the same fused pushes give byte for byte the
same fused and dense pulls, in the port and in the JAX package, for int8,
fp8_e4m3, fp16 and topk, and the decode and homog counters move as the JAX
package's do; a fused push to a key never declared fused decodes into the
engine; a re-init drops the key's cached pulls; a torn payload raises
before a byte lands; ``FusedFront`` over a raw engine behaves the same at
both settings; and BERT-tiny PS int8 at world 2 over TCP, behind ``launch
--server`` at 0 and at 1, ends on the same parameters, with the servers'
stop-time counters of the route each took.

Tolerance: none. Both routes decode each arrival, copy the first and add
the second in fp32, and encode the merged round with ``wire.encode`` under
``sr_seed(key, round)``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import homog as jhomog
from byteps_tpu_torch.compress import wire as pwire
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import homog as phomog
from byteps_tpu_torch.server import transport as ptransport

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_ps_remote_worker.py"
WAIT = 120
N = 2048
CODECS = ("int8", "fp8_e4m3", "fp16", "topk")
COUNTERS = ("server/fused_dense_decodes", "server/fused_rounds_homog",
            "server/fused_rounds_fallback")
PKG = {"port": (pengine, phomog, pregistry), "jax": (jengine, jhomog,
                                                      jregistry)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("BPS_FUSED_HOMOG", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _payloads(codec, rnd):
    rng = np.random.RandomState(rnd)
    g = [(rng.randn(N) * (w + 1)).astype(np.float32) for w in (0, 1)]
    cid = pwire.codec_id(codec)
    return cid, [pwire.encode(cid, x, seed=7 * rnd + w)
                 for w, x in enumerate(g)]


def _deltas(reg, before):
    return {k: reg().counter(k).value - before[k] for k in COUNTERS}


def _snap(reg):
    return {k: reg().counter(k).value for k in COUNTERS}


def _run(pkg, codec, homog, monkeypatch, front=False, rounds=2):
    """Two workers' fused pushes of ``rounds`` rounds through a
    ``HostPSBackend`` (or ``FusedFront`` over a raw ``PSServer``): each
    round's fused pull, dense pull and round, and the counters' moves."""
    monkeypatch.setenv("BPS_FUSED_HOMOG", homog)
    eng, hom, reg = PKG[pkg]
    raw = eng.PSServer(num_workers=2, engine_threads=1) if front else None
    be = (hom.FusedFront(raw, 2) if front else
          eng.HostPSBackend(num_servers=1, num_workers=2, engine_threads=1))
    before = _snap(reg)
    out = []
    try:
        be.init_key(31, N * 4, "float32", fused=True)
        for rnd in range(1, rounds + 1):
            cid, pays = _payloads(codec, rnd)
            for p in pays:
                be.push_fused(31, p)
            pay = be.pull_fused(31, N * 4, "float32", cid, round=rnd)
            # a second pull of the round: the cache's (or the store's)
            pay2 = be.pull_fused(31, N * 4, "float32", cid, round=rnd)
            dense = np.empty(N, np.float32)
            be.pull(31, dense, round=rnd)
            out.append((pay, pay2, dense.tobytes(), int(be.round(31))))
    finally:
        (raw if front else be).close()
    return out, _deltas(reg, before)


@pytest.mark.parametrize("front", [False, True], ids=["backend", "front"])
@pytest.mark.parametrize("codec", CODECS)
def test_both_routes_serve_the_same_bytes_as_the_jax_package(
        codec, front, monkeypatch):
    res = {(pkg, h): _run(pkg, codec, h, monkeypatch, front)
           for pkg in ("port", "jax") for h in ("1", "0")}
    ref = res["jax", "1"][0]
    for (pkg, h), (rounds, moved) in res.items():
        assert rounds == ref, (pkg, h)
        assert moved == res["jax", h][1], (pkg, h)
    for rnd, (pay, pay2, dense, r) in enumerate(ref, 1):
        cid, pays = _payloads(codec, rnd)
        merged = (pwire.decode(pays[0], N, "float32")
                  + pwire.decode(pays[1], N, "float32"))
        assert dense == merged.tobytes() and pay == pay2 and r == rnd
        assert pay == pwire.encode(cid, merged, seed=pwire.sr_seed(31, rnd))
    on, off = res["port", "1"][1], res["port", "0"][1]
    assert off == {"server/fused_dense_decodes": 4,
                   "server/fused_rounds_homog": 0,
                   "server/fused_rounds_fallback": 0}
    if codec == "topk":       # not a widen: the store's dense fallback
        assert on == {"server/fused_dense_decodes": 4,
                      "server/fused_rounds_homog": 0,
                      "server/fused_rounds_fallback": 2}
    else:
        assert on == {"server/fused_dense_decodes": 0,
                      "server/fused_rounds_homog": 2,
                      "server/fused_rounds_fallback": 0}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_fused_push_to_an_undeclared_key_decodes_into_the_engine(pkg):
    eng, _, reg = PKG[pkg]
    cid, (p, _) = _payloads("int8", 1)
    be = eng.HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        be.init_key(35, N * 4, "float32")          # no fused=
        d0 = reg().counter("server/fused_dense_decodes").value
        be.push_fused(35, p)
        assert reg().counter("server/fused_dense_decodes").value == d0 + 1
        out = np.empty(N, np.float32)
        be.pull(35, out, round=1)
        assert out.tobytes() == pwire.decode(p, N, "float32").tobytes()
        # a `none` frame is a view of its bytes, not a counted decode
        be.push_fused(35, pwire.encode(pwire.CODEC_NONE, out))
        assert reg().counter("server/fused_dense_decodes").value == d0 + 1
        be.pull(35, out, round=2)
        assert out.tobytes() == pwire.decode(p, N, "float32").tobytes()
    finally:
        be.close()


def test_a_reinit_drops_the_keys_cached_pulls():
    cid, (p, _) = _payloads("int8", 1)
    be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                               engine_threads=1)
    raw = pengine.PSServer(num_workers=1, engine_threads=1)
    front = phomog.FusedFront(raw, 1)
    try:
        for b, cache in ((be, lambda: be._fused_cache),
                         (front, lambda: front._cache)):
            b.init_key(45, N * 4, "float32")
            b.push_fused(45, p)
            b.pull_fused(45, N * 4, "float32", cid, round=1)
            assert cache().get(45, 1, cid) is not None
            b.init_key(45, N * 4, "float32")       # a new tenancy
            assert cache().get(45, 1, cid) is None
    finally:
        be.close()
        raw.close()


@pytest.mark.parametrize("homog", ["1", "0"])
@pytest.mark.parametrize("front", [False, True], ids=["backend", "front"])
def test_a_torn_payload_raises_before_a_byte_lands(homog, front,
                                                   monkeypatch):
    monkeypatch.setenv("BPS_FUSED_HOMOG", homog)
    cid, pays = _payloads("int8", 1)
    raw = pengine.PSServer(num_workers=2, engine_threads=1)
    be = (phomog.FusedFront(raw, 2) if front else
          pengine.HostPSBackend(num_servers=1, num_workers=2,
                                engine_threads=1))
    try:
        be.init_key(51, N * 4, "float32", fused=True)
        bad_magic = b"\0\0" + pays[0][2:]
        for torn in (pays[0][:-1], bad_magic, pays[0][:10],
                     pwire.encode(cid, np.ones(N + 1, np.float32))):
            with pytest.raises(pwire.CodecError):
                be.push_fused(51, torn)
        assert be.round(51) == 0
        for p in pays:
            be.push_fused(51, p)
        out = np.empty(N, np.float32)
        be.pull(51, out, round=1, timeout_ms=5000)
        assert out.tobytes() == (pwire.decode(pays[0], N, "float32")
                                 + pwire.decode(pays[1], N, "float32")
                                 ).tobytes()
    finally:
        raw.close()
        if not front:
            be.close()


@pytest.mark.parametrize("homog", ["1", "0"])
def test_a_key_with_a_legacy_chain_refuses_fused_payloads(homog,
                                                          monkeypatch):
    """The port's PR 15 rule (ROADMAP.md queue 3) at both settings, in
    process and over the transport's raw engine."""
    monkeypatch.setenv("BPS_FUSED_HOMOG", homog)
    cid, (p, _) = _payloads("int8", 1)
    kw = {"compressor_type": "onebit"}
    be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                               engine_threads=1)
    try:
        be.init_key(61, N * 4, "float32", compression=kw)
        with pytest.raises(KeyError, match="legacy compression chain"):
            be.push_fused(61, p)
        with pytest.raises(KeyError, match="legacy compression chain"):
            be.pull_fused(61, N * 4, "float32", cid, round=1)
    finally:
        be.close()
    raw = pengine.PSServer(num_workers=1, engine_threads=1)
    srv = ptransport.PSTransportServer(raw, host="127.0.0.1", port=0)
    try:
        w = ptransport.RemotePSBackend([f"127.0.0.1:{srv.port}"])
        w.init_key(61, N * 4, "float32", compression=kw)
        with pytest.raises(RuntimeError, match="legacy compression chain"):
            w.push_fused(61, p)
        w.close()
    finally:
        srv.close()
        raw.close()


@pytest.mark.parametrize("homog", ["1", "0"])
def test_a_repeated_declaration_keeps_an_early_arrival(homog, monkeypatch):
    """A worker declares, pushes; the other declares the same key after it:
    at 1 the store keeps the key's rounds (the port's PR 17 rule), at 0 the
    engine keeps a re-declared key's, so the round completes either way."""
    monkeypatch.setenv("BPS_FUSED_HOMOG", homog)
    cid, pays = _payloads("fp8_e4m3", 2)
    raw = pengine.PSServer(num_workers=2, engine_threads=1)
    front = phomog.FusedFront(raw, 2)
    try:
        front.init_key(71, N * 4, "float32", fused=True)
        front.push_fused(71, pays[0])
        front.init_key(71, N * 4, "float32", fused=True)
        front.push_fused(71, pays[1])
        got = front.pull_fused(71, N * 4, "float32", cid, round=1,
                               timeout_ms=5000)
        merged = (pwire.decode(pays[0], N, "float32")
                  + pwire.decode(pays[1], N, "float32"))
        assert got == pwire.encode(cid, merged, seed=pwire.sr_seed(71, 1))
    finally:
        raw.close()


def test_the_knob_is_read_as_the_jax_package_reads_it(monkeypatch):
    for v in ("", "1", "on", "yes", "true", " 1 ", "anything", "0", "off",
              "OFF", "false", "no", " No "):
        monkeypatch.setenv("BPS_FUSED_HOMOG", v)
        assert phomog.homog_enabled() == jhomog.homog_enabled(), v
    monkeypatch.delenv("BPS_FUSED_HOMOG")
    assert phomog.homog_enabled() and jhomog.homog_enabled()


# -- BERT-tiny PS int8 at world 2 behind `launch --server` at 1 and at 0 ------

class _Launched:
    """``python -m byteps_tpu_torch.launcher.launch --server`` on port 0
    with ``env``; keeps every line it writes to stderr."""

    def __init__(self, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
             "--server"], cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, BPS_SERVER_PORT="0", BPS_NUM_WORKER="2",
                     **env))
        self.lines = []
        self.up = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()
        if not self.up.wait(60):
            self.stop()
            raise AssertionError("no 'server up on' line:\n"
                                 + "\n".join(self.lines))
        line = next(x for x in self.lines if "server up on :" in x)
        self.addr = "127.0.0.1:" + line.split("server up on :")[1].split()[0]

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append(line.rstrip())
            if "server up on :" in line:
                self.up.set()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode

    def stats(self):
        got = [json.loads(x.split("server stats ", 1)[1])
               for x in self.lines if "server stats " in x]
        assert len(got) == 1, self.lines
        return got[0]


def _leaf_bytes(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_bytes(tree[k])
    else:
        yield np.asarray(tree).tobytes()


def test_bert_tiny_at_world_two_ends_alike_behind_both_routes(tmp_path):
    from byteps_tpu_torch.models import bert as tbert
    sys.path.insert(0, str(WORKER.parent))
    from _torch_ps_remote_worker import WIDTH
    torch.manual_seed(0)
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH),
                              generator=torch.Generator().manual_seed(0))
    weights = tmp_path / "weights.pt"
    torch.save(model.state_dict(), weights)
    servers = {"int8": _Launched({}),
               "int8@off": _Launched({"BPS_FUSED_HOMOG": "0"})}
    procs = []
    try:
        addrs = ",".join(f"{k}={s.addr}" for k, s in servers.items())
        env = dict(os.environ, OMP_NUM_THREADS="1", BPS_ENABLE_PS="1",
                   BPS_NUM_WORKER="2", BPS_MIN_COMPRESS_BYTES="0",
                   BPS_COMPRESS_DEVICE="1",
                   BPS_PARTITION_BYTES=str(256 << 10))
        env.pop("BPS_FUSED_HOMOG", None)
        outs = [tmp_path / f"w{w}.out" for w in (0, 1)]
        for w in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "port", str(w), addrs,
                 str(outs[w]), str(weights)],
                env=dict(env, BPS_WORKER_ID=str(w)), cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=WAIT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0])
        for w, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and "WORKER_OK" in log, \
                f"worker {w}:\n{log[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        rcs = {k: s.stop() for k, s in servers.items()}
    assert rcs == {"int8": 0, "int8@off": 0}
    res = [torch.load(o, weights_only=False) for o in outs]
    params = {(w, k): b"".join(_leaf_bytes(r[k][1]))
              for w, r in enumerate(res) for k in servers}
    assert len(set(params.values())) == 1        # both workers, both routes
    for k in servers:
        assert res[0][k][0] == res[0]["int8"][0]          # the losses too
        assert res[0][k][0] != res[1][k][0]                # own batches
    nc = res[0]["int8"][2]
    assert nc > 0 and all(r[k][2] == nc for r in res for k in servers)
    steps = 3
    on, off = servers["int8"].stats(), servers["int8@off"].stats()
    assert (on["server/fused_rounds_homog"],
            on["server/fused_dense_decodes"]) == (steps * nc, 0)
    assert (off["server/fused_rounds_homog"],
            off["server/fused_dense_decodes"]) == (0, 2 * steps * nc)
    assert on["server/rowsparse_pushes"] == off["server/rowsparse_pushes"] \
        == 0
