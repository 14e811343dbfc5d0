"""Sync PS at world 2 over the wire, held against the JAX package on the
CPU: the port's standalone server (``server/transport.py``) beside the JAX
one, the trainer in two worker processes that meet only at a server, and
the BytePS API and plugin at world 2.

  - Exchange parity: two ``RemotePSBackend`` clients in threads, each
    with the port's ``PSGradientExchange``, push the same seeded
    gradients to the port's server and to the JAX server; the pulled sums
    must be the same bits (dense; int8 and fp8 on the fused plane; the
    README's onebit chain on the legacy plane). No tolerance: the same
    bytes go in, and the servers' sums and codecs are bit for bit.
  - Trainer parity: two port worker processes against the port's server,
    two JAX worker processes against the JAX server
    (``tests/_torch_ps_remote_worker.py``), the small BERT of
    ``test_torch_ps_trainer.py`` from the same weights, each worker its
    own seeded batches, 3 steps, dense and int8. The tolerances and their
    reasons are that file's: losses 1e-5 relative, parameters 1e-5
    absolute, and under int8 at most 1 in 1000 parameter elements
    outside. At world 2 the two arrivals' fp32 sum is the same whatever
    their order (a + b == b + a), so both workers of a framework must end
    bit for bit equal.
  - The plugin at world 2: ``tests/_ps_worker.py``'s assertions.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.server.engine import PSServer as JServer
from byteps_tpu.server.transport import PSTransportServer as JTransport
import byteps_tpu_torch as bps
from byteps_tpu_torch import convert
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.server.engine import PSServer
from byteps_tpu_torch.server.ps_mode import PSGradientExchange
from byteps_tpu_torch.server.transport import (PSTransportServer,
                                               RemotePSBackend)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_ps_remote_worker.py"
WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
README = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
          "ef_type": "vanilla", "momentum_type": "nesterov"}
WAIT = 150          # seconds any worker process may take

_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
        "BPS_SERVER_ADDRS", "BPS_COMPRESS", "BPS_PS_PIPELINE",
        "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF", "BPS_APPLY_CHUNKED",
        "BPS_BWD_STAGED", "BPS_CROSS_STEP", "BPS_SCHEDULING_CREDIT")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    tdev.reset_probe()
    yield
    bps.shutdown()
    tdev.reset_probe()


class _Server:
    """A transport server over a 2-worker engine of either framework, in
    this process."""

    def __init__(self, kind: str, workers: int = 2) -> None:
        eng, tr = (PSServer, PSTransportServer) if kind == "port" \
            else (JServer, JTransport)
        self.engine = eng(num_workers=workers, engine_threads=2)
        self.transport = tr(self.engine, host="127.0.0.1", port=0)
        self.addr = f"127.0.0.1:{self.transport.port}"

    def close(self) -> None:
        self.transport.close()
        self.engine.close()


def _grads(wid: int):
    rng = np.random.RandomState(7 + wid)
    return [("a", rng.standard_normal((300, 70)).astype(np.float32)),
            ("b", rng.standard_normal(5000).astype(np.float32)),
            ("c", rng.standard_normal((64, 33)).astype(np.float32))]


def _exchange_on(kind: str, compress, declare) -> list:
    """Both clients declare every key, meet at a barrier, then exchange
    twice: the JAX server's fused front resets a key at each declaration,
    so one landing after the other client's push would wedge the round
    (ROADMAP.md queue 3)."""
    srv = _Server(kind)
    results = [None, None]
    errors = []
    declared = threading.Barrier(2, timeout=30)
    try:
        def go(wid):
            try:
                be = RemotePSBackend([srv.addr])
                ex = PSGradientExchange(be, partition_bytes=16384,
                                        min_compress_bytes=1024,
                                        compress=compress)
                if declare:
                    ex.registry.declare("g", **declare)
                ex.plan_for(_grads(wid), name="g")
                declared.wait()
                outs = []
                for _ in range(2):              # two rounds
                    outs.append(ex.exchange(_grads(wid), name="g"))
                results[wid] = outs
                ex.close()
                be.close()
            except BaseException as e:     # noqa: BLE001 — asserted below
                errors.append(e)

        ts = [threading.Thread(target=go, args=(w,)) for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts), "an exchange hung"
    finally:
        srv.close()
    assert not errors, errors
    return results


@pytest.mark.parametrize("compress,declare", [
    ("none", None), ("int8", None), ("fp8_e4m3", None), ("none", README)],
    ids=["dense", "int8", "fp8", "onebit_chain"])
def test_exchange_sums_equal_the_jax_servers_at_world_two(compress,
                                                         declare):
    port = _exchange_on("port", compress, declare)
    ref = _exchange_on("jax", compress, declare)
    for w in (0, 1):
        for rnd in range(2):
            for a, b in zip(port[w][rnd], ref[w][rnd]):
                assert a.tobytes() == b.tobytes()
    # both workers pulled the same merged rounds
    for rnd in range(2):
        for a, b in zip(port[0][rnd], port[1][rnd]):
            assert a.tobytes() == b.tobytes()
    if compress == "none" and declare is None:
        g0, g1 = _grads(0), _grads(1)
        for (_, x), (_, y), s in zip(g0, g1, port[0][0]):
            assert (s == (x + y)).all()


def _run_workers(mode: str, addrs: str, tmp_path, inputs=None,
                 extra_env=None):
    procs, outs = [], []
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               BPS_MIN_COMPRESS_BYTES="0", BPS_COMPRESS_DEVICE="1",
               BPS_PARTITION_BYTES=str(256 << 10), **(extra_env or {}))
    for wid in (0, 1):
        out = tmp_path / f"{mode}{wid}.out"
        outs.append(out)
        args = [sys.executable, str(WORKER), mode, str(wid), addrs,
                str(out)] + ([str(inputs)] if inputs else [])
        procs.append(subprocess.Popen(args, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, outs


def _reap(procs, what: str):
    logs = []
    try:
        for p in procs:
            try:
                log, _ = p.communicate(timeout=WAIT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                log, _ = p.communicate()
            logs.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for wid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, \
            f"{what} worker {wid} failed:\n{log[-4000:]}"


def test_trainers_at_world_two_match_the_jax_trainers(tmp_path):
    codecs = ("none", "int8")
    servers = {(k, c): _Server(k) for k in ("port", "jax") for c in codecs}
    try:
        jcfg = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
        jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
        weights = tmp_path / "weights.pt"
        torch.save(convert.params_from_jax(jax.tree.map(np.asarray, jp)),
                   weights)
        addrs = {k: ",".join(f"{c}={servers[k, c].addr}" for c in codecs)
                 for k in ("port", "jax")}
        pp, pouts = _run_workers("port", addrs["port"], tmp_path, weights)
        jpr, jouts = _run_workers(
            "jax", addrs["jax"], tmp_path,
            extra_env={"BPS_BWD_STAGED": "0", "BPS_CROSS_STEP": "0"})
        _reap(pp, "port")
        _reap(jpr, "jax")
    finally:
        for s in servers.values():
            s.close()
    port = [torch.load(o, weights_only=False) for o in pouts]
    ref = [torch.load(o, weights_only=False) for o in jouts]
    for codec in codecs:
        leaves = [[np.concatenate([np.asarray(x).ravel() for x in
                                   jax.tree_util.tree_leaves(r[codec][1])])
                   for r in rs] for rs in (port, ref)]
        for w in (0, 1):
            tl, jl = port[w][codec][0], ref[w][codec][0]
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
            assert np.isfinite(tl).all()
            a, b = leaves[0][w], leaves[1][w]
            assert a.shape == b.shape
            off = np.count_nonzero(np.abs(a - b) > 1e-5)
            if codec == "none":
                assert off == 0, off
            else:
                assert off <= a.size // 1000, off
        # the workers of one framework end bit for bit equal
        assert leaves[0][0].tobytes() == leaves[0][1].tobytes()
        assert leaves[1][0].tobytes() == leaves[1][1].tobytes()
        # each worker's own batches: the losses differ between workers
        assert port[0][codec][0] != port[1][codec][0]


def test_plugin_and_api_average_over_the_workers(tmp_path):
    """``tests/_ps_worker.py``'s assertions on the port, against the
    port's ``launch --server`` (port 0, read from its line): a mean of 2.5
    and a sum of 10.0 over two worker processes, handles synchronized in a
    divergent order (no deadlock, no mispairing), then the plugin's
    broadcast and an averaged optimizer step."""
    env = dict(os.environ, BPS_SERVER_PORT="0", BPS_NUM_WORKER="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         "--server"], env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        line = _read_line(proc, 60)
        port = int(line.rsplit("server up on :", 1)[1].split()[0])
        procs, outs = _run_workers("plugin", f"127.0.0.1:{port}", tmp_path)
        _reap(procs, "plugin")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0          # SIGTERM: a clean stop
    res = [np.load(str(o) + ".npz") for o in outs]
    for r in res:
        for pre in ("api", "plugin"):
            np.testing.assert_array_equal(r[f"{pre}_mean"], 2.5)
            np.testing.assert_array_equal(r[f"{pre}_sum"], 10.0)
            np.testing.assert_array_equal(r[f"{pre}_async_a"], 6.0)
            np.testing.assert_array_equal(r[f"{pre}_async_b"], 22.0)
    torch.manual_seed(0)
    root = torch.nn.Linear(8, 4)
    want = torch.cat([p.detach().reshape(-1)
                      for p in root.parameters()]).numpy()
    for r in res:
        assert r["bcast"].tobytes() == want.tobytes()
    # the mean of the two workers' gradients, the same step on both
    x = [torch.full((2, 8), 1.0 + w) for w in (0, 1)]
    grads = []
    for xi in x:
        m = torch.nn.Linear(8, 4)
        m.load_state_dict(root.state_dict())
        m(xi).sum().backward()
        grads.append(torch.cat([p.grad.reshape(-1) for p in m.parameters()]))
    mean = ((grads[0] + grads[1]) / 2).numpy()
    for r in res:
        np.testing.assert_array_equal(r["grads"], mean)
        np.testing.assert_allclose(r["stepped"], want - 0.5 * mean,
                                   rtol=1e-6, atol=1e-7)
    assert res[0]["stepped"].tobytes() == res[1]["stepped"].tobytes()


@pytest.mark.parametrize("route", [{}, {"BPS_CROSS_STEP": "0"},
                                   {"BPS_APPLY_CHUNKED": "0"}],
                         ids=["default", "draining", "monolithic"])
def test_every_tail_divides_the_sum_by_the_workers(route, monkeypatch):
    """Each route divides the pulled sum by ``ps_world`` on the host before
    the apply: ``ps_world`` 2 over the in-process server (a sum of one
    worker) trains bit for bit as world 1 on half the loss (the backward
    is linear in its seed, and halving is exact)."""
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.models import bert as tbert
    from byteps_tpu_torch.training import DistributedTrainer
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    for k, v in route.items():
        monkeypatch.setenv(k, v)

    def run(world, scale):
        bps.init(device="cpu")
        GlobalState.get().engine.ps_world = world
        torch.manual_seed(0)
        model = tbert.Transformer(tbert.bert_tiny())
        tt = DistributedTrainer(
            lambda m, b: tbert.mlm_loss(m, b, max_predictions=4) * scale,
            model, torch.optim.SGD(model.parameters(), lr=0.5), device="cpu")
        for i in range(3):
            tt.step(tbert.synth_mlm_batch(np.random.RandomState(i), 2, 32,
                                          128))
        out = [p.detach().clone() for p in tt.model.parameters()]
        tt.close()
        bps.shutdown()
        return out

    halved, whole = run(2, 1.0), run(1, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(halved, whole))
    assert not all(torch.equal(a, b)
                   for a, b in zip(halved, run(1, 1.0)))


def test_world_two_without_server_addrs_raises(monkeypatch):
    """As the JAX package (``tests/test_transport.py:288``): a private
    in-process backend would wait forever for the other worker."""
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_NUM_WORKER", "2")
    with pytest.raises(ValueError, match="BPS_SERVER_ADDRS"):
        bps.init(device="cpu")


def _read_line(proc, timeout: float) -> str:
    """The server's ``server up on :<port>`` line, within ``timeout``."""
    box = []

    def read():
        for line in proc.stderr:
            if "server up on :" in line:
                box.append(line)
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    assert box, "the server printed no 'server up on' line"
    return box[0]
