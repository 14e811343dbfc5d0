"""Async PS at world 2 on the CPU: two port worker processes
(``tests/_torch_ps_remote_worker.py`` mode "async") and the port's server
(``python -m byteps_tpu_torch.launcher.launch --server`` with
``BPS_ENABLE_ASYNC=1``), BERT at 2 layers, hidden 128, 3 steps, at the
fp32 and the bf16 delta wire.

Two async workers have no defined order of folds, so the order is
scripted by files, not by time: worker 0 pushes its step-1 deltas, then
worker 1 its step 1, then worker 0 its step 2, and so on. Each push is in
the engine's queue when its ACK returns, and one pusher's pushes of a key
fold in the order they were queued, so after both workers stopped the
store must be the replay of both workers' reported deltas in that order,
folded in fp32 onto the initial weights, bit for bit; each key's round is
the pushes folded, steps x workers; a bf16 delta crossed at half the
bytes.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.server.transport import RemotePSBackend

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_ps_remote_worker.py"
WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
STEPS = 3
WAIT = 120


def _server():
    env = dict(os.environ, BPS_SERVER_PORT="0", BPS_NUM_WORKER="2",
               BPS_ENABLE_ASYNC="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.launcher.launch",
         "--server"], env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines, up = [], threading.Event()

    def read():                  # to the end: the pipe never fills
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "server up on :" in line:
                up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    assert up.wait(60), "the server printed no 'server up on' line"
    line = next(x for x in lines if "server up on :" in x)
    port = int(line.split("server up on :", 1)[1].split()[0])
    return proc, reader, f"127.0.0.1:{port}"


def _as_fp32(name, raw):
    if name == "bfloat16":
        return bf16.widen(np.frombuffer(raw, np.uint16))
    assert name == "float32"
    return np.frombuffer(raw, np.float32)


@pytest.mark.parametrize("wire", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_two_async_workers_fold_in_the_scripted_order(tmp_path, wire):
    torch.manual_seed(0)
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH))
    weights = tmp_path / "weights.pt"
    torch.save(model.state_dict(), weights)
    proc, reader, addr = _server()
    procs, outs, logs = [], [], []
    client = None
    try:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for name in ("BPS_COMPRESS", "BPS_SHARDED_UPDATE", "BPS_MAX_LAG",
                     "BPS_ASYNC_WIRE_DTYPE", "BPS_ASYNC_PULL_DTYPE"):
            env.pop(name, None)
        if wire:
            env["BPS_ASYNC_WIRE_DTYPE"] = wire
        for wid in (0, 1):
            out = tmp_path / f"async{wid}.out"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "async", str(wid), addr,
                 str(out), str(weights)], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            try:
                log, _ = p.communicate(timeout=WAIT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                log, _ = p.communicate()
            logs.append(log)
        for wid, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and "WORKER_OK" in log, \
                f"async worker {wid} failed:\n{log[-4000:]}"
        res = [torch.load(o, weights_only=False) for o in outs]
        keys = res[0]["keys"]
        assert res[1]["keys"] == keys
        client = RemotePSBackend([addr], async_mode=True)
        for k, key in enumerate(keys):
            assert client.round(key) == STEPS * 2
            want = res[0]["init"][k].copy()
            assert want.tobytes() == res[1]["init"][k].tobytes()
            for step in range(STEPS):
                for r in res:             # the scripted order
                    name, raw = r["pushed"][step][k]
                    assert name == (wire or "float32")
                    assert len(raw) == want.size * (2 if wire else 4)
                    want = want + _as_fp32(name, raw)
            store = np.empty(want.size, np.float32)
            client.pull(key, store)
            assert store.tobytes() == want.tobytes(), f"key {key:#x}"
        for r in res:
            assert np.isfinite(r["losses"]).all()
        assert res[0]["losses"] != res[1]["losses"]
    finally:
        if client is not None:
            client.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(15)
    assert proc.returncode == 0
