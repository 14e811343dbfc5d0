"""Bounded staleness at world 2 on the CPU: two port worker processes
(``tests/_torch_ps_remote_worker.py`` mode "lag") and the port's server
(``python -m byteps_tpu_torch.launcher.launch --server``,
``BPS_NUM_WORKER=2``, ``BPS_LAG_GRACE_MS=0``), BERT at 2 layers, hidden
128, on the default PS route at ``BPS_MAX_LAG=2``, 3 steps.

The straggler is scripted by files, not by time: worker 1 holds its step-2
pushes until worker 0 has pulled its whole round 2, so the server seals
round 2 without worker 1 and folds worker 1's round 2 into round 3. Both
workers end on the same parameters bit for bit (published sums are
immutable snapshots), worker 0 counted stale verdicts, and the server's
``lag/stale_serves`` and ``lag/late_folds`` (the line it prints when it
stops) are each at least 1. The peak resident set on that line is the
server's own, not the high-water mark of the process that started it.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from byteps_tpu_torch.models import bert as tbert

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_ps_remote_worker.py"
WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
WAIT = 120


def _server():
    env = dict(os.environ, BPS_SERVER_PORT="0", BPS_NUM_WORKER="2",
               BPS_LAG_GRACE_MS="0")
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
    return proc, lines, reader, f"127.0.0.1:{port}"


def _rss(field: str) -> int:
    with open("/proc/self/status") as f:
        line = next(x for x in f if x.startswith(field + ":"))
    return int(line.split()[1]) * 1024


def test_two_workers_and_a_scripted_straggler(tmp_path):
    torch.manual_seed(0)
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH))
    weights = tmp_path / "weights.pt"
    torch.save(model.state_dict(), weights)
    # a large resident set in the process that starts the server: the
    # server's own peak must not report it (ru_maxrss carries over exec)
    ballast = np.ones(96 << 20, np.float32)
    parent_rss = _rss("VmRSS")
    proc, lines, reader, addr = _server()
    del ballast
    procs, outs = [], []
    try:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   BPS_PARTITION_BYTES=str(256 << 10))
        for name in ("BPS_COMPRESS", "BPS_SHARDED_UPDATE", "BPS_CROSS_STEP",
                     "BPS_APPLY_CHUNKED", "BPS_BWD_STAGED"):
            env.pop(name, None)
        for wid in (0, 1):
            out = tmp_path / f"lag{wid}.out"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "lag", str(wid), addr,
                 str(out), str(weights)], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
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
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(15)
    for wid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, \
            f"lag worker {wid} failed:\n{log[-4000:]}"
    assert proc.returncode == 0
    stats = [json.loads(x.split("server stats ", 1)[1]) for x in lines
             if "server stats " in x]
    assert len(stats) == 1, lines[-10:]
    stats = stats[0]
    res = [torch.load(o, weights_only=False) for o in outs]
    nkeys = res[0]["nkeys"]
    assert nkeys > 1
    # round 2 of every key sealed without worker 1; its pushes late-fold
    assert stats["lag/stale_serves"] >= nkeys
    assert stats["lag/late_folds"] >= nkeys
    assert stats["lag/max_streak"] <= 1
    assert 0 < stats["peak_rss_bytes"] < parent_rss - (256 << 20)
    assert res[0]["params"] == res[1]["params"]
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert r["verdicts"]["stale"] >= nkeys
    assert res[0]["losses"] != res[1]["losses"]


def test_the_servers_peak_rss_without_vmhwm(tmp_path):
    """Where the kernel reports no ``VmHWM`` (a sandboxed kernel may not),
    the server reports the largest resident set its serve loop sampled;
    where it does, the exact high-water mark."""
    from byteps_tpu_torch.launcher import launch
    status = tmp_path / "status"
    status.write_text("Name:\tpython\nVmRSS:\t  1000 kB\n")
    assert launch._own_peak_rss(12345, str(status)) == \
        (12345, f"sampled every {launch.RSS_SAMPLE_S} s")
    status.write_text("VmPeak:\t 9000 kB\nVmHWM:\t  2048 kB\n")
    assert launch._own_peak_rss(12345, str(status)) == (2048 * 1024, "VmHWM")
    assert launch._rss_now() > 0
    stats = launch.server_stats(launch._rss_now())
    assert stats["peak_rss_bytes"] > 0 and "lag/stale_serves" in stats


def _writer(report, delay_s, rc):
    """A stand-in worker: after ``delay_s`` it writes ``report`` (unless
    None) and exits ``rc``."""
    code = ("import sys, time; time.sleep(float(sys.argv[1])); "
            "sys.argv[2] and open(sys.argv[2], 'w').write('{}'); "
            "sys.exit(int(sys.argv[3]))")
    return subprocess.Popen([sys.executable, "-c", code, str(delay_s),
                             str(report or ""), str(rc)])


@pytest.mark.parametrize("case", ["first_exits_early", "no_report",
                                  "timeout"])
def test_the_phase_waits_for_both_reports(tmp_path, case):
    """``chip_smoke._await_reports``, the wait of each arm of
    ``bert_large_ps_lag``: after the last arm a worker exits as soon as
    its own report is written, which may be before its peer's, and that
    is no failure; a worker that exits without its report is one, and so
    is the deadline."""
    import time

    import chip_smoke
    reports = [tmp_path / "w0.json", tmp_path / "w1.json"]
    if case == "first_exits_early":
        procs = [_writer(reports[0], 0, 0), _writer(reports[1], 1.5, 0)]
        want = None
    elif case == "no_report":
        procs = [_writer(None, 0, 3), _writer(reports[1], 30, 0)]
        want = "worker 0 exited 3 without its report"
    else:
        procs = [_writer(reports[0], 0, 0), _writer(None, 30, 0)]
        want = "a worker timed out"
    try:
        if case == "first_exits_early":
            procs[0].wait(WAIT)         # gone before its peer's report
            assert not reports[1].exists()
        deadline = time.time() + (2 if case == "timeout" else WAIT)
        assert chip_smoke._await_reports(procs, reports, deadline) == want
    finally:
        for p in procs:
            p.kill()
            p.wait(WAIT)
