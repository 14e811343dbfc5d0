"""The port's process launcher, its ``--server`` role (the port of
``byteps_tpu/launcher/launch.py:76-165``; reference: ``python3 -c 'import
byteps.server'``, launcher/launch.py).

    python -m byteps_tpu_torch.launcher.launch --server

runs a standalone host reduction server: the native summation engine
(``server/engine.py::PSServer``) behind the TCP transport
(``server/transport.py::PSTransportServer``) on ``BPS_SERVER_PORT``
(default 9090; 0 picks a free port). It reads ``BPS_NUM_WORKER`` (the
workers every round waits for; ``BPS_NUM_PROCESSES`` is the launcher-local
spelling), ``BPS_SERVER_ENGINE_THREAD`` and ``BPS_SERVER_ENABLE_SCHEDULE``,
as the JAX launcher does, and never builds a worker ``Config``. It prints
``server up on :<port>`` to stderr once it accepts, so a caller that asked
for port 0 learns the port, and runs until SIGTERM or SIGINT. When it
stops it prints one line ``server stats <json>``: its ``lag/*`` counters
and gauges (bounded staleness; the stats scrape, op 23, is not ported),
its fused-plane merges (``server/fused_rounds_homog``, the rounds the
homogeneous store merged, and ``server/fused_dense_decodes``, the lossy
fused pushes decoded into the engine: the ``BPS_FUSED_HOMOG=0`` route),
its row-sparse pushes (``server/rowsparse_pushes``, and their payloads'
bytes, ``server/rowsparse_push_bytes``), its data-plane frames by op
(``server/push_frames`` and ``server/pull_frames``, ops 2 and 3;
``server/shm_pushes`` and ``server/shm_pulls``, ops 10 and 11;
``server/part_pushes`` and ``server/part_pulls``, ops 12 and 13), the
connections it accepted by kind (``server/tcp_conns``,
``server/ipc_conns``), the keys its snapshots wrote and it restored
(``server/snapshot_keys``, ``server/restored_keys``) and its peak resident
set (``VmHWM``, or where the kernel has none the largest resident set its
serve loop sampled). The server touches no card. With ``BPS_ENABLE_IPC``
(or ``BYTEPS_ENABLE_IPC``) it also listens on its Unix socket
(``server/transport.py::_ipc_path``).

``BPS_SERVER_SNAPSHOT=<path>`` keeps the store in a snapshot file (the
JAX package's ``.npz``, ``server/transport.py::snapshot_store``): where the
file exists the server restores it into the engine before the transport
accepts (server-side init is first-wins, so a reconnecting worker's
replayed inits keep the restored values) and prints ``restored N PS keys
from <path>``; it writes the file every ``BPS_SERVER_SNAPSHOT_SECS``
(default 60) and once more when it stops. A failed snapshot is printed
and the server keeps serving. Each snapshot prints its keys, bytes and
seconds.

``BPS_ENABLE_ASYNC`` (or ``BYTEPS_ENABLE_ASYNC``, read by the rule of the
worker's ``Config``: 1, true, yes or on) makes it an async server (``PSServer(..., async_mode=True)``, as
``byteps_tpu/launcher/launch.py:91-94`` does): every push of a weight delta
folds into the store at once and a pull never waits.
``BPS_NIC_RATE`` raises at a value other than its default
(``transport.LAUNCHER_REFUSED``). The worker half of the JAX launcher (exec of a training
command, ``--numa``, the SSH fan-out, ``BPS_ENABLE_GDB``) is not ported
(ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import List, Optional

from ..common.config import _env_bool

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port'"


def run_server(env: Optional[dict] = None,
               stop: Optional[threading.Event] = None) -> int:
    """Serve until ``stop`` is set (or SIGTERM / SIGINT on the main
    thread)."""
    env = dict(os.environ if env is None else env)
    from ..server.transport import LAUNCHER_REFUSED, check_refused_env
    check_refused_env(LAUNCHER_REFUSED, env)
    from ..server.engine import PSServer
    from ..server.transport import PSTransportServer, restore_snapshot
    n = int(env.get("BPS_NUM_WORKER", env.get("BPS_NUM_PROCESSES", "1")))
    srv = PSServer(num_workers=n,
                   engine_threads=int(env.get("BPS_SERVER_ENGINE_THREAD",
                                              "4")),
                   enable_schedule=env.get("BPS_SERVER_ENABLE_SCHEDULE",
                                           "") == "1",
                   # read as the worker's Config reads it
                   async_mode=_env_bool("BPS_ENABLE_ASYNC",
                                        "BYTEPS_ENABLE_ASYNC", env=env))
    snap = env.get("BPS_SERVER_SNAPSHOT", "")
    snap_secs = float(env.get("BPS_SERVER_SNAPSHOT_SECS", "60") or 60)
    try:
        meta = {}
        if snap and os.path.exists(snap):
            # before the transport accepts: a worker's init must not pin
            # its own values first
            t = time.perf_counter()
            meta = restore_snapshot(srv, snap)
            _say(f"restored {len(meta)} PS keys from {snap} "
                 f"({os.path.getsize(snap)} bytes in "
                 f"{time.perf_counter() - t:.3f} s)")
        tsrv = PSTransportServer(srv, port=int(env.get("BPS_SERVER_PORT",
                                                       "9090")),
                                 key_meta=meta)
    except BaseException:
        srv.close()
        raise
    stop = stop or threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *a: stop.set())
    _say(f"server up on :{tsrv.port} (workers={n}); SIGTERM to stop")
    peak = 0
    last_snap = time.time()
    try:
        while not stop.wait(min(RSS_SAMPLE_S, snap_secs) if snap
                            else RSS_SAMPLE_S):
            peak = max(peak, _rss_now())
            if snap and time.time() - last_snap >= snap_secs:
                _snapshot(tsrv, snap)
                last_snap = time.time()
    finally:
        if snap:
            _snapshot(tsrv, snap, "final ")
        tsrv.close()
        srv.close()
        print(f"[byteps_tpu_torch.launch] server stats "
              f"{json.dumps(server_stats(max(peak, _rss_now())))}",
              file=sys.stderr, flush=True)
    return 0


def _say(msg: str) -> None:
    print(f"[byteps_tpu_torch.launch] {msg}", file=sys.stderr, flush=True)


def _snapshot(tsrv, path: str, what: str = "") -> None:
    """One snapshot, its keys, bytes and seconds printed; a failure (a
    full disk) is printed and the server keeps serving."""
    t = time.perf_counter()
    try:
        n = tsrv.snapshot(path)
    except Exception as e:   # noqa: BLE001 — the data plane stays up
        _say(f"{what}snapshot failed: {type(e).__name__}: {e}")
        return
    _say(f"{what}snapshot: {n} PS keys, {os.path.getsize(path)} bytes in "
         f"{time.perf_counter() - t:.3f} s -> {path}")


# the serve loop's wake-up, which samples the RSS: a sandboxed kernel may
# walk the whole address space for each read of /proc/self/statm, and at
# 0.05 s that slowed every remote-PS step on the card by 1.2-1.7x
RSS_SAMPLE_S = 1.0


def _rss_now() -> int:
    """This process's resident set in bytes (``/proc/self/statm``); 0
    where it cannot be read."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _own_peak_rss(sampled: int, status: str = "/proc/self/status"):
    """(bytes, source) of this process's peak resident set: ``VmHWM``, the
    high-water mark of its own memory map, where the kernel reports it,
    else the largest resident set the serve loop sampled. Not
    ``ru_maxrss``: Linux carries it across ``exec``, so a server started
    by a large process would report its parent's resident set."""
    try:
        with open(status) as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024, "VmHWM"   # kB
    except OSError:
        pass
    return sampled, f"sampled every {RSS_SAMPLE_S} s"


# the server counters the stop-time line carries beside ``lag/*``
STATS_COUNTERS = ("server/fused_rounds_homog", "server/fused_dense_decodes",
                  "server/rowsparse_pushes", "server/rowsparse_push_bytes",
                  "server/push_frames", "server/pull_frames",
                  "server/shm_pushes", "server/shm_pulls",
                  "server/part_pushes", "server/part_pulls",
                  "server/ipc_conns", "server/tcp_conns",
                  "server/snapshot_keys", "server/restored_keys")


def server_stats(sampled_rss: int = 0) -> dict:
    """This process's ``lag/*`` metrics, ``STATS_COUNTERS`` and its peak
    resident set."""
    from ..obs.metrics import get_registry
    reg = get_registry()
    snap = reg.snapshot()
    out = {k: v for k, v in snap.items() if k.startswith("lag/")}
    for name in STATS_COUNTERS:
        out[name] = reg.counter(name).value
    out["peak_rss_bytes"], out["peak_rss_source"] = \
        _own_peak_rss(sampled_rss)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m byteps_tpu_torch.launcher.launch",
        description="standalone host reduction server of the port")
    parser.add_argument("--server", action="store_true",
                        help="run a standalone host reduction server")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="a worker command (not ported)")
    args = parser.parse_args(argv)
    if not args.server or args.cmd:
        raise NotImplementedError(
            f"the launcher's worker role (exec of a training command, "
            f"--numa, --hosts, BPS_ENABLE_GDB) {_NOT_PORTED}, queue 1, "
            f"item 8); start each worker process yourself with BPS_* set")
    return run_server()


if __name__ == "__main__":
    sys.exit(main())
