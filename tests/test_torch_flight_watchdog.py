"""The port's flight recorder (``obs/flight.py``) and stall watchdog
(``obs/watchdog.py``, and the exchange's side of it in
``server/ps_mode.py``), held against the JAX package's on the same event
sequences and exchange states; the watchdog cases mirror the JAX package's
``tests/test_obs.py``.

Tolerance: none on what is compared (events, rendered dumps, implicated
keys). Times are the watchdog's own: it must fire within its stall period
plus generous slack for a loaded machine, and every wait is bounded.
"""

import re
import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.obs import flight as jflight
from byteps_tpu.obs import watchdog as jwatchdog
from byteps_tpu_torch.obs import flight
from byteps_tpu_torch.obs import metrics as tmetrics
from byteps_tpu_torch.obs.watchdog import (StallWatchdog, format_dump,
                                           implicated_keys)
from byteps_tpu_torch.server.ps_mode import PSGradientExchange


def _events(rec):
    rec.record("push", key=7, round=3, nbytes=4096)
    rec.record("admit", key=9)
    rec.record("codec", stage="g.0", detail="level 0->1")
    rec.record("pull", key=7, round=3, outcome="error:TimeoutError")
    rec.record("push", key=9, round=1, stage="PS_COMPRESS_DEV", nbytes=12)


def _strip(evs):
    return [{k: v for k, v in e.items() if k != "t"} for e in evs]


def _strip_ages(text):
    return re.sub(r"-\s*\d+\.\d+s", "-AGE", text)


def test_ring_size_and_off_switch(monkeypatch):
    """The ring keeps the last ``size`` events (at least 16); the env knobs
    set it and switch it off; both as the JAX recorder does."""
    for size, n in ((20, 30), (4, 40)):
        ours, ref = flight.FlightRecorder(size=size, enabled=True), \
            jflight.FlightRecorder(size=size, enabled=True)
        for rec in (ours, ref):
            for i in range(n):
                rec.record("push", key=i, round=i)
        assert _strip(ours.events()) == _strip(ref.events())
        assert len(ours.events()) == max(16, size) == ours.size
        assert ours.events()[0]["key"] == n - max(16, size)
    monkeypatch.setenv("BPS_FLIGHT_RECORDER_SIZE", "32")
    monkeypatch.setenv("BPS_FLIGHT_RECORDER", "0")
    rec = flight.FlightRecorder()
    assert not rec.enabled and rec.size == 32
    rec.record("push", key=1)
    assert rec.events() == [] and rec.format_postmortem() == ""
    monkeypatch.setenv("BPS_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("BPS_FLIGHT_RECORDER_SIZE", "bad")
    rec.configure()
    assert rec.enabled and rec.size == 1024
    rec.record("push", key=1)
    assert len(rec.events()) == 1


def test_init_reconfigures_the_process_ring(monkeypatch):
    import byteps_tpu_torch as bps
    monkeypatch.delenv("BPS_ENABLE_PS", raising=False)
    monkeypatch.setenv("BPS_FLIGHT_RECORDER_SIZE", "64")
    bps.init(device="cpu")
    try:
        assert flight.get_recorder().size == 64
    finally:
        bps.shutdown()
        monkeypatch.delenv("BPS_FLIGHT_RECORDER_SIZE")
        flight.configure()
    assert flight.get_recorder().size == 1024


@pytest.mark.parametrize("keys", [None, [7], [9], [7, 9], [100]])
def test_key_filtered_dumps_are_the_jax_recorders(keys):
    """Filtered to the implicated keys (key-less events pass every filter),
    cut to the last N, rendered: the JAX recorder's events, postmortem and
    text, ages aside."""
    ours, ref = flight.FlightRecorder(enabled=True), \
        jflight.FlightRecorder(enabled=True)
    _events(ours)
    _events(ref)
    for last in (None, 2):
        assert _strip(ours.events(keys=keys, last=last)) == \
            _strip(ref.events(keys=keys, last=last))
    pm, jpm = ours.postmortem(keys=keys, last=3), ref.postmortem(keys=keys,
                                                                 last=3)
    assert pm["schema"] == jpm["schema"] and pm["keys"] == jpm["keys"]
    assert _strip(pm["events"]) == _strip(jpm["events"])
    assert _strip_ages(ours.format_postmortem(keys=keys)) == \
        _strip_ages(ref.format_postmortem(keys=keys))


def test_dump_logs_and_returns_the_postmortem():
    lines = []

    class Log:
        def error(self, fmt, text):
            lines.append(text)

    rec = flight.get_recorder()
    rec.configure(enabled=True)
    rec.clear()
    assert flight.dump(Log(), keys=[7]) is None       # nothing to say
    _events(rec)
    pm = flight.dump(Log(), keys=[7], reason="pull failure key=7")
    assert [e["kind"] for e in pm["events"]] == ["push", "codec", "pull"]
    assert lines[0].startswith("pull failure key=7\nflight recorder: last 3")
    rec.clear()


# ----------------------------------------------------------- watchdog

def _state(bucket_states, busy=(7,), waiters=None):
    return {"in_flight": 2, "rounds": [
        {"name": "g", "step": None, "seq": 1, "pulls_left": 2,
         "buckets": [{"pskey": k, "round": 3, "state": s}
                     for k, s in bucket_states]}],
        "admission": {"busy": list(busy), "waiters": waiters or {}}}


@pytest.mark.parametrize("state", [
    _state([(7, "pushed"), (8, "pulled")]),
    _state([(7, "failed"), (8, "pending")], busy=()),
    _state([(7, "pending")], busy=(), waiters={7: 2}),
    _state([], busy=(5, 6)),
], ids=["wedge", "failed", "queued", "gate-only"])
def test_dump_text_and_keys_are_the_jax_watchdogs(state):
    assert implicated_keys(state) == jwatchdog.implicated_keys(state)
    assert format_dump(state, 2.5) == jwatchdog.format_dump(state, 2.5)


def test_watchdog_fires_once_and_rearms():
    class Target:
        def __init__(self):
            self.t = time.monotonic()

        def progress_state(self):
            return self.t, 2

        def debug_state(self):
            return _state([(7, "pushed")])

    tgt = Target()
    dumps = []
    reg = tmetrics.get_registry()
    d0 = reg.counter("watchdog/dumps").value
    wd = StallWatchdog(tgt, stall_sec=0.15, poll_sec=0.03,
                       on_dump=lambda s, stalled: dumps.append(stalled))
    try:
        time.sleep(0.1)
        assert not dumps                 # not stalled long enough yet
        t0 = time.monotonic()
        while not dumps:
            assert time.monotonic() - t0 < 5.0, "watchdog never fired"
            time.sleep(0.01)
        time.sleep(0.05)
        assert len(dumps) == 1           # once a stall period
        tgt.t = time.monotonic()         # progress re-arms it
        time.sleep(0.08)
        assert len(dumps) == 1
        t0 = time.monotonic()
        while len(dumps) < 2:            # and a new stall fires again
            assert time.monotonic() - t0 < 5.0, "watchdog did not re-arm"
            time.sleep(0.01)
    finally:
        wd.stop()
    assert reg.counter("watchdog/dumps").value - d0 == len(dumps)


def test_watchdog_silent_while_nothing_on_the_wire():
    """All buckets pending and an idle gate is upstream latency, not a
    wedge; an idle exchange (nothing in flight) is silent too."""
    for in_flight, st in ((3, _state([(7, "pending")], busy=())),
                          (0, _state([(7, "pushed")]))):
        class Target:
            def progress_state(self):
                return time.monotonic() - 60, in_flight

            def debug_state(self):
                return st

        dumps = []
        wd = StallWatchdog(Target(), stall_sec=0.1, poll_sec=0.03,
                           on_dump=lambda s, stalled: dumps.append(s))
        try:
            time.sleep(0.3)
            assert not dumps
        finally:
            wd.stop()


class _WedgedBackend:
    """In-memory backend whose pull of ``wedge_key`` blocks until released:
    the lost pull, injected."""

    def __init__(self):
        self.store = {}
        self.wedge_key = None
        self.release = threading.Event()

    def init_key(self, key, nbytes, dtype="float32", init=None,
                 compression=None, fused=False):
        self.store[key] = np.zeros(nbytes // np.dtype(dtype).itemsize, dtype)

    def push(self, key, data):
        self.store[key] = np.array(data, copy=True)

    def pull(self, key, out, round=0, timeout_ms=30000):
        if key == self.wedge_key and not self.release.wait(timeout_ms / 1e3):
            raise TimeoutError(f"pull({key}) wedged")
        out[:] = self.store[key]

    def round(self, key):
        return 0


def test_watchdog_names_a_wedged_pull_in_the_exchange(monkeypatch):
    """``BPS_WATCHDOG_SEC=0.3``: a wedged pull is named within the stall
    period (slack for a loaded machine), as pushed and holding the gate,
    with its push in the dump's flight events; released, the round
    completes and ``close()`` stops the watchdog."""
    monkeypatch.setenv("BPS_WATCHDOG_SEC", "0.3")
    monkeypatch.delenv("BPS_COMPRESS", raising=False)
    flight.configure(enabled=True)
    reg = tmetrics.get_registry()
    # the gauge is process-wide: a round another test's exchange left
    # stuck (a dead owner) stays counted, so hold this exchange's own
    base = reg.gauge("ps/rounds_in_flight").value
    be = _WedgedBackend()
    ex = PSGradientExchange(be, partition_bytes=4 << 10, pipeline_depth=2)
    tree = [("a", torch.ones(2048)), ("b", torch.ones(2048))]
    try:
        ex.plan_for(tree, name="wedge")
        (_, keyed), = ex._plans.values()
        assert len(keyed) >= 2 and ex._watchdog is None
        be.wedge_key = keyed[-1][0]
        h = ex.exchange_async(tree, name="wedge")
        t0 = time.time()
        while ex._watchdog is None or ex._watchdog.dumps == 0:
            assert time.time() - t0 < 10.0, "watchdog never fired"
            time.sleep(0.02)
        assert time.time() - t0 < 5.0
        assert reg.gauge("ps/rounds_in_flight").value >= base + 1
        dump = ex._watchdog.last_dump
        wedged = [b for r in dump["rounds"] for b in r["buckets"]
                  if b["pskey"] == be.wedge_key]
        assert wedged and wedged[0]["state"] == "pushed"
        assert be.wedge_key in dump["admission"]["busy"]
        assert implicated_keys(dump) == {be.wedge_key}
        assert any(e["kind"] == "push" and e.get("key") == be.wedge_key
                   for e in dump["flight"]["events"])
        assert "pushed, pull never completed (wedge)" in format_dump(dump, 1)
        be.release.set()                 # unwedged, the round completes
        out = h.result()
        np.testing.assert_allclose(out[0], 1.0)
        assert ex.in_flight_buckets() == 0
    finally:
        be.release.set()
        ex.close()
    assert ex._watchdog is None
    assert reg.gauge("ps/rounds_in_flight").value == base


@pytest.mark.parametrize("depth", [1, 2])
def test_exchange_metrics_and_gauge_balance(depth):
    """Bytes and bucket counters tick, the serial and the pipelined round
    both leave ``ps/rounds_in_flight`` at 0, every push and pull is a
    flight event, and no watchdog starts without ``BPS_WATCHDOG_SEC``."""
    reg = tmetrics.get_registry()
    rec = flight.get_recorder()
    rec.configure(enabled=True)
    rec.clear()
    p0, b0 = reg.counter("ps/push_bytes").value, \
        reg.counter("ps/buckets_completed").value
    base = reg.gauge("ps/rounds_in_flight").value    # process-wide
    be = _WedgedBackend()
    ex = PSGradientExchange(be, partition_bytes=4 << 10,
                            pipeline_depth=depth, watchdog_sec=0)
    try:
        out = ex.exchange([("a", torch.ones(2048)), ("b", torch.ones(100))],
                          name="bal")
        np.testing.assert_allclose(out[0], 1.0)
        assert ex._watchdog is None
    finally:
        ex.close()
    assert reg.counter("ps/push_bytes").value - p0 == 2148 * 4
    n = reg.counter("ps/buckets_completed").value - b0
    assert n >= 2
    assert reg.gauge("ps/rounds_in_flight").value == base
    kinds = [e["kind"] for e in rec.events()]
    assert kinds.count("push") == kinds.count("pull") == n
    assert kinds.count("admit") == (n if depth > 1 else 0)
