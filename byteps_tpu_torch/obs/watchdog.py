"""Stall watchdog of the sync PS exchange (the port's copy of
``byteps_tpu/obs/watchdog.py``).

The pipelined exchange has a failure mode of its own: one lost pull
leaves its PS key's admission gate held forever, every later round's push
of that key queues behind it, and the job wedges silently: no exception,
no progress, nothing in the logs. ``StallWatchdog`` polls an exchange:
when it has buckets in flight and none has completed for ``stall_sec``
seconds, it snapshots the per-key exchange state (rounds, pushed and
missing buckets, the admission gate's holders and queued waiters) through
``debug_state()`` and logs it loudly, with the flight recorder's events
for the implicated keys, once a stall period, re-armed by progress.

Enabled by ``BPS_WATCHDOG_SEC`` (``PSGradientExchange`` starts one with
its pipeline threads); tests drive it directly. Under the sharded weight
update a bucket this replica does not pull waits in ``await_param`` for
its owners' param frames, and the dump names the owner rank: a dead
owner's wedge is attributable from the dump alone. The JAX package's dump
also names the pipeline stages' activation waits: pipeline parallelism is
not ported, so that state does not occur here.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import flight as _flight
from . import metrics as _metrics


def implicated_keys(state: dict) -> set:
    """The keys a stall dump points at: buckets that reached the wire
    (pushed, failed, or awaiting a param frame) and the admission gate's
    holders."""
    keys: set = set()
    for r in state.get("rounds", ()):
        for b in r.get("buckets", ()):
            if b.get("state") in ("pushed", "failed", "await_param"):
                k = b.get("pskey")
                if k is not None:
                    keys.add(int(k))
    for k in state.get("admission", {}).get("busy", ()):
        keys.add(int(k))
    return keys


def format_dump(state: dict, stalled_s: float) -> str:
    """Render ``debug_state()`` as the loud multi-line diagnostic."""
    lines = [
        f"PS exchange stalled: no bucket completed for {stalled_s:.1f}s "
        f"with {state.get('in_flight', '?')} bucket(s) in flight",
    ]
    for r in state.get("rounds", ()):
        lines.append(
            f"  round name={r.get('name')!r} step={r.get('step')} "
            f"seq={r.get('seq')} pulls_left={r.get('pulls_left')}")
        for b in r.get("buckets", ()):
            st = b.get("state")
            mark = ""
            if st == "pushed":
                mark = "  <-- pushed, pull never completed (wedge)"
            elif st == "await_param":
                # sharded update: this replica does not pull the bucket,
                # it waits for the owner's param publish
                mark = (f"  <-- pushed, awaiting param publish from "
                        f"owner replica {b.get('owner', '?')} "
                        f"(sharded update)")
            elif st == "failed":
                mark = "  <-- failed"
            lines.append(
                f"    key={b.get('pskey')} round={b.get('round')} "
                f"state={st}{mark}")
    adm = state.get("admission", {})
    busy = adm.get("busy", ())
    if busy:
        lines.append(f"  admission gate held by keys: {sorted(busy)}")
    waiters = adm.get("waiters", {})
    for k, n in sorted(waiters.items()):
        lines.append(f"    key={k}: {n} queued push(es) waiting on the "
                     f"gate holder's pull")
    if any(b.get("state") == "pushed"
           for r in state.get("rounds", ()) for b in r.get("buckets", ())):
        lines.append(
            "  a pushed-but-never-pulled bucket above is the wedge: its "
            "pull was lost (server death past the reconnect budget, or a "
            "peer that never pushed its share) and the per-key admission "
            "gate cannot release without it")
    elif any(b.get("state") == "await_param"
             for r in state.get("rounds", ()) for b in r.get("buckets", ())):
        lines.append(
            "  an await_param bucket above is the wedge: the named owner "
            "replica never published its param frame (it died between its "
            "grad pull and its param publish, or its publisher is "
            "stalled) — non-owners cannot release the bucket's admission "
            "key without the frame")
    else:
        lines.append(
            "  no bucket reached the wire yet: the stall is upstream of "
            "the exchange (a push blocked in the transport, or pushes "
            "queued behind the admission gate)")
    return "\n".join(lines)


class StallWatchdog:
    """Background stall detector over one exchange-like target.

    ``target`` exposes ``progress_state() -> (last_progress_ts,
    in_flight_buckets)``, the timestamp on the monotonic clock
    (``time.monotonic()``, so a wall-clock step can neither fake a stall
    nor hide one), and ``debug_state() -> dict``. ``on_dump`` (tests,
    external telemetry) receives ``(state_dict, stalled_s)`` after the log
    line is emitted."""

    def __init__(self, target, stall_sec: float,
                 poll_sec: Optional[float] = None, logger=None,
                 on_dump: Optional[Callable] = None) -> None:
        from ..common.logging import get_logger
        self._target = target
        self.stall_sec = float(stall_sec)
        self._poll = poll_sec if poll_sec is not None \
            else max(0.05, min(1.0, self.stall_sec / 4))
        self._log = logger or get_logger()
        self._on_dump = on_dump
        self._stop = threading.Event()
        self.dumps = 0                   # diagnostics emitted so far
        self.last_dump: Optional[dict] = None
        self._next_allowed = 0.0
        self._thread = threading.Thread(
            target=self._run, name="bps-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    # ------------------------------------------------------------ loop

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self._check()
            except Exception:   # noqa: BLE001 — a watchdog must never
                pass            # kill (or be killed by) the pipeline

    def _check(self) -> None:
        last_progress, in_flight = self._target.progress_state()
        now = time.monotonic()
        if not in_flight:
            return
        stalled = now - last_progress
        if stalled < self.stall_sec or now < self._next_allowed:
            return
        state = self._target.debug_state()
        # a wedge needs the wire: a bucket pushed (its pull is what is
        # lost) or pushes queued behind the admission gate. Rounds whose
        # buckets are all still "pending" with an idle gate are upstream
        # latency, not a wedge
        wired = any(b.get("state") in ("pushed", "pulled", "failed",
                                       "await_param", "param_done")
                    for r in state.get("rounds", ())
                    for b in r.get("buckets", ()))
        if not wired and not state.get("admission", {}).get("waiters"):
            return
        # progress may have landed between the two reads: check again so
        # a racing completion cannot produce a spurious dump
        last2, in_flight2 = self._target.progress_state()
        if last2 != last_progress or not in_flight2:
            return
        self._next_allowed = now + self.stall_sec   # once a stall period
        self.dumps += 1
        # the flight recorder's postmortem for the implicated keys: what
        # happened on the way to the wedge, beside what is stuck
        keys = implicated_keys(state)
        rec = _flight.get_recorder()
        pm = rec.format_postmortem(keys=keys or None, last=40)
        state = dict(state)
        state["flight"] = rec.postmortem(keys=keys or None, last=40)
        self.last_dump = state
        _metrics.get_registry().counter("watchdog/dumps").inc()
        msg = format_dump(state, stalled)
        if pm:
            msg = f"{msg}\n{pm}"
        self._log.error("%s", msg)
        if self._on_dump is not None:
            try:
                self._on_dump(state, stalled)
            except Exception:   # noqa: BLE001 — an observer must not
                pass            # kill the watchdog
