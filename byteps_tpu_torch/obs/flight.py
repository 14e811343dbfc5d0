"""Flight recorder: a bounded ring of recent pipeline events (the port's
copy of ``byteps_tpu/obs/flight.py``).

The stall watchdog (``obs/watchdog.py``) answers *what is stuck*: which
key holds the admission gate, which bucket pushed and never pulled. It
cannot answer *what happened*: the wedge is only the last frame of a
sequence (the pushes that landed, the admission grants that ordered them,
the codec the controller picked two rounds ago). This module records that
sequence: every push, pull, admission grant and codec decision of the
ported paths, and the sharded update's param frames (``param_put`` by the
owner's publisher, ``param_fetch`` by a non-owner, a timed-out fetch with
its error), appends one small event to a per-process ring
(``BPS_FLIGHT_RECORDER``, default on; ``BPS_FLIGHT_RECORDER_SIZE``
events, default 1024, at least 16), and the failure paths (the
watchdog's stall dump, a failed pull, a refused decode) dump the last N
events for the implicated keys as a structured postmortem.

Cost: one ``deque.append`` of a small dict under a lock per event;
``BPS_FLIGHT_RECORDER=0`` turns ``record`` into one attribute read.

The ring is process-wide (``get_recorder()``): a postmortem for key K
shows K's pushes and the neighbouring admission grants that scheduled
them, which is the interleaving a wedge diagnosis needs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

from ..common.config import _TRUE


def _env_enabled() -> bool:
    return os.environ.get("BPS_FLIGHT_RECORDER", "1").strip().lower() \
        in _TRUE


def _env_size() -> int:
    try:
        return max(16, int(os.environ.get("BPS_FLIGHT_RECORDER_SIZE",
                                          "1024") or 1024))
    except ValueError:
        return 1024


class FlightRecorder:
    """Bounded event ring and postmortem renderer."""

    def __init__(self, size: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self._enabled = _env_enabled() if enabled is None else bool(enabled)
        self._events: deque = deque(maxlen=_env_size()
                                    if size is None else max(16, int(size)))
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def size(self) -> int:
        return self._events.maxlen

    def configure(self, enabled: Optional[bool] = None,
                  size: Optional[int] = None) -> None:
        """Re-resolve the env knobs (``bps.init()`` calls this); explicit
        arguments win over the environment."""
        self._enabled = _env_enabled() if enabled is None else bool(enabled)
        new_size = _env_size() if size is None else max(16, int(size))
        with self._lock:
            if new_size != self._events.maxlen:
                self._events = deque(self._events, maxlen=new_size)

    def record(self, kind: str, key: Optional[int] = None,
               round: Optional[int] = None, stage: Optional[str] = None,
               nbytes: Optional[int] = None, outcome: str = "ok",
               detail: Optional[str] = None) -> None:
        """Append one event. ``kind`` is push / pull / admit / codec / ...:
        free-form, the ring is a diagnostic, not a schema."""
        if not self._enabled:
            return
        ev: Dict = {"t": time.time(), "kind": kind, "outcome": outcome}
        if key is not None:
            ev["key"] = int(key)
        if round is not None:
            ev["round"] = int(round)
        if stage is not None:
            ev["stage"] = stage
        if nbytes is not None:
            ev["bytes"] = int(nbytes)
        if detail is not None:
            ev["detail"] = detail
        with self._lock:
            self._events.append(ev)

    def events(self, keys: Optional[Iterable[int]] = None,
               last: Optional[int] = None) -> List[Dict]:
        """Snapshot, optionally filtered to the implicated ``keys`` (key-less
        events, such as codec decisions, always pass: they are context for
        every key) and cut to the ``last`` N."""
        with self._lock:
            evs = list(self._events)
        if keys is not None:
            ks = {int(k) for k in keys}
            evs = [e for e in evs if "key" not in e or e["key"] in ks]
        if last is not None and last > 0:
            evs = evs[-last:]
        return evs

    def postmortem(self, keys: Optional[Iterable[int]] = None,
                   last: int = 40) -> Dict:
        """The structured dump the failure paths attach: the last ``last``
        events for ``keys`` (None: all of them)."""
        return {"schema": "byteps_tpu.FlightPostmortem/v1",
                "keys": sorted({int(k) for k in keys}) if keys else None,
                "events": self.events(keys=keys, last=last)}

    def format_postmortem(self, keys: Optional[Iterable[int]] = None,
                          last: int = 40) -> str:
        """Human form of ``postmortem`` (empty when the ring is off or holds
        nothing for the keys)."""
        if not self._enabled:
            return ""
        pm = self.postmortem(keys=keys, last=last)
        evs = pm["events"]
        if not evs:
            return ""
        now = time.time()
        head = (f"flight recorder: last {len(evs)} event(s)"
                + (f" for key(s) {pm['keys']}" if pm["keys"] else "") + ":")
        lines = [head]
        for e in evs:
            parts = [f"  -{max(0.0, now - e['t']):7.3f}s", e["kind"]]
            for f in ("key", "round", "stage", "bytes"):
                if f in e:
                    parts.append(f"{f}={e[f]}")
            if e.get("outcome", "ok") != "ok":
                parts.append(f"outcome={e['outcome']}")
            if "detail" in e:
                parts.append(f"({e['detail']})")
            lines.append(" ".join(parts))
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-wide flight recorder every pipeline layer feeds."""
    return _RECORDER


def record(kind: str, **kw) -> None:
    """Module-level shortcut for the hot call sites."""
    _RECORDER.record(kind, **kw)


def configure(**kw) -> None:
    _RECORDER.configure(**kw)


def dump(logger, keys: Optional[Iterable[int]] = None,
         reason: str = "", last: int = 40) -> Optional[Dict]:
    """Log the postmortem for ``keys`` at ERROR (the failure-path hook).
    Returns the structured postmortem, or None when there was nothing to
    say; callers raise their own error regardless."""
    text = _RECORDER.format_postmortem(keys=keys, last=last)
    if not text:
        return None
    if reason:
        text = f"{reason}\n{text}"
    try:
        logger.error("%s", text)
    except Exception:   # noqa: BLE001 — a diagnostic must never raise
        pass
    return _RECORDER.postmortem(keys=keys, last=last)
