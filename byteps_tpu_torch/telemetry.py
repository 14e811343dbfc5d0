"""Push-pull bandwidth telemetry (the port's copy of ``PushPullSpeed`` in
``byteps_tpu/telemetry.py``; reference: PushPullSpeed, global.cc:697-752
— a 10-second MB/s sliding window exposed to Python as
``bps.get_pushpull_speed()``, operations.cc:131-136).

``BPS_TELEMETRY_ON=1`` makes ``GlobalState`` build one and hand it to the
``PushPullEngine``, which records every completed push_pull. The JAX
package's trace-event summaries below the window read its tracer, which
is not ported yet (ROADMAP.md, queue 9).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Tuple

WINDOW_SEC = 10.0


class PushPullSpeed:
    def __init__(self, window_sec: float = WINDOW_SEC) -> None:
        self._lock = threading.Lock()
        self._window = window_sec
        self._events: Deque[Tuple[float, int]] = deque()  # (ts, nbytes)

    def record(self, nbytes: int, duration_s: float = 0.0) -> None:
        """Record a completed transfer. ``duration_s`` back-dates the
        event to the transfer's start, so a long transfer reads as a
        sustained rate, not a burst at its completion. A duration longer
        than the window clamps just inside the window's edge, where the
        next reader does not evict it at once."""
        now = time.time()
        ts = now - min(max(float(duration_s), 0.0), self._window * 0.99)
        with self._lock:
            # back-dated events may land behind newer completions: keep
            # the deque ordered by time, scanning from the tail, where a
            # transfer's start lies
            if self._events and ts < self._events[-1][0]:
                idx = len(self._events)
                while idx > 0 and self._events[idx - 1][0] > ts:
                    idx -= 1
                self._events.insert(idx, (ts, nbytes))
            else:
                self._events.append((ts, nbytes))
            self._evict(now)

    def _evict(self, now: float) -> None:
        while self._events and now - self._events[0][0] > self._window:
            self._events.popleft()

    def mbps(self) -> float:
        """Mean MB/s over the sliding window."""
        now = time.time()
        with self._lock:
            self._evict(now)
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            span = max(now - self._events[0][0], 1e-6)
            return total / span / 1e6
