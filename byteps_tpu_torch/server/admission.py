"""Admission for the sync exchange (the port's copy of the depth-1 part of
``byteps_tpu/server/admission.py``).

``KeyGate`` is the per-key push gate: round k+1's push of a key waits until
round k's pull of that key completed, because the server publishes one
round per key at a time. ``PullQueue`` drains landed buckets oldest round
first, then by next-step first-use priority. ``AdmissionPlane`` is the
facade an exchange owns. Every grant is a flight-recorder event
(``admit``; a deferred grant says how long it waited), and ``state()`` is
the watchdog's view of the gate.

Not ported yet (ROADMAP.md): ``BPS_MAX_LAG`` > 1 (the bounded-staleness
store, a gate of depth K) and the two-class wire send scheduler.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..obs import flight
from ..obs.metrics import get_registry


class KeyGate:
    """Per-key push admission: at most one round of a key may be
    pushed-but-unpulled at once; excess pushes queue FIFO per key, so
    rounds stay ordered. Deferred admissions are counted and their wait
    timed: the gate is where a lost pull would turn into a wedge."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._held: set = set()
        self._waiters: Dict[int, deque] = {}
        reg = get_registry()
        self._m_wait = reg.histogram("ps/admission_wait_s")
        self._m_defer = reg.counter("ps/admission_deferred")

    def admit(self, pskey: int, submit) -> None:
        """Run ``submit`` now if ``pskey`` is free, else when it frees."""
        with self._lock:
            if pskey in self._held:
                self._m_defer.inc()
                t0 = time.time()

                def deferred(submit=submit, t0=t0):
                    wait = time.time() - t0
                    self._m_wait.observe(wait)
                    flight.record("admit", key=pskey,
                                  detail=f"deferred {wait:.3f}s")
                    submit()

                self._waiters.setdefault(pskey, deque()).append(deferred)
                return
            self._held.add(pskey)
        flight.record("admit", key=pskey)
        submit()

    def release(self, pskey: int) -> None:
        with self._lock:
            waiters = self._waiters.get(pskey)
            if not waiters:
                self._held.discard(pskey)
                return
            submit = waiters.popleft()
            if not waiters:
                del self._waiters[pskey]
        submit()                     # the slot passes to the successor

    def state(self) -> dict:
        """Holders and queued waiters: the watchdog's dump shape."""
        with self._lock:
            return {"busy": sorted(self._held),
                    "waiters": {k: len(v) for k, v in self._waiters.items()}}


class PullQueue:
    """Pull scheduler for landed buckets: a min-heap ordered by (round
    age, next-step first-use priority, FIFO). Pushes keep
    backward-completion order, pulls drain input-side first. Also owns the
    round sequence the age order keys on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._heap: List[tuple] = []
        self._seq = 0
        self._round_seq = 0

    def next_round_seq(self) -> int:
        with self._lock:
            self._round_seq += 1
            return self._round_seq

    def put(self, round_seq: int, prio: int, payload) -> None:
        with self._lock:
            heapq.heappush(self._heap, (round_seq, prio, self._seq, payload))
            self._seq += 1

    def pop(self):
        """The highest-priority landed bucket."""
        with self._lock:
            return heapq.heappop(self._heap)[3]


def resolve_max_lag(explicit: Optional[int] = None) -> int:
    """The declared staleness bound K (``BPS_MAX_LAG``, default 1)."""
    if explicit is not None:
        return max(1, int(explicit))
    return max(1, int(os.environ.get("BPS_MAX_LAG", "1") or 1))


class AdmissionPlane:
    """The admission decisions of one exchange: the per-key push gate and
    the landed-bucket pull queue."""

    def __init__(self, max_lag: Optional[int] = None) -> None:
        self.max_lag = resolve_max_lag(max_lag)
        if self.max_lag > 1:
            raise NotImplementedError(
                f"BPS_MAX_LAG={self.max_lag} (bounded staleness) is not "
                f"ported yet (see ROADMAP.md, 'Modules still to port')")
        self.gate = KeyGate()
        self.pulls = PullQueue()
