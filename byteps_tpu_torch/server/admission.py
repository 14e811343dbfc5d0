"""Admission for the sync exchange (the port's copy of the depth-1 part of
``byteps_tpu/server/admission.py``).

``KeyGate`` is the per-key push gate: round k+1's push of a key waits until
round k's pull of that key completed, because the server publishes one
round per key at a time. Under the sharded weight update a replica does
not pull the buckets of groups it does not own: such a key is released
when the owners' param frames of every group the bucket covers have
landed (``server/ps_mode.py::_Round.release_skipped``), which implies the
owner pulled that round. ``PullQueue`` drains landed buckets oldest round
first, then by next-step first-use priority. ``AdmissionPlane`` is the
facade an exchange owns. Every grant is a flight-recorder event
(``admit``; a deferred grant says how long it waited), and ``state()`` is
the watchdog's view of the gate.

``SendScheduler`` is the wire credit gate of the remote transport
(``BPS_SCHEDULING_CREDIT`` > 0): a payload frame of the gradient class
waits until it is the highest-priority queued frame and its bytes fit the
credit, and holds the credit across its roundtrip. Gradient frames are
``CLASS_GRAD``; the sharded update's param PUT frames are ``CLASS_ACT``,
the latency class, with next-step first-use priority among themselves:
they gate the next step's forward, so a small one overtakes a queued
gradient burst.

Not ported yet (ROADMAP.md): ``BPS_MAX_LAG`` > 1 (the bounded-staleness
store, a gate of depth K).
"""

from __future__ import annotations

import heapq
import itertools
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


# -- the two-class wire send scheduler (byteps_tpu/server/admission.py:223-390)

CLASS_GRAD = 0
CLASS_ACT = 1
# any latency-class frame outranks any gradient bucket (gradient
# priorities are bounded by the leaf count, far below this)
ACT_PRIO_BASE = 1 << 20
# frames at or below this ride free: headers, acks, control ops
MIN_SCHED_BYTES = 4096


class _Ticket:
    __slots__ = ("klass", "prio", "key", "nbytes", "seq", "t_enq")

    def __init__(self, klass: int, prio: int, key: int, nbytes: int,
                 seq: int) -> None:
        self.klass = klass
        self.prio = prio
        self.key = key
        self.nbytes = int(nbytes)
        self.seq = seq
        self.t_enq = time.monotonic()

    def order(self):
        """Heap key: priority descending, key ascending, then FIFO (the
        BytePS ``scheduled_queue`` comparator)."""
        eff = self.prio + (ACT_PRIO_BASE if self.klass == CLASS_ACT else 0)
        return (-eff, self.key, self.seq)


class SendScheduler:
    """Wire admission (BytePS ``scheduled_queue.cc:82-146`` and
    ``BYTEPS_SCHEDULING_CREDIT``): ``acquire`` blocks until the frame is
    the highest-priority queued entry and its bytes fit the credit;
    ``release`` returns them once the frame's roundtrip ended. One frame is
    always admitted even when larger than the whole credit, so a large
    bucket cannot deadlock. Every admission goes into a bounded trace and
    the ``sched/*`` metrics, and is a ``send_admit`` flight event."""

    def __init__(self, credit_bytes: int, trace_cap: int = 4096) -> None:
        self.credit = int(credit_bytes)
        self._cv = threading.Condition()
        self._heap: List[tuple] = []          # (order, ticket)
        self._seq = itertools.count(1)
        self._inflight = 0
        self._trace: deque = deque(maxlen=trace_cap)
        self._admit_seq = 0
        reg = get_registry()
        self._m_act = reg.counter("sched/admitted_act")
        self._m_grad = reg.counter("sched/admitted_grad")
        self._m_overtakes = reg.counter("sched/overtakes")
        self._m_wait = reg.histogram("sched/credit_wait_s")
        self._g_inflight = reg.gauge("sched/inflight_bytes")

    def acquire(self, klass: int, prio: int, key: int,
                nbytes: int) -> Optional[_Ticket]:
        """Block until this frame may be written; returns the ticket for
        ``release`` (None below the scheduling floor)."""
        if nbytes <= MIN_SCHED_BYTES:
            return None
        t = _Ticket(klass, prio, key, nbytes, next(self._seq))
        entry = (t.order(), t)
        with self._cv:
            heapq.heappush(self._heap, entry)
            while not (self._heap[0] is entry
                       and (self._inflight == 0
                            or self._inflight + t.nbytes <= self.credit)):
                self._cv.wait(1.0)
            heapq.heappop(self._heap)
            self._inflight += t.nbytes
            self._g_inflight.set(self._inflight)
            self._admit_seq += 1
            # an overtake: an entry queued before this one still waits
            overtook = any(e[1].seq < t.seq for e in self._heap)
            waited = time.monotonic() - t.t_enq
            self._trace.append({
                "class": "act" if klass == CLASS_ACT else "grad",
                "key": key, "prio": prio, "nbytes": t.nbytes,
                "enq_seq": t.seq, "admit_seq": self._admit_seq,
                "wait_s": waited, "overtook": overtook, "t": time.time(),
            })
        (self._m_act if klass == CLASS_ACT else self._m_grad).inc()
        if overtook:
            self._m_overtakes.inc()
        self._m_wait.observe(waited)
        # key-less, like the codec decisions: a frame waited because of
        # some other key's burst
        if flight.get_recorder().enabled:
            flight.record(
                "send_admit", nbytes=t.nbytes,
                detail=f"class={'act' if klass == CLASS_ACT else 'grad'} "
                       f"key={key} prio={prio} wait_ms={waited * 1e3:.1f} "
                       f"overtook={overtook}")
        return t

    def release(self, ticket: Optional[_Ticket]) -> None:
        if ticket is None:
            return
        with self._cv:
            self._inflight -= ticket.nbytes
            self._g_inflight.set(self._inflight)
            self._cv.notify_all()

    def trace(self) -> List[dict]:
        """Admission records, oldest first (a bounded window)."""
        with self._cv:
            return list(self._trace)

    def queued(self) -> int:
        with self._cv:
            return len(self._heap)

    def inflight(self) -> int:
        return self._inflight


_send_lock = threading.Lock()
_send_current: Optional[SendScheduler] = None
_send_configured = False


def configure_send(
        credit_bytes: Optional[int] = None) -> Optional[SendScheduler]:
    """(Re)build the process-wide wire scheduler. ``None`` reads
    ``BPS_SCHEDULING_CREDIT`` (``BYTEPS_SCHEDULING_CREDIT`` accepted);
    a credit <= 0 disables it. ``bps.init()`` calls it with the config's
    credit when it builds a remote backend."""
    global _send_current, _send_configured
    if credit_bytes is None:
        credit_bytes = int(
            os.environ.get("BPS_SCHEDULING_CREDIT",
                           os.environ.get("BYTEPS_SCHEDULING_CREDIT", "0"))
            or 0)
    with _send_lock:
        _send_current = (SendScheduler(credit_bytes)
                         if credit_bytes > 0 else None)
        _send_configured = True
        return _send_current


def send_scheduler() -> Optional[SendScheduler]:
    """The process-wide wire scheduler, or None when disabled; the first
    call resolves it from the environment, so transports built by hand
    honour the knob too."""
    if not _send_configured:
        configure_send()
    return _send_current
