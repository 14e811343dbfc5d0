"""Admission for the PS exchange (the port's copy of
``byteps_tpu/server/admission.py``).

``KeyGate`` is the per-key push gate: at most ``depth`` rounds of a key may
be pushed but not yet pulled (depth 1 at the default K=1: round k+1's push
waits until round k's pull completed, because the server publishes one
round per key at a time; depth K under bounded staleness, whose store
holds K rounds a key). Under the sharded weight update a replica does
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

K-round bounded staleness (``BPS_MAX_LAG=K`` > 1; the port's copy of
``byteps_tpu/server/admission.py:391-669``): ``StaleStore`` is the
server's versioned round store of the lag-managed (dense) keys. The pull
of the oldest unpublished round decides per (key, round) whether to
serve the complete sum (every worker contributed, ``LAG_COMPLETE``: the
only verdict at K=1), to SEAL it without the stragglers when each missing
worker still has slack under its bound (a worker may miss at most K-1
consecutive rounds; after ``BPS_LAG_GRACE_MS``, ``LAG_STALE``), or to
BARRIER until a worker at its bound pushed (``LAG_BARRIER``). A push for
a sealed round folds into the open round (a late fold), so no gradient is
dropped; sealed sums are immutable snapshots, the same bytes to every
puller, so replicas stay identical. Stale serves, barriers and evictions
are key-less ``lag_admit`` flight events and the ``lag/*`` metrics. The
reference's span ring (``spans``) is not ported yet (ROADMAP.md queue 1,
item 9): ``spans`` stays None. ``KeyGate`` has depth K, and
``AdmissionPlane.gate_round(e)`` is the cross-step driver's wait target,
``e - K``.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..obs import flight
from ..obs.metrics import get_registry

# pull_lag verdict flags (bits 0 and 1 of the pull reply's verdict byte)
LAG_COMPLETE = 0       # every worker contributed: the K=1 verdict
LAG_STALE = 1          # sealed under the bound without some workers
LAG_BARRIER = 2        # a bound was exhausted; the pull waited it out


class KeyGate:
    """Per-key push admission: at most ``depth`` rounds of a key may be
    pushed-but-unpulled at once; excess pushes queue FIFO per key, so
    rounds stay ordered. Deferred admissions are counted and their wait
    timed: the gate is where a lost pull would turn into a wedge."""

    def __init__(self, depth: int = 1) -> None:
        self.depth = max(1, int(depth))
        self._lock = threading.Lock()
        self._held: Dict[int, int] = {}
        self._waiters: Dict[int, deque] = {}
        reg = get_registry()
        self._m_wait = reg.histogram("ps/admission_wait_s")
        self._m_defer = reg.counter("ps/admission_deferred")

    def admit(self, pskey: int, submit) -> None:
        """Run ``submit`` now if ``pskey`` has a slot free, else when one
        frees (FIFO per key)."""
        with self._lock:
            if self._held.get(pskey, 0) >= self.depth:
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
            self._held[pskey] = self._held.get(pskey, 0) + 1
        flight.record("admit", key=pskey)
        submit()

    def release(self, pskey: int) -> None:
        with self._lock:
            waiters = self._waiters.get(pskey)
            if waiters:
                submit = waiters.popleft()
                if not waiters:
                    del self._waiters[pskey]
            else:
                n = self._held.get(pskey, 0) - 1
                if n <= 0:
                    self._held.pop(pskey, None)
                else:
                    self._held[pskey] = n
                return
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
    """The declared staleness bound K (``BPS_MAX_LAG``, default 1: the
    sync path, a round publishes only when every worker contributed)."""
    if explicit is not None:
        return max(1, int(explicit))
    return max(1, int(os.environ.get("BPS_MAX_LAG", "1") or 1))


def lag_grace_s() -> float:
    """``BPS_LAG_GRACE_MS``: how long a seal-eligible pull waits for the
    round to complete before sealing it (0 = seal at once)."""
    return max(0.0, float(os.environ.get("BPS_LAG_GRACE_MS", "0")
                          or 0)) / 1e3


class AdmissionPlane:
    """The admission decisions of one exchange: the per-key push gate
    (depth K), the landed-bucket pull queue and the cross-step epoch
    bound. The server's ``StaleStore`` is its peer across the wire."""

    def __init__(self, max_lag: Optional[int] = None,
                 worker_id: Optional[int] = None) -> None:
        self.max_lag = resolve_max_lag(max_lag)
        self.worker_id = (int(os.environ.get("BPS_WORKER_ID", "0") or 0)
                          if worker_id is None else int(worker_id))
        self.gate = KeyGate(depth=self.max_lag)
        self.pulls = PullQueue()

    def gate_round(self, e: int) -> int:
        """The newest epoch whose parameters must be applied before step
        ``e`` may read them: the cross-step driver's wait target (``e - 1``
        at K=1)."""
        return e - self.max_lag


# -- K-round bounded staleness, the server side
# (byteps_tpu/server/admission.py:391-641)

class _LagKey:
    __slots__ = ("size", "dtype", "max_lag", "cv", "acc", "contrib",
                 "published", "published_upto", "streak", "late_folds")

    def __init__(self, size: int, dtype: str, max_lag: int,
                 num_workers: int) -> None:
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self.max_lag = int(max_lag)
        self.cv = threading.Condition()
        self.acc: Dict[int, np.ndarray] = {}       # open rounds' sums
        self.contrib: Dict[int, set] = {}          # round -> worker ids
        self.published: Dict[int, tuple] = {}      # round -> (sum, flags)
        self.published_upto = 0
        # consecutive published rounds each worker missed; the bound is
        # streak <= max_lag - 1, enforced at seal time
        self.streak = [0] * num_workers
        self.late_folds = 0


class StaleStore:
    """Server-side versioned round store of the lag-managed keys.

    The decision table, evaluated by the pull of the oldest unpublished
    round (earlier rounds are served from their published snapshots):

      every worker contributed          -> publish COMPLETE (flags 0)
      missing workers all have slack
        (streak + 1 <= K - 1)           -> wait ``BPS_LAG_GRACE_MS``,
                                           then SEAL (a stale serve)
      some missing worker is at bound   -> BARRIER: block until its push
                                           arrives, then publish

    K=1 makes the seal condition unsatisfiable, so the store serves
    complete rounds only. A push for an already-published round folds into
    the current open round and counts as that worker's contribution to it
    (a late fold): sums are conserved, and a slow worker alternates miss
    and contribute instead of drifting into a permanent barrier. Published
    rounds are kept for 2K+4 rounds; a pull of an evicted round is served
    the newest snapshot, flagged stale. A fresh store whose first push is
    of round r > 1 adopts r - 1 as its published head (a rejoining worker
    or a replacement server meets the fleet at its live round)."""

    def __init__(self, num_workers: int, spans=None) -> None:
        self.num_workers = max(1, int(num_workers))
        self.spans = spans
        self._lock = threading.Lock()
        self._keys: Dict[int, _LagKey] = {}
        reg = get_registry()
        self._m_stale = reg.counter("lag/stale_serves")
        self._m_barrier = reg.counter("lag/barrier_falls")
        self._m_late = reg.counter("lag/late_folds")
        self._m_evicted = reg.counter("lag/evicted_serves")
        self._g_streak = reg.gauge("lag/max_streak")

    def declare(self, key: int, size: int, dtype: str,
                max_lag: int) -> None:
        """Route ``key``'s rounds through this store with bound
        ``max_lag``. Idempotent; workers disagreeing on K raise."""
        key, max_lag = int(key), int(max_lag)
        with self._lock:
            st = self._keys.get(key)
            if st is not None:
                if st.max_lag != max_lag:
                    raise ValueError(
                        f"key {key} lag bound re-declared {max_lag} != "
                        f"{st.max_lag} — workers disagree on BPS_MAX_LAG")
                return
            self._keys[key] = _LagKey(size, dtype, max_lag,
                                      self.num_workers)

    def managed(self, key: int) -> bool:
        with self._lock:
            return int(key) in self._keys

    def declared(self, key: int) -> Optional[int]:
        with self._lock:
            st = self._keys.get(int(key))
            return None if st is None else st.max_lag

    def streaks(self, key: int) -> List[int]:
        st = self._st(key)
        with st.cv:
            return list(st.streak)

    def round(self, key: int) -> int:
        """The last published round: what a rejoining worker seeds from."""
        st = self._st(key)
        with st.cv:
            return st.published_upto

    def _st(self, key: int) -> _LagKey:
        with self._lock:
            st = self._keys.get(int(key))
        if st is None:
            raise KeyError(f"key {key} is not lag-managed "
                           f"(declare_lag never reached this server)")
        return st

    def push(self, key: int, worker: int, rnd: int,
             data: np.ndarray) -> int:
        """Fold one worker's gradient; returns the round it landed in:
        ``rnd``, or the open round when ``rnd`` was already sealed."""
        st = self._st(key)
        worker, rnd = int(worker), int(rnd)
        data = np.asarray(data).reshape(-1)
        with st.cv:
            if st.published_upto == 0 and not st.acc and rnd > 1:
                st.published_upto = rnd - 1      # failover/rejoin adopt
            if rnd <= st.published_upto:
                tgt = st.published_upto + 1      # late fold
                st.late_folds += 1
                self._m_late.inc()
            else:
                tgt = rnd
            acc = st.acc.get(tgt)
            if acc is None:
                acc = st.acc[tgt] = np.zeros(st.size, st.dtype)
                st.contrib[tgt] = set()
            if data.dtype != st.dtype:
                data = data.astype(st.dtype)
            acc += data
            st.contrib[tgt].add(worker)
            st.cv.notify_all()
        return tgt

    def pull(self, key: int, worker: int, rnd: int, out: np.ndarray,
             timeout_ms: int = 30000) -> int:
        """Block until every round <= ``rnd`` is published (publishing
        them per the decision table), then copy round ``rnd``'s snapshot
        into ``out``. Returns the verdict flags (LAG_COMPLETE or
        LAG_STALE, with LAG_BARRIER when this pull waited out an
        exhausted bound)."""
        st = self._st(key)
        rnd = int(rnd)
        grace = lag_grace_s()
        deadline = time.monotonic() + int(timeout_ms) / 1e3
        flags = 0
        barrier_logged: set = set()
        with st.cv:
            t_wait0 = time.monotonic()
            while st.published_upto < rnd:
                nxt = st.published_upto + 1
                contrib = st.contrib.get(nxt, ())
                missing = [w for w in range(self.num_workers)
                           if w not in contrib]
                if not missing:
                    self._publish(st, key, nxt, sealed=False)
                    continue
                can_seal = all(st.streak[m] + 1 <= st.max_lag - 1
                               for m in missing)
                now = time.monotonic()
                if can_seal and now - t_wait0 >= grace:
                    self._publish(st, key, nxt, sealed=True,
                                  missing=missing)
                    continue
                if not can_seal and nxt not in barrier_logged:
                    barrier_logged.add(nxt)
                    flags |= LAG_BARRIER
                    self._m_barrier.inc()
                    self._decision("barrier", key, nxt, missing, st)
                if now >= deadline:
                    raise TimeoutError(
                        f"pull_lag key={key} round={rnd} blocked "
                        f"{int(timeout_ms)}ms at round {nxt} "
                        f"(missing workers {missing}, "
                        f"streaks {list(st.streak)})")
                # a seal-eligible pull sleeps only to the end of its grace
                # (a floor against spinning, far below any grace)
                st.cv.wait(min(
                    deadline - now,
                    max(grace - (now - t_wait0), 0.0005)
                    if can_seal else 0.25))
            ent = st.published.get(rnd)
            if ent is None:
                # beyond the retention window: the newest sum, flagged
                # stale (its pushes late-fold, so they still land once)
                ent = st.published[st.published_upto]
                flags |= LAG_STALE
                self._m_evicted.inc()
                self._decision("evicted", key, rnd, (), st)
            arr, f = ent
            flags |= f
            view = out.reshape(-1)
            if view.dtype == arr.dtype:
                np.copyto(view, arr)
            else:
                view[:] = arr.astype(view.dtype)
        return flags

    def _publish(self, st: _LagKey, key: int, rnd: int, sealed: bool,
                 missing=()) -> None:
        """Publish round ``rnd``'s sum as an immutable snapshot and advance
        the streaks. The caller holds ``st.cv``."""
        acc = st.acc.pop(rnd, None)
        contrib = st.contrib.pop(rnd, set())
        if acc is None:             # nobody pushed (a drained rejoin gap)
            acc = np.zeros(st.size, st.dtype)
        st.published[rnd] = (acc, LAG_STALE if sealed else LAG_COMPLETE)
        st.published_upto = rnd
        for w in range(self.num_workers):
            st.streak[w] = 0 if w in contrib else st.streak[w] + 1
        cut = rnd - (2 * st.max_lag + 4)
        for old in [r for r in st.published if r <= cut]:
            del st.published[old]
        if sealed:
            self._m_stale.inc()
            self._g_streak.set(max(st.streak))
            get_registry().gauge(f"lag/streak/{key}").set(max(st.streak))
            self._decision("stale", key, rnd, missing, st)
            if self.spans is not None:
                self.spans.note_seal(key, rnd, missing)
        st.cv.notify_all()

    def _decision(self, verdict: str, key: int, rnd: int, missing,
                  st: _LagKey) -> None:
        # key-less like send_admit: a sealed round is context for every
        # key's postmortem (the enabled check first)
        if flight.get_recorder().enabled:
            flight.record(
                "lag_admit",
                detail=f"verdict={verdict} key={key} round={rnd} "
                       f"missing={sorted(missing)} "
                       f"streaks={list(st.streak)} K={st.max_lag}")


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
