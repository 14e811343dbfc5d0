"""Bounded staleness, the server's round store: the port's
``server/admission.py::StaleStore`` (and ``KeyGate`` at depth K, the
plane's ``gate_round``) against the JAX package's on the same scripted
sequences, bit for bit: published sums, verdict flags, streaks,
``round()``, late folds, open sums, every ``lag/*`` counter and gauge, and
the key-less ``lag_admit`` flight events.

Every decision is driven by the order of events, never by a clock: pushes
are scripted, a pull is issued only where the decision table resolves it
without waiting (grace 0 seals at once), and the one pull that must block
(the barrier) runs on a thread that the test joins with a timeout after
the store has counted its barrier decision.
"""

import threading
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from byteps_tpu.obs import flight as jflight
from byteps_tpu.obs.metrics import get_registry as jregistry
from byteps_tpu.server import admission as jadm
from byteps_tpu_torch.obs import flight as pflight
from byteps_tpu_torch.obs.metrics import get_registry as pregistry
from byteps_tpu_torch.server import admission as padm

LAG_METRICS = ("lag/stale_serves", "lag/barrier_falls", "lag/late_folds",
               "lag/evicted_serves")
SIZE = 6


@pytest.fixture(autouse=True)
def _grace_zero(monkeypatch):
    monkeypatch.setenv("BPS_LAG_GRACE_MS", "0")
    monkeypatch.delenv("BPS_MAX_LAG", raising=False)
    monkeypatch.delenv("BPS_WORKER_ID", raising=False)


def _counters(reg):
    return {n: reg.counter(n).value for n in LAG_METRICS}


class _Both:
    """One key in a port store and a JAX store, driven in lock step."""

    def __init__(self, workers: int, K: int, key: int = 7) -> None:
        self.key, self.K, self.workers = key, K, workers
        self.port = padm.StaleStore(workers)
        self.jax = jadm.StaleStore(workers)
        for s in (self.port, self.jax):
            s.declare(key, SIZE, "float32", K)
        self.c0 = (_counters(pregistry()), _counters(jregistry()))
        # the gauges hold the last value any store of the process set
        for reg in (pregistry(), jregistry()):
            for name in ("lag/max_streak", f"lag/streak/{key}"):
                reg.gauge(name).set(0)
        for rec in (pflight.get_recorder(), jflight.get_recorder()):
            rec.configure(enabled=True)
            rec.clear()

    def push(self, w: int, r: int, data: np.ndarray) -> None:
        a = self.port.push(self.key, w, r, data.copy())
        b = self.jax.push(self.key, w, r, data.copy())
        assert a == b

    def resolvable(self, r: int) -> bool:
        """Does a pull of round ``r`` resolve without waiting (grace 0)?
        The decision table walked over a copy of the JAX store's state."""
        st_ = self.jax._keys[self.key]
        up, streak = st_.published_upto, list(st_.streak)
        while up < r:
            contrib = st_.contrib.get(up + 1, set())
            missing = [w for w in range(self.workers) if w not in contrib]
            if missing and not all(streak[m] + 1 <= self.K - 1
                                   for m in missing):
                return False
            streak = [0 if w in contrib else streak[w] + 1
                      for w in range(self.workers)]
            up += 1
        return True

    def pull(self, w: int, r: int):
        outs = [np.zeros(SIZE, np.float32) for _ in range(2)]
        fa = self.port.pull(self.key, w, r, outs[0], timeout_ms=5000)
        fb = self.jax.pull(self.key, w, r, outs[1], timeout_ms=5000)
        assert fa == fb
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0].tobytes() == outs[1].tobytes()
        return fa, outs[0]

    def check(self) -> None:
        p, j = self.port._keys[self.key], self.jax._keys[self.key]
        assert p.published_upto == j.published_upto
        assert self.port.round(self.key) == self.jax.round(self.key)
        assert p.streak == j.streak
        assert self.port.streaks(self.key) == self.jax.streaks(self.key)
        assert p.late_folds == j.late_folds
        assert sorted(p.published) == sorted(j.published)
        for r in p.published:
            assert p.published[r][1] == j.published[r][1]
            assert p.published[r][0].tobytes() == j.published[r][0].tobytes()
        assert sorted(p.acc) == sorted(j.acc)
        for r in p.acc:
            assert p.acc[r].tobytes() == j.acc[r].tobytes()
            assert p.contrib[r] == j.contrib[r]
        dp = {n: v - self.c0[0][n] for n, v in _counters(pregistry()).items()}
        dj = {n: v - self.c0[1][n] for n, v in _counters(jregistry()).items()}
        assert dp == dj
        for name in ("lag/max_streak", f"lag/streak/{self.key}"):
            assert pregistry().gauge(name).value == \
                jregistry().gauge(name).value
        ep = [e["detail"] for e in pflight.get_recorder().events()
              if e["kind"] == "lag_admit"]
        ej = [e["detail"] for e in jflight.get_recorder().events()
              if e["kind"] == "lag_admit"]
        assert ep == ej


@pytest.fixture(autouse=True)
def _recorders_off():
    yield
    for rec in (pflight.get_recorder(), jflight.get_recorder()):
        rec.clear()
        rec.configure(enabled=False)


# -- drawn sequences ----------------------------------------------------------

@st.composite
def _script(draw):
    K = draw(st.integers(1, 3))
    workers = draw(st.integers(1, 3))
    start = draw(st.sampled_from([1, 1, 1, 9]))      # 9: a rejoin adopt
    ops = draw(st.lists(st.tuples(st.integers(0, workers - 1),
                                  st.sampled_from(["push", "push", "pull"]),
                                  st.integers(0, 2 ** 16)),
                        min_size=1, max_size=40))
    return K, workers, start, ops


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_script())
def test_drawn_sequences_agree_bit_for_bit(script):
    """Hypothesis-drawn pushes and resolvable pulls, K in {1, 2, 3}, 1-3
    workers: each worker pushes its next round and pulls its oldest
    unpulled one, as an exchange does; a pull the table would hold is
    left for later. Sums, flags, streaks, rounds, late folds, open sums,
    counters, gauges and flight events agree after every operation."""
    K, workers, start, ops = script
    both = _Both(workers, K)
    pushed = [start - 1] * workers
    pulled = [start - 1] * workers
    for w, op, seed in ops:
        if op == "push":
            pushed[w] += 1
            data = np.random.RandomState(seed).randn(SIZE).astype(np.float32)
            both.push(w, pushed[w], data)
        elif pulled[w] < pushed[w] and both.resolvable(pulled[w] + 1):
            pulled[w] += 1
            both.pull(w, pulled[w])
        both.check()


# -- the reference's scenarios ------------------------------------------------

def test_k1_is_strictly_synchronous():
    """K=1: the seal condition is unsatisfiable; a pull with a missing
    worker cannot resolve (the walk says so, and the store's own pull
    times out), and completes once the worker pushed."""
    both = _Both(2, 1)
    both.push(0, 1, np.ones(SIZE, np.float32))
    assert not both.resolvable(1)
    for store in (both.port, both.jax):
        with pytest.raises(TimeoutError):
            store.pull(both.key, 0, 1, np.zeros(SIZE, np.float32),
                       timeout_ms=1)
    both.push(1, 1, np.ones(SIZE, np.float32))
    flags, out = both.pull(0, 1)
    assert flags == padm.LAG_COMPLETE == jadm.LAG_COMPLETE
    np.testing.assert_array_equal(out, 2.0)
    both.check()
    assert both.port.streaks(both.key) == [0, 0]


def test_conflicting_lag_declaration_is_loud():
    for mod in (padm, jadm):
        store = mod.StaleStore(num_workers=2)
        store.declare(0, 4, "float32", 2)
        store.declare(0, 4, "float32", 2)          # idempotent
        with pytest.raises(ValueError, match="disagree on BPS_MAX_LAG"):
            store.declare(0, 4, "float32", 3)
        assert store.declared(0) == 2 and store.declared(1) is None
        with pytest.raises(KeyError, match="not lag-managed"):
            store.round(1)


def test_barrier_drains_the_late_push_before_publishing():
    """2 workers, K=2: round 1 seals without worker 1 (its streak reaches
    the bound), so worker 0's pull of round 2 barriers until worker 1's
    late round-1 push folds into round 2; the sum holds it. The blocked
    pull runs on a thread, joined after the store counted its barrier."""
    both = _Both(2, 2)
    both.push(0, 1, np.ones(SIZE, np.float32))
    flags, out = both.pull(0, 1)
    assert flags == padm.LAG_STALE
    np.testing.assert_array_equal(out, 1.0)
    assert both.port.streaks(both.key) == [0, 1]
    both.push(0, 2, np.ones(SIZE, np.float32))
    assert not both.resolvable(2)
    res = {}
    barrier = {"port": pregistry().counter("lag/barrier_falls"),
               "jax": jregistry().counter("lag/barrier_falls")}
    before = {n: c.value for n, c in barrier.items()}

    def puller(name, store):
        o = np.zeros(SIZE, np.float32)
        res[name] = (store.pull(both.key, 0, 2, o, timeout_ms=20000), o)

    threads = [threading.Thread(target=puller, args=(n, s), daemon=True)
               for n, s in (("port", both.port), ("jax", both.jax))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while any(c.value == before[n] for n, c in barrier.items()):
        assert time.monotonic() < deadline, "no barrier decision"
        time.sleep(0.001)
    assert all(t.is_alive() for t in threads)
    both.push(1, 1, np.full(SIZE, 2.0, np.float32))   # late: folds to 2
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    for name in ("port", "jax"):
        flags, out = res[name]
        assert flags & padm.LAG_BARRIER
        np.testing.assert_array_equal(out, 3.0)        # drained, not dropped
    assert res["port"][1].tobytes() == res["jax"][1].tobytes()
    assert res["port"][0] == res["jax"][0]
    both.check()
    assert both.port.streaks(both.key) == [0, 0]


def test_evicted_round_serves_the_newest_snapshot():
    """A pull beyond the 2K+4 retention window is served the newest
    published sum, flagged stale, and counted."""
    K = 2
    both = _Both(1, K)
    rounds = 2 * K + 4 + 10
    for r in range(1, rounds + 1):
        both.push(0, r, np.full(SIZE, float(r), np.float32))
        both.pull(0, r)
    assert len(both.port._keys[both.key].published) == 2 * K + 4
    flags, out = both.pull(0, 1)
    assert flags & padm.LAG_STALE
    np.testing.assert_array_equal(out, float(rounds))
    both.check()


def test_rejoin_adopts_the_live_round():
    both = _Both(2, 2)
    both.push(0, 57, np.ones(SIZE, np.float32))
    both.push(1, 57, np.ones(SIZE, np.float32))
    assert both.port.round(both.key) == 56
    flags, out = both.pull(0, 57)
    assert flags == padm.LAG_COMPLETE
    np.testing.assert_array_equal(out, 2.0)
    assert both.port.round(both.key) == 57
    both.check()


@pytest.mark.parametrize("K,workers", [(2, 3), (3, 3), (2, 2)])
def test_streaks_never_exceed_the_bound_and_sums_are_conserved(K, workers):
    """Scripted paces: worker w pushes only every (w + 1)-th turn; the
    leader pulls whatever resolves. No streak ever reaches K, and every
    pushed gradient lands in exactly one published or open round."""
    both = _Both(workers, K)
    pushed = [0] * workers
    pulled, pulled_total = 0, 0.0
    for turn in range(60):
        for w in range(workers):
            if turn % (w + 1) == 0:
                pushed[w] += 1
                both.push(w, pushed[w], np.ones(SIZE, np.float32))
        while pulled < pushed[0] and both.resolvable(pulled + 1):
            pulled += 1
            _, out = both.pull(0, pulled)
            pulled_total += float(out.sum())
            assert max(both.port.streaks(both.key)) <= K - 1
        both.check()
    # the leader pulled every published round, each once, so the pulled
    # sums and the open ones hold every pushed gradient once
    assert pulled > 2 * K
    st_ = both.port._keys[both.key]
    open_total = sum(float(a.sum()) for a in st_.acc.values())
    assert pulled_total + open_total == sum(pushed) * SIZE
    assert st_.late_folds > 0


def test_keygate_depth_k_is_a_counting_semaphore():
    """Depth K admits K rounds of a key and queues the next FIFO; the
    JAX gate admits the same sequence."""
    for K in (1, 2, 3):
        orders = []
        for mod in (padm, jadm):
            gate = mod.KeyGate(depth=K)
            order = []
            for i in range(K + 2):
                gate.admit(1, lambda i=i: order.append(f"r{i}"))
            gate.admit(2, lambda: order.append("b"))
            assert order == [f"r{i}" for i in range(K)] + ["b"]
            assert gate.state() == {"busy": [1, 2], "waiters": {1: 2}}
            for _ in range(K + 2):
                gate.release(1)
            gate.release(2)
            assert gate.state() == {"busy": [], "waiters": {}}
            orders.append(order)
        assert orders[0] == orders[1]


def test_plane_takes_k_and_the_worker_id(monkeypatch):
    for mod in (padm, jadm):
        plane = mod.AdmissionPlane()
        assert (plane.max_lag, plane.gate.depth, plane.worker_id) == (1, 1, 0)
        assert plane.gate_round(7) == 6
        monkeypatch.setenv("BPS_MAX_LAG", "4")
        monkeypatch.setenv("BPS_WORKER_ID", "3")
        plane = mod.AdmissionPlane()
        assert (plane.max_lag, plane.gate.depth, plane.worker_id) == (4, 4, 3)
        assert plane.gate_round(7) == 3
        assert mod.AdmissionPlane(max_lag=2, worker_id=1).gate_round(7) == 5
        monkeypatch.delenv("BPS_MAX_LAG")
        monkeypatch.delenv("BPS_WORKER_ID")
    monkeypatch.setenv("BPS_LAG_GRACE_MS", "1500")
    assert padm.lag_grace_s() == jadm.lag_grace_s() == 1.5
