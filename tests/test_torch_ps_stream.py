"""The PS exchange's streaming and ingest rounds and the chunked apply of
the port's default PS step, on the CPU.

Counterparts of the JAX package's ``tests/test_ps_overlap.py`` (:200-317)
and ``tests/test_cross_step.py`` (:167-246) at the exchange level:

  - ``exchange_stream`` and ``exchange_ingest`` (leaves fed out of order, in
    groups) give every round's sums that ``exchange`` gives, bit for bit,
    under none, int8 and fp8 with error feedback; the ingest round equals
    the JAX package's;
  - a push or pull failure surfaces from ``ready()`` and ``result()``;
    ``abort`` wakes both; ``feed`` refuses a wrong leaf, a second feed and
    a feed after ``finish``;
  - ``leaf_groups`` is the JAX exchange's partition; landed buckets are
    pulled by next-use priority; the watchdog names a held pull of an
    ingest round;
  - ``ChunkedApply`` steps bit for bit what the fused ``step()`` steps, for
    stock optimizers and several param groups; a norm-coupled optimizer
    fails the probe and keeps the fused apply; the epoch gate waits and
    aborts;
  - a pinned staging buffer is handed out again only once the copy that
    read it has completed.

Tolerance: none; every contract here is bytes. Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.server.engine import HostPSBackend as JBackend
from byteps_tpu.server.ps_mode import PSGradientExchange as JExchange
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.obs import flight
from byteps_tpu_torch.obs import metrics as tmetrics
from byteps_tpu_torch.obs.watchdog import implicated_keys
from byteps_tpu_torch.optim import ChunkedApply, leafwise_decomposable
from byteps_tpu_torch.server.engine import HostPSBackend
from byteps_tpu_torch.server.ps_mode import PSGradientExchange
from byteps_tpu_torch.staging import PinnedPool

WAIT = 20.0          # seconds any single wait may take before it fails


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    for name in ("BPS_COMPRESS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
                 "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    tdev.reset_probe()
    yield
    tdev.reset_probe()
    torch.set_num_threads(n)


SHAPES = [(64, 33), (900,), (17, 5, 12), (3000,), (1,)]


def _tree(seed):
    rng = np.random.RandomState(seed)
    return [(f"l{i}", torch.from_numpy((rng.randn(*s) * (i + 1))
                                       .astype(np.float32)))
            for i, s in enumerate(SHAPES)]


def _exchange(codec="none", backend=None, **kw):
    be = backend or HostPSBackend(num_servers=1, num_workers=1,
                                  engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=kw.pop("partition_bytes",
                                                       4 << 10),
                            min_compress_bytes=0, compress=codec,
                            device="cpu", **kw)
    return be, ex


def _drain(handle):
    """Consume ``ready()`` (bounded) and return {leaf: flat copy}."""
    return {li: arr.copy() for li, arr in handle.ready(timeout=WAIT)}


def _feed_scrambled(handle, tree):
    """Leaves out of order, in two groups and a single."""
    order = [3, 0, 4, 1, 2]
    vals = [t for _, t in tree]
    handle.feed(order[:2], [vals[i] for i in order[:2]])
    handle.feed([order[2]], [vals[order[2]]])
    handle.feed(order[3:], [vals[i] for i in order[3:]])
    handle.finish()


@pytest.mark.parametrize("codec", ["none", "int8", "fp8_e4m3"])
def test_stream_and_ingest_give_the_sums_exchange_gives(codec):
    """Three rounds with error feedback through three exchanges, one per
    round form: every leaf of every round is the same bytes."""
    trees = [_tree(10 + r) for r in range(3)]
    outs = {}
    for form in ("exchange", "stream", "ingest"):
        be, ex = _exchange(codec)
        got = []
        try:
            for t in trees:
                if form == "exchange":
                    got.append([o.copy() for o in ex.exchange(t, name="g")])
                    continue
                if form == "stream":
                    h = ex.exchange_stream(t, name="g")
                else:
                    h = ex.exchange_ingest(t, name="g")
                    _feed_scrambled(h, t)
                seen = _drain(h)
                assert sorted(seen) == list(range(len(t)))
                res = h.result()
                for li, arr in seen.items():
                    assert arr.tobytes() == res[li].reshape(-1).tobytes()
                got.append([res[i].copy() for i in range(len(t))])
            if codec != "none":
                assert ex.n_compressed() > 1
        finally:
            ex.close()
            be.close()
        outs[form] = got
    for form in ("stream", "ingest"):
        for r, (a, b) in enumerate(zip(outs[form], outs["exchange"])):
            assert [x.tobytes() for x in a] == [x.tobytes() for x in b], \
                (form, r)


def test_ingest_is_the_jax_ingest():
    """The same leaves fed to both packages' ingest rounds (dense): the
    same sums, and the same leaves in the JAX tree's order."""
    t = _tree(5)
    be, ex = _exchange()
    try:
        h = ex.exchange_ingest(t, name="j")
        _feed_scrambled(h, t)
        got = h.result()
    finally:
        ex.close()
        be.close()
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        jex = JExchange(jbe, partition_bytes=4 << 10, min_compress_bytes=0)
        tree = {n: v.numpy() for n, v in t}
        jh = jex.exchange_ingest(tree, name="j")
        jh.feed(range(len(t)), [v.numpy() for _, v in t])
        jh.finish()
        want = jh.result()
        jex.close()
    finally:
        jbe.close()
    for (n, _), g in zip(t, got):
        assert g.tobytes() == np.asarray(want[n]).tobytes(), n


def test_leaf_groups_are_the_jax_exchanges():
    t = _tree(0)
    be, ex = _exchange()
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        jex = JExchange(jbe, partition_bytes=4 << 10)
        want = jex.leaf_groups({n: v.numpy() for n, v in t}, name="lg")
        got = ex.leaf_groups(t, name="lg")
        assert got == want
        assert sorted(li for g in got for li in g) == list(range(len(t)))
        assert len(got) > 2
        jex.close()
    finally:
        ex.close()
        be.close()
        jbe.close()


class _Failing:
    """Backend wrapper whose ``kind`` call raises from its ``fail_at``-th
    use on."""

    def __init__(self, inner, kind, fail_at=0):
        self._inner, self._kind, self._fail_at = inner, kind, fail_at
        self._n = 0
        self._lock = threading.Lock()

    def _maybe_fail(self, kind):
        if kind != self._kind:
            return
        with self._lock:
            n, self._n = self._n, self._n + 1
        if n >= self._fail_at:
            raise RuntimeError(f"injected {kind} failure")

    def push(self, key, data, *a, **kw):
        self._maybe_fail("push")
        return self._inner.push(key, data, *a, **kw)

    def pull(self, key, out, *a, **kw):
        self._maybe_fail("pull")
        return self._inner.pull(key, out, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("form", ["stream", "ingest"])
@pytest.mark.parametrize("kind", ["push", "pull"])
def test_a_failure_surfaces_from_ready_and_result(form, kind):
    t = _tree(1)
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    _, ex = _exchange(backend=_Failing(be, kind, fail_at=1))
    try:
        if form == "stream":
            h = ex.exchange_stream(t, name="f")
        else:
            h = ex.exchange_ingest(t, name="f")
            _feed_scrambled(h, t)
        with pytest.raises(RuntimeError, match=f"injected {kind} failure"):
            _drain(h)
        with pytest.raises(RuntimeError, match=f"injected {kind} failure"):
            h.result()
    finally:
        ex.close()
        be.close()


def test_abort_wakes_ready_and_result_and_feed_refuses_misuse():
    t = _tree(2)
    be, ex = _exchange()
    try:
        h = ex.exchange_ingest(t, name="a")
        h.feed([0], [t[0][1]])
        with pytest.raises(ValueError, match="fed twice"):
            h.feed([0], [t[0][1]])
        with pytest.raises(ValueError, match="plan expects"):
            h.feed([1], [torch.zeros(3)])
        with pytest.raises(RuntimeError, match="never fed"):
            h.result()
        woke = []

        def consume():
            try:
                _drain(h)
            except RuntimeError as e:
                woke.append(str(e))

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        time.sleep(0.05)
        h.abort(RuntimeError("backward died"))
        th.join(WAIT)
        assert not th.is_alive() and woke == ["backward died"]
        with pytest.raises(RuntimeError, match="backward died"):
            h.result()
        assert ex.in_flight_buckets() == 0

        h2 = ex.exchange_ingest(t, name="a")
        h2.feed([0, 1], [t[0][1], t[1][1]])
        with pytest.raises(ValueError, match="never fed"):
            h2.finish()
        with pytest.raises(RuntimeError, match="after finish"):
            h2.feed([2], [t[2][1]])
        h2.abort(RuntimeError("abandoned"))
    finally:
        ex.close()
        be.close()


def test_landed_buckets_are_pulled_by_next_use_priority():
    """Pulls held until every push landed, then released to ONE pull
    thread: the backlog drains input side first (ascending first leaf),
    whatever the push order (``byteps_tpu`` ``test_cross_step.py:167``)."""
    from concurrent.futures import ThreadPoolExecutor
    release, order = threading.Event(), []

    class Gated:
        def __init__(self, inner):
            self._inner = inner

        def pull(self, key, out, *a, **kw):
            release.wait(WAIT)
            order.append(key)
            return self._inner.pull(key, out, *a, **kw)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    t = [(f"l{i}", torch.full((2048,), float(i))) for i in range(6)]
    _, ex = _exchange(backend=Gated(be), partition_bytes=8 << 10,
                      pipeline_depth=2)
    try:
        ex._ensure_executors()
        ex._pull_ex.shutdown(wait=False)
        ex._pull_ex = ThreadPoolExecutor(1, thread_name_prefix="t-pull")
        h = ex.exchange_stream(t, name="prio")
        (_, keyed), = ex._plans.values()
        deadline = time.time() + WAIT
        # every push landed: the one pull thread holds the first bucket,
        # the others wait in the pull queue (a round assigned is not yet
        # a push landed, and under load a late push would be popped late)
        while (any(ex._key_rounds.get(k) is None for k, _ in keyed)
               or len(ex.plane.pulls._heap) < len(keyed) - 1):
            assert time.time() < deadline
            time.sleep(0.01)
        release.set()
        h.result()
        prio = {k: min(s.leaf_index for s in b.segments) for k, b in keyed}
        got = [prio[k] for k in order]
        assert len(got) == len(keyed) > 2
        assert got[1:] == sorted(got[1:]), got
    finally:
        release.set()
        ex.close()
        be.close()


def test_watchdog_names_a_held_pull_of_an_ingest_round(monkeypatch):
    """A pull held on an ingest round (the staged head's) is named in the
    dump as pushed and holding the gate, with its round's step tag."""
    monkeypatch.setenv("BPS_WATCHDOG_SEC", "0.3")
    flight.configure(enabled=True)
    release = threading.Event()
    held = {}

    class Held:
        def __init__(self, inner):
            self._inner = inner

        def pull(self, key, out, *a, **kw):
            if key == held.get("key"):
                release.wait(WAIT)
            return self._inner.pull(key, out, *a, **kw)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    t = _tree(4)
    # the gauge is process-wide: hold this exchange's own rounds
    base = tmetrics.get_registry().gauge("ps/rounds_in_flight").value
    _, ex = _exchange(backend=Held(be), pipeline_depth=2)
    try:
        ex.plan_for(t, name="w")
        (_, keyed), = ex._plans.values()
        held["key"] = keyed[-1][0]
        h = ex.exchange_ingest(t, name="w", step=7)
        _feed_scrambled(h, t)
        t0 = time.time()
        while ex._watchdog is None or ex._watchdog.dumps == 0:
            assert time.time() - t0 < WAIT, "the watchdog never fired"
            time.sleep(0.02)
        dump = ex._watchdog.last_dump
        (rnd,) = dump["rounds"]
        assert rnd["step"] == 7
        state = {b["pskey"]: b["state"] for b in rnd["buckets"]}
        assert state[held["key"]] == "pushed"
        assert held["key"] in dump["admission"]["busy"]
        assert held["key"] in implicated_keys(dump)
        release.set()
        assert len(_drain(h)) == len(t)
    finally:
        release.set()
        ex.close()
        be.close()
    assert tmetrics.get_registry().gauge("ps/rounds_in_flight").value \
        == base


# ------------------------------------------------------- chunked apply

def _params(seed=0, n=7):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(3 + i, 5, generator=g))
            for i in range(n)]


def _grads(params, step):
    g = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=g) for p in params]


OPTIMIZERS = {
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4,
                                          eps=1e-6),
    "sgd_nesterov": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9,
                                               nesterov=True,
                                               weight_decay=1e-3),
    "adam_two_groups": lambda ps: torch.optim.Adam(
        [{"params": ps[:3], "lr": 1e-2},
         {"params": ps[3:], "lr": 3e-3, "weight_decay": 1e-2}]),
}
GROUPS = [[0, 1], [2], [3, 4, 5], [6]]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_chunked_apply_is_the_fused_step_bitwise(opt):
    """Three steps per group (groups in a scrambled order) against three
    fused ``step()`` calls: parameters and every state tensor the same
    bytes; the state is the parent's own (no second state)."""
    ref_p, got_p = _params(), _params()
    ref = OPTIMIZERS[opt](ref_p)
    inner = OPTIMIZERS[opt](got_p)
    ch = ChunkedApply(inner, got_p, GROUPS)
    assert ch.decomposable
    for s in range(3):
        for p, g in zip(ref_p, _grads(ref_p, s)):
            p.grad = g
        ref.step()
        grads = _grads(got_p, s)
        hyper = ch.hyper()
        for gi in (2, 0, 3, 1):
            ch.apply_group(gi, [grads[i] for i in ch.groups[gi]], hyper)
        assert all(p.grad is None for p in got_p)
    for a, b in zip(ref_p, got_p):
        assert torch.equal(a, b)
    for a, b in zip(ref_p, got_p):
        sa, sb = ref.state[a], inner.state[b]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(torch.as_tensor(sa[k]),
                               torch.as_tensor(sb[k])), k
    assert all(c is None or c[0].state is inner.state
               for c in ch._children)


class _NormScaledSGD(torch.optim.SGD):
    """SGD on gradients divided by their global norm: coupled across
    leaves, so a per-group step is not the fused one."""

    @torch.no_grad()
    def step(self, closure=None):
        ps = [p for g in self.param_groups for p in g["params"]
              if p.grad is not None]
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
        for p in ps:
            p.grad.div_(norm)
        return super().step(closure)


def test_a_coupled_optimizer_keeps_the_fused_apply():
    ps = _params()
    assert not leafwise_decomposable(_NormScaledSGD(ps, lr=0.1), ps, GROUPS)
    ref_p, got_p = _params(), _params()
    ref = _NormScaledSGD(ref_p, lr=0.1)
    ch = ChunkedApply(_NormScaledSGD(got_p, lr=0.1), got_p, GROUPS)
    assert not ch.decomposable
    for s in range(2):
        for p, g in zip(ref_p, _grads(ref_p, s)):
            p.grad = g
        ref.step()
        ch.apply_fused(_grads(got_p, s))
    for a, b in zip(ref_p, got_p):
        assert torch.equal(a, b)


def test_an_optimizer_the_probe_cannot_run_is_coupled():
    class Broken(torch.optim.SGD):
        def step(self, closure=None):
            raise RuntimeError("no")

    ps = _params()
    assert not leafwise_decomposable(Broken(ps, lr=0.1), ps, GROUPS)


def test_epoch_gate_waits_for_the_mark_and_aborts():
    ps = _params()
    ch = ChunkedApply(torch.optim.SGD(ps, lr=0.1), ps, GROUPS)
    waited = []
    th = threading.Thread(target=lambda: waited.append(
        ch.wait_epoch([0, 3], 1)), daemon=True)
    th.start()
    time.sleep(0.1)
    assert th.is_alive()
    ch.mark_epoch([0], 1)
    time.sleep(0.05)
    assert th.is_alive()                 # leaf 3 still at epoch 0
    ch.mark_epoch(ch.groups[2], 1)
    th.join(WAIT)
    assert not th.is_alive() and waited[0] >= 0.1
    t0 = time.time()
    ch.wait_epoch([6], 5, should_abort=lambda: time.time() - t0 > 0.1)
    assert time.time() - t0 < WAIT
    ch.wait_device([0, 6])               # no event recorded on the CPU


# ------------------------------------------------------ pinned staging

class _Event:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_a_staging_buffer_is_reused_only_after_its_copy_completed():
    pool = PinnedPool(pin=False)
    a = pool.alloc(1000, np.float32)
    ev = _Event()
    pool.release(a, ev)
    b = pool.alloc(1000, np.float32)         # a's copy still in flight
    assert b.ctypes.data != a.ctypes.data and pool.allocated == 2
    c = pool.alloc(999, np.float32)          # another size never reuses
    assert pool.allocated == 3
    ev.done = True
    d = pool.alloc(1000, np.float32)         # a's copy completed
    assert d.ctypes.data == a.ctypes.data and pool.allocated == 3
    pool.release(b, None)
    pool.release(c, None)
    assert pool.alloc(1000, np.float32).ctypes.data == b.ctypes.data
    assert pool.alloc(999, np.float32).ctypes.data == c.ctypes.data
