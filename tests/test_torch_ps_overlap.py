"""The port's default PS step on the CPU: the staged head, the streamed
tail and the cross-step driver, and gradient accumulation in PS mode
(counterparts of the JAX package's ``tests/test_ps_overlap.py`` :84-198,
``tests/test_cross_step.py`` :248-438 and ``tests/test_ps_trainer.py``).

BERT at 2 layers, hidden 128, 4 heads of 32, vocab 512, seq 64, batches of 4
made from seeds, in fp32, cut into 8 buckets of 256 KiB; weights from
``transformer.init_params(PRNGKey(0))`` through ``convert.params_from_jax``;
``BPS_MIN_COMPRESS_BYTES=0`` and ``BPS_COMPRESS_DEVICE=1`` (the plain
versions of the codec kernels on CPU tensors), AdamW with eps 1e-6.

  - Every route (the default one, ``BPS_CROSS_STEP=0``, ``BPS_BWD_STAGED=0``)
    ends 3 steps with the parameters, the optimizer state and the losses of
    the monolithic route (``BPS_APPLY_CHUNKED=0``) bit for bit, under none,
    int8, fp8 and the README's onebit chains: the routes change the
    schedule, not a number.
  - ``backward_passes_per_step`` > 1: the running mean is the JAX
    package's bit for bit on the same gradients
    (``test_torch_ps_overlap_jax.py`` holds the routes and the accumulation
    against the JAX trainer).
  - The staged head feeds the monolithic backward's gradients, bit for
    bit, in batches during the backward; ``BPS_BWD_GROUPS`` caps them.
  - Cross-step: reading the weights drains; a tail failure surfaces and a
    restore lifts it; a restore mid-pipeline wins over the tails in flight;
    a forward or backward failure rolls the epoch back.

Every step and wait is bounded, so a hang fails the test instead of the
suite's time limit.
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch

from _torch_ps_routes import (_TCFG, EPS, LR, README, ROUTES, STEPS,  # noqa: F401
                              _batch, _loss, _ps_env, _run, _same_state,
                              _snapshot, _trainer, _within, jparams)
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.server import ps_mode
from byteps_tpu_torch.training import DistributedTrainer

# ------------------------------------------------------------ routes

CODECS = {"none": ("none", None), "int8": ("int8", None),
          "fp8_e4m3": ("fp8_e4m3", None), "onebit": ("none", README)}


@pytest.mark.parametrize("case", sorted(CODECS))
def test_every_route_is_the_monolithic_route_bitwise(case, jparams,
                                                     monkeypatch):
    codec, compression = CODECS[case]
    ref_l, ref, _ = _run(jparams, monkeypatch, "monolithic", codec=codec,
                         compression=compression)
    for route in ("default", "draining", "unstaged"):
        losses, got, tt = _run(jparams, monkeypatch, route, codec=codec,
                               compression=compression)
        assert losses == ref_l, route
        _same_state(got, ref)
        assert tt._chunked.decomposable
        assert (tt._cross_driver is not None) == (route == "default")
        if compression:
            assert tt.ps_exchange.n_chained() == 8
        elif codec != "none":
            assert tt.ps_exchange.n_compressed() == 8
    assert all(np.isfinite(ref_l))
    moved = convert.params_to_jax_layout(tt.model)
    assert not np.array_equal(moved["blocks"]["qkv"],
                              jparams["blocks"]["qkv"])


# ------------------------------------------------------- accumulation

class _Window:
    """The trainers' accumulation state, for their ``_accumulate``."""

    def __init__(self, k):
        self.backward_passes_per_step, self.step_count, self._accum = k, 0, None


@pytest.mark.parametrize("k", [2, 3])
def test_the_running_mean_is_the_jax_packages_bitwise(k):
    rng = np.random.RandomState(k)
    shapes = [(33, 7), (1000,), (5,)]
    jw, tw = _Window(k), _Window(k)
    for step in range(2 * k):
        g = [(rng.randn(*s) * 10.0 ** rng.randint(-3, 3)).astype(np.float32)
             for s in shapes]
        want = JaxTrainer._accumulate(jw, {f"g{i}": x
                                           for i, x in enumerate(g)})
        got = DistributedTrainer._accumulate(tw, [torch.from_numpy(x.copy())
                                                  for x in g])
        assert (want is None) == (got is None) == ((step + 1) % k != 0)
        if got is not None:
            for i, x in enumerate(got):
                assert x.numpy().tobytes() == \
                    np.asarray(want[f"g{i}"]).tobytes()
    assert tw.step_count == jw.step_count == 2 * k


# ---------------------------------------------------------- the head

def _recording_feeds(monkeypatch):
    calls = []
    feed = ps_mode._IngestExchange.feed

    def recording(self, leaf_ids, values, events=None):
        tr = recording.trainer
        calls.append((list(leaf_ids), [v.detach().clone() for v in values],
                      tr is not None and tr._head is not None))
        return feed(self, leaf_ids, values, events)

    recording.trainer = None
    monkeypatch.setattr(ps_mode._IngestExchange, "feed", recording)
    return calls, recording


def test_the_staged_head_feeds_the_monolithic_gradients(jparams,
                                                        monkeypatch):
    """The gradients the hooks hand over are the monolithic backward's,
    bit for bit; the bucket groups go to the wire in batches while the
    backward still runs; every leaf goes once."""
    calls, rec = _recording_feeds(monkeypatch)
    tt = _trainer(jparams, monkeypatch)
    rec.trainer = tt
    batch = _batch(0)
    model = tbert.Transformer(_TCFG)
    model.load_state_dict(convert.params_from_jax(jparams))
    _loss(model, tuple(torch.from_numpy(x) for x in batch)).backward()
    pushed = get_registry().counter("ps/push_bytes_in_backward")
    before = pushed.value
    _within(lambda: tt.step(batch))
    fed = {li: (g, inside) for ids, gs, inside in calls
           for li, g in zip(ids, gs)}
    names = [n for n, _ in tt._ps_params]
    assert sorted(fed) == list(range(len(names)))
    assert sum(len(ids) for ids, _, _ in calls) == len(names)
    ref = dict(model.named_parameters())
    for li, n in enumerate(names):
        assert torch.equal(fed[li][0], ref[n].grad), n
    during = [c for c in calls if c[2]]
    assert len(during) == len(calls) >= 2
    assert pushed.value >= before
    _within(tt.drain)


def test_bwd_groups_caps_the_feed_batches(jparams, monkeypatch):
    _, ref, _ = _run(jparams, monkeypatch, "monolithic")
    calls, rec = _recording_feeds(monkeypatch)
    monkeypatch.setenv("BPS_BWD_GROUPS", "2")
    losses, got, tt = _run(jparams, monkeypatch, "default")
    assert len(calls) == 2 * STEPS
    assert len(tt._feed_batches()) == 2 < len(tt._chunked.groups)
    _same_state(got, ref)
    monkeypatch.setenv("BPS_BWD_GROUPS", "-1")
    with pytest.raises(ValueError, match="BPS_BWD_GROUPS"):
        _trainer(jparams, monkeypatch)


class _NormScaledAdamW(torch.optim.AdamW):
    """AdamW on gradients divided by their global norm: coupled."""

    @torch.no_grad()
    def step(self, closure=None):
        ps = [p for g in self.param_groups for p in g["params"]
              if p.grad is not None]
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
        for p in ps:
            p.grad.div_(norm)
        return super().step(closure)


def test_a_coupled_optimizer_keeps_the_fused_apply(jparams, monkeypatch):
    opt = lambda ps: _NormScaledAdamW(ps, lr=LR, eps=EPS)  # noqa: E731
    ref_l, ref, _ = _run(jparams, monkeypatch, "monolithic", optimizer=opt)
    losses, got, tt = _run(jparams, monkeypatch, "default", optimizer=opt)
    assert not tt._chunked.decomposable and tt._cross_driver is None
    assert losses == ref_l
    _same_state(got, ref)


# ---------------------------------------------------------- cross-step

class _SlowPulls:
    """Every pull waits ``delay`` s first; ``fail_at`` (a pull count)
    raises once instead."""

    def __init__(self, inner, delay=0.05, fail_at=None):
        self._inner, self.delay, self.fail_at = inner, delay, fail_at
        self.n = 0
        self._lock = threading.Lock()

    def pull(self, key, out, *a, **kw):
        with self._lock:
            n, self.n = self.n, self.n + 1
        time.sleep(self.delay)
        if n == self.fail_at:
            raise RuntimeError("injected pull failure")
        return self._inner.pull(key, out, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _slow(tt, **kw):
    slow = _SlowPulls(tt.ps_exchange.backend, **kw)
    tt.ps_exchange.backend = slow
    return slow


def test_reading_the_weights_drains_the_pipeline(jparams, monkeypatch):
    _, ref, _ = _run(jparams, monkeypatch, "monolithic")
    tt = _trainer(jparams, monkeypatch)
    _slow(tt)
    for i in range(STEPS):
        _within(lambda i=i: tt.step(_batch(i)))
    d = tt._cross_driver
    assert d is not None and d.busy          # the last tail is in flight
    model = _within(lambda: tt.model)
    assert not d.busy and not d.pending
    _same_state(_snapshot(tt), ref)
    assert model is tt._model


def test_a_tail_failure_surfaces_and_a_restore_lifts_it(jparams,
                                                        monkeypatch):
    tt = _trainer(jparams, monkeypatch)
    _within(lambda: tt.step(_batch(0)))
    snap = _snapshot(tt)
    slow = _slow(tt, delay=0.0, fail_at=12)   # in step 3's tail
    for i in (1, 2):
        _within(lambda i=i: tt.step(_batch(i)))
    with pytest.raises(RuntimeError, match="PARTIALLY stepped") as err:
        _within(tt.drain)
    assert "injected pull failure" in repr(err.value.__cause__)
    for read in (lambda: tt.model, tt.state_dict,
                 lambda: tt.step(_batch(3))):
        with pytest.raises(RuntimeError, match="PARTIALLY stepped"):
            _within(read)
    _within(lambda: tt.load_state_dict(copy.deepcopy(snap)))
    _same_state(_snapshot(tt), snap)
    assert slow.n > 12
    for i in (1, 2):
        _within(lambda i=i: tt.step(_batch(i)))
    got = _snapshot(tt)
    # the same two steps from the same state on a fresh trainer
    ref = _trainer(jparams, monkeypatch, ROUTES["monolithic"])
    ref.load_state_dict(copy.deepcopy(snap))
    for i in (1, 2):
        ref.step(_batch(i))
    _same_state(got, _snapshot(ref))


def test_a_restore_mid_pipeline_wins(jparams, monkeypatch):
    tt = _trainer(jparams, monkeypatch)
    _within(lambda: tt.step(_batch(0)))
    snap = _snapshot(tt)
    _slow(tt, delay=0.1)
    for i in (1, 2):
        _within(lambda i=i: tt.step(_batch(i)))
    assert tt._cross_driver.busy
    _within(lambda: tt.load_state_dict(copy.deepcopy(snap)))
    assert not tt._cross_driver.busy
    _same_state(_snapshot(tt), snap)
    _within(lambda: tt.step(_batch(5)))
    _within(lambda: tt.step(_batch(6)))
    ref = _trainer(jparams, monkeypatch, ROUTES["monolithic"])
    ref.load_state_dict(copy.deepcopy(snap))
    ref.step(_batch(5))
    ref.step(_batch(6))
    _same_state(_snapshot(tt), _snapshot(ref))


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_a_step_failure_rolls_the_epoch_back(where, jparams, monkeypatch):
    """A step that fails in its forward (nothing fed) or mid-backward (some
    buckets already pushed) raises, rolls the epoch back, and the next
    steps run (bounded) to the weights of a run without it."""
    fail = {"on": False}

    def loss_fn(m, b):
        if fail["on"] and where == "forward":
            raise RuntimeError("injected forward failure")
        return _loss(m, b)

    tt = _trainer(jparams, monkeypatch, loss_fn=loss_fn)

    def boom(g):
        if fail["on"]:
            raise RuntimeError("injected backward failure")
        return g

    # the token embedding's gradient lands last: by then the blocks'
    # groups were fed
    tt._model.embed.tok.register_hook(boom)
    for i in (0, 1):
        _within(lambda i=i: tt.step(_batch(i)))
    fail["on"] = True
    with pytest.raises(RuntimeError, match=f"injected {where} failure"):
        _within(lambda: tt.step(_batch(9)))
    fail["on"] = False
    e = tt._cross_driver._epoch
    for i in (2, 3):
        _within(lambda i=i: tt.step(_batch(i)))
    assert tt._cross_driver._epoch == e + 2
    _within(tt.drain)
    ref_tt = _trainer(jparams, monkeypatch, ROUTES["monolithic"])
    for i in range(4):
        ref_tt.step(_batch(i))
    _same_state(_snapshot(tt), _snapshot(ref_tt))


def test_state_dict_round_trips_on_the_collective_path(jparams,
                                                       monkeypatch):
    """``state_dict`` / ``load_state_dict`` hold the inner optimizer's
    state on the data-parallel path too (no pipeline to drain): a copy
    taken after one step, installed after two more, gives the second and
    third steps' weights again, bit for bit."""
    monkeypatch.delenv("BPS_ENABLE_PS")
    model = tbert.Transformer(_TCFG)
    model.load_state_dict(convert.params_from_jax(jparams))
    tt = DistributedTrainer(_loss, model, adamw(model.parameters(), LR,
                                                eps=EPS), device="cpu")
    assert tt._cross_driver is None and tt.ps_exchange is None
    tt.step(_batch(0))
    snap = _snapshot(tt)
    for i in (1, 2):
        tt.step(_batch(i))
    want = _snapshot(tt)
    tt.load_state_dict(copy.deepcopy(snap))
    _same_state(_snapshot(tt), snap)
    for i in (1, 2):
        tt.step(_batch(i))
    _same_state(_snapshot(tt), want)
    assert tt.step_count == 3
