"""Bounded staleness through the port's PS trainer on the CPU, world 1
(set-up of ``_torch_ps_routes.py``: BERT at 2 layers, hidden 128, fp32,
8 buckets, weights from the JAX package's ``init_params``).

  - K=2 on the draining and the monolithic routes: every round completes
    at world 1, so the run is the K=1 run bit for bit, and within the PS
    trainer tolerances (``test_torch_ps_overlap_jax.py``) of the JAX
    trainer at K=2 (built with ``BPS_BWD_STAGED=0 BPS_CROSS_STEP=0``: its
    staged head reads ``jax.core.Var``, which jax 0.9.0 lacks);
  - K=2 on the default route (the cross-step driver), with step 2's pulls
    held until step 3's forward has begun: the tail of step 2 then lands
    while step 3 computes. Each forward reads every leaf as one whole
    epoch in [e-K, e-1], equal to that epoch's snapshot; no parameter
    changes between the forward's read and the end of its backward (no
    backward can meet a tensor a later apply wrote); the held tail did
    try to apply during that window and waited; no step raises;
  - K=2 with the sharded weight update raises.

The order is scripted with events, each wait bounded; no sleep races a
grace window (there is one worker, so every round completes).
"""

import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_ps_routes import (_JCFG, EPS, LR, MAX_PRED, STEPS, WAIT, _batch,
                              _ps_env, _run, _same_state, _trainer,
                              _within, jparams)  # noqa: F401
import byteps_tpu as jbps
from byteps_tpu.models import bert as jbert
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert

K = 2


def _jax_run(jp, monkeypatch, steps=STEPS):
    monkeypatch.setenv("BPS_COMPRESS", "none")
    monkeypatch.setenv("BPS_BWD_STAGED", "0")
    monkeypatch.setenv("BPS_CROSS_STEP", "0")
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, _JCFG, b,
                                                    max_predictions=MAX_PRED),
                        jp, optax.adamw(LR, eps=EPS), mesh=mesh)
        assert jt._ps_exchange.plane.max_lag == K
        losses = [float(jt.step(_batch(i))) for i in range(steps)]
        return losses, jax.tree.map(np.asarray, jt.params)
    finally:
        jbps.shutdown()
        for name in ("BPS_BWD_STAGED", "BPS_CROSS_STEP"):
            monkeypatch.delenv(name)


@pytest.mark.parametrize("route", ["draining", "monolithic"])
def test_k2_at_world_one_is_k1_and_the_jax_trainers(route, jparams,
                                                     monkeypatch):
    runs = {}
    for lag in (1, K):
        monkeypatch.setenv("BPS_MAX_LAG", str(lag))
        losses, state, tt = _run(jparams, monkeypatch, route)
        be = tt.ps_exchange.backend
        assert tt.ps_exchange.plane.max_lag == lag
        assert (be._stale is None) == (lag == 1)
        runs[lag] = (losses, state, convert.params_to_jax_layout(tt.model))
    assert runs[1][0] == runs[K][0]
    _same_state(runs[1][1], runs[K][1])
    monkeypatch.setenv("BPS_MAX_LAG", str(K))
    jl, jp_after = _jax_run(jparams, monkeypatch)
    np.testing.assert_allclose(runs[K][0], jl, rtol=1e-5)
    a, b = (np.concatenate([x.ravel() for x in
                            jax.tree_util.tree_leaves(v)])
            for v in (runs[K][2], jp_after))
    assert np.count_nonzero(np.abs(a - b) > 1e-5) == 0


class _SpyLock:
    """The driver's compute lock, noting when a tail thread had to wait
    for it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.contended = threading.Event()

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            if threading.current_thread().name.startswith("bps-xstep-tail"):
                self.contended.set()
            self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()


def test_k2_forward_never_reads_a_torn_or_moving_leaf(jparams, monkeypatch):
    monkeypatch.setenv("BPS_MAX_LAG", str(K))
    tt = _trainer(jparams, monkeypatch)
    _within(lambda: tt.step(_batch(0)))          # draining: epoch 0
    drv, chunked = tt._cross_driver, tt._chunked
    assert drv is not None and drv._compute is not None
    spy = drv._compute = _SpyLock()
    params = chunked.params
    snaps = {0: [p.detach().clone() for p in params]}
    mark = chunked.mark_epoch

    def marked(leaf_ids, epoch):
        leaf_ids = list(leaf_ids)
        snap = snaps.setdefault(epoch, [None] * len(params))
        for li in leaf_ids:
            snap[li] = params[li].detach().clone()
        mark(leaf_ids, epoch)

    chunked.mark_epoch = marked
    applied1 = threading.Event()
    apply_group = chunked.apply_group

    def applying(gi, *a, **kw):
        apply_group(gi, *a, **kw)
        if threading.current_thread().name == "bps-xstep-tail-1":
            applied1.set()              # the held tail (epoch 1) applied

    chunked.apply_group = applying
    release = threading.Event()
    be = tt.ps_exchange.backend
    pull_lag = be.pull_lag

    def held_pull(key, worker, rnd, out, timeout_ms=30000):
        if rnd == 2:                   # step 2's round: the tail of e=1
            assert release.wait(WAIT), "step 3's forward never began"
        return pull_lag(key, worker, rnd, out, timeout_ms)

    be.pull_lag = held_pull
    reads = []

    def pre_hook(mod, inputs):
        e = drv._epoch
        if e == 2:
            release.set()
            # the held tail lands its leaves and reaches the lock, which
            # this step holds until its backward ended (without the lock
            # it would apply now, under this step)
            deadline = time.monotonic() + WAIT
            while not (spy.contended.is_set() or applied1.is_set()):
                assert time.monotonic() < deadline, "the tail never applied"
                spy.contended.wait(0.01)
        ready = list(chunked.ready_epoch)
        values = [p.detach().clone() for p in params]
        reads.append((e, ready, values))
        for li, (r, v) in enumerate(zip(ready, values)):
            assert e - K <= r <= e - 1, (e, li, r)
            assert torch.equal(v, snaps[r][li]), (e, li, r)

    handle = tt._model.register_forward_pre_hook(pre_hook)
    staged = tt._staged_backward

    def checked(batch, h, gate=None):
        loss = staged(batch, h, gate)
        _, _, values = reads[-1]
        for li, (p, v) in enumerate(zip(params, values)):
            assert torch.equal(p.detach(), v), f"leaf {li} moved in step"
        return loss

    tt._staged_backward = checked
    try:
        losses = [_within(lambda i=i: tt.step(_batch(i)).item())
                  for i in range(1, 5)]
        _within(tt.drain)
    finally:
        handle.remove()
        release.set()
    assert np.isfinite(losses).all()
    assert spy.contended.is_set()
    assert applied1.is_set()
    assert [e for e, _, _ in reads] == [1, 2, 3, 4]
    # step 3 read epoch 0 throughout: the tail of step 2 was still held
    assert set(reads[1][1]) == {0}
    assert sorted(snaps) == [0, 1, 2, 3, 4]
    for li, p in enumerate(params):
        assert torch.equal(p.detach(), snaps[4][li])


def test_k2_with_the_sharded_update_raises(jparams, monkeypatch):
    monkeypatch.setenv("BPS_MAX_LAG", str(K))
    monkeypatch.setenv("BPS_SHARDED_UPDATE", "1")
    with pytest.raises(NotImplementedError,
                       match=r"BPS_MAX_LAG=2 with BPS_SHARDED_UPDATE=1.*"
                             r"queue 1, item 6"):
        _trainer(jparams, monkeypatch)
