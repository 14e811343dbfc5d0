"""The port's PS routes against the JAX package's trainer on the CPU.

Set-up as in ``test_torch_ps_overlap.py`` (``_torch_ps_routes.py``). The JAX
trainer runs its streamed tail with ``BPS_BWD_STAGED=0 BPS_CROSS_STEP=0``:
its staged head reads ``jax.core.Var``, which jax 0.9.0 lacks;
``test_torch_ps_overlap.py`` ties the port's staged and cross routes to its
monolithic route bit for bit, and this file ties the routes to the JAX
trainer.

Tolerances, those of ``test_torch_ps_trainer.py`` (its docstring gives the
reasons): losses 1e-5 relative; parameters 1e-5 absolute, every one under
none, all but 1 in 1000 under int8 and fp8, whose codes may flip at a
rounding boundary.

  - 3 steps under none, int8 and fp8: the default route and the monolithic
    one;
  - ``backward_passes_per_step=2`` over 4 micro-steps (the JAX package's
    running mean, ``byteps_tpu/training.py:438-457``): the streamed and the
    monolithic route the same bits, both within the tolerances of the JAX
    trainer.
"""

import jax
import numpy as np
import optax
import pytest

from _torch_ps_routes import (_JCFG, EPS, LR, MAX_PRED, STEPS, _batch,
                              _ps_env, _run, _same_state, jparams)  # noqa: F401
import byteps_tpu as jbps
from byteps_tpu.models import bert as jbert
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert


def _jax_run(jp, monkeypatch, codec, steps=STEPS, k=1):
    monkeypatch.setenv("BPS_COMPRESS", codec)
    monkeypatch.setenv("BPS_BWD_STAGED", "0")
    monkeypatch.setenv("BPS_CROSS_STEP", "0")
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, _JCFG, b,
                                                    max_predictions=MAX_PRED),
                        jp, optax.adamw(LR, eps=EPS), mesh=mesh,
                        backward_passes_per_step=k)
        assert jt._apply_chunked
        losses = [float(jt.step(_batch(i))) for i in range(steps)]
        return losses, jax.tree.map(np.asarray, jt.params)
    finally:
        jbps.shutdown()
        for name in ("BPS_BWD_STAGED", "BPS_CROSS_STEP"):
            monkeypatch.delenv(name)


def _params_close(got, ref, exact):
    a, b = (np.concatenate([x.ravel()
                            for x in jax.tree_util.tree_leaves(v)])
            for v in (got, ref))
    assert a.shape == b.shape
    off = np.count_nonzero(np.abs(a - b) > 1e-5)
    assert off <= (0 if exact else a.size // 1000), off


@pytest.mark.parametrize("codec", ["none", "int8", "fp8_e4m3"])
def test_each_route_matches_the_jax_trainer(codec, jparams, monkeypatch):
    jl, jp_after = _jax_run(jparams, monkeypatch, codec)
    for route in ("default", "monolithic"):
        losses, _, tt = _run(jparams, monkeypatch, route, codec=codec)
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        _params_close(convert.params_to_jax_layout(tt.model), jp_after,
                      exact=codec == "none")


def test_accumulation_in_ps_mode_matches_the_jax_trainer(jparams,
                                                         monkeypatch):
    """``backward_passes_per_step=2`` over 4 micro-steps: the streamed
    route (the staged head off, as in the JAX trainer) and the monolithic
    route the same bits, both the JAX trainer's within the tolerances."""
    jl, jp_after = _jax_run(jparams, monkeypatch, "none", steps=4, k=2)
    runs = {}
    for route in ("default", "monolithic"):
        losses, state, tt = _run(jparams, monkeypatch, route, steps=4,
                                 backward_passes_per_step=2)
        assert tt._cross_driver is None and not tt._staged_route()
        assert tt.step_count == 4
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        _params_close(convert.params_to_jax_layout(tt.model), jp_after,
                      exact=True)
        runs[route] = state
    _same_state(runs["default"], runs["monolithic"])
