"""The port's BytePS API at world 2 over gloo on the CPU, held against the
JAX package's ``push_pull`` on a two-device mesh.

Each rank (``_torch_api_worker.py``, mode "api") passes its own row of
the same seeded arrays; the JAX engine takes both rows stacked. Sums of
two values and their halves do not depend on the order of the addends,
so every result is held bit for bit: ``push_pull`` with average on and
off, three async handles in flight, the same under
``BPS_SCHEDULING_CREDIT=4096`` (where dispatch must have waited), plugin
dispatches whose priorities differ between the ranks, and the broadcasts
from root 1. Every wait is bounded (60 s rendezvous, 120 s a world);
every process is reaped.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_api_worker import Ranks
import byteps_tpu as jbps
from byteps_tpu.parallel.mesh import make_mesh

SHAPES = {"a": (300, 97), "b": (40000,), "c": (17, 33), "d": (5,),
          "e": (128, 64)}


def _rows():
    rng = np.random.RandomState(11)
    return {k: (rng.randn(2, *s) * (i + 1)).astype(np.float32)
            for i, (k, s) in enumerate(SHAPES.items())}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api_gloo")
    src = tmp / "api.npz"
    np.savez(src, **{f"tree.{k}": v for k, v in _rows().items()})
    w = Ranks("api", 2, src, tmp)
    yield w
    w.close()


@pytest.fixture(scope="module")
def jax_ref():
    """JAX push_pull of the two rows stacked on a two-device mesh."""
    jbps.init(mesh=make_mesh({"data": 2}, devices=jax.devices()[:2]))
    try:
        rows = _rows()
        return {avg: {k: np.asarray(v) for k, v in
                      jbps.push_pull(rows, average=avg).items()}
                for avg in (True, False)}
    finally:
        jbps.shutdown()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tag,avg", [("mean", True), ("sum", False),
                                     ("credit", True)])
def test_push_pull_is_the_jax_push_pull(world, jax_ref, tag, avg):
    res = world.result()
    for r, out in enumerate(res):
        for k in SHAPES:
            _same(out[f"{tag}['{k}']"], jax_ref[avg][k][r])


def test_three_async_handles_in_flight(world, jax_ref):
    for out in world.result():
        for i, avg in enumerate((True, False, True)):
            for k in SHAPES:
                _same(out[f"async{i}['{k}']"], jax_ref[avg][k][0])


def test_plugin_dispatches_with_different_priorities_complete(world, jax_ref):
    for out in world.result():
        for k in SHAPES:
            _same(out[f"prio.{k}"], jax_ref[False][k][0])


def test_scheduling_credit_waits_and_keeps_the_results(world, jax_ref):
    res = world.result()
    for out in res:
        assert int(out["credit_waits"]) > 0
        for k in SHAPES:
            _same(out[f"credit_plugin.{k}"], jax_ref[True][k][0])


def test_broadcast_parameters_from_root_one(world):
    rows = _rows()
    for out in world.result():
        for k in SHAPES:
            _same(out[f"bcast['{k}']"], rows[k][1])
            _same(out[f"pbcast['{k}']"], rows[k][1])


def test_broadcast_optimizer_state_from_root_one(world):
    res = world.result()
    fresh = sorted(k for k in res[1] if k.startswith("fresh."))
    assert fresh and fresh == sorted(k for k in res[0]
                                     if k.startswith("fresh."))
    root = sorted(k for k in res[1] if k.startswith("root_state."))
    assert root
    for k in fresh:
        _same(res[0][k], res[1][k])
    for k in root:
        _same(res[0]["stepped." + k[11:]], res[1][k])
        _same(res[1]["stepped." + k[11:]], res[1][k])
    for r, out in enumerate(res):
        # the zero-gradient step that made the state left the weights
        torch.manual_seed(r)
        lin = torch.nn.Linear(5, 3)
        _same(out["fresh_params"], np.concatenate(
            [p.detach().numpy().ravel() for p in lin.parameters()]))
