"""``byteps_tpu_torch/server/ps_mode.py::AsyncPSWorker`` against the JAX
package's ``AsyncPSWorker`` (``byteps_tpu/server/ps_mode.py:1434-1506``)
through a recording backend: the keys (registry-assigned or the bare
range), the init arrays, every pushed array with its dtype, every pull with
its dtype, byte for byte, under ``BPS_ASYNC_WIRE_DTYPE`` and
``BPS_ASYNC_PULL_DTYPE`` at their defaults and at ``bfloat16``. The JAX
worker takes a pytree, the port's a list in the tree's leaf order; the
port's ``push_delta_tree`` takes torch tensors in the wire dtype, as the
trainer hands them, the JAX one the arrays its jitted subtract makes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.common.naming import NameRegistry as JRegistry
from byteps_tpu.server.ps_mode import AsyncPSWorker as JWorker
from byteps_tpu_torch.common import bf16
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.server.ps_mode import AsyncPSWorker

SHAPES = {"a.bias": (7,), "a.w": (5, 3), "b": (2, 2, 3), "c": ()}


class Recorder:
    """A backend that records every call and serves each pull a pattern
    of its key (as fp32, cast to the pull's dtype)."""

    def __init__(self):
        self.log = []

    def init_key(self, key, nbytes, dtype="float32", init=None):
        self.log.append(("init", key, nbytes, dtype,
                         None if init is None else init.tobytes()))

    def push(self, key, data):
        self.log.append(("push", key, bf16.dtype_name(data),
                         np.ascontiguousarray(data).tobytes()))

    def pull(self, key, out, round=0, timeout_ms=30000):
        name = bf16.dtype_name(out)
        self.log.append(("pull", key, name, out.size, round))
        vals = (np.arange(out.size, dtype=np.float32) * 0.37 + key % 97)
        if name == "bfloat16":
            vals = bf16.narrow(vals)
        else:
            vals = vals.astype(name)
        out.reshape(-1).view(np.uint8)[:] = vals.view(np.uint8)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*s), np.float32)
            for k, s in SHAPES.items()}


def _leaves(tree):
    return [tree[k] for k in sorted(tree)]


@pytest.fixture(params=[(None, None), ("bfloat16", None),
                        ("bfloat16", "bfloat16"), (None, "bfloat16")],
                ids=["fp32", "bf16-wire", "bf16-both", "bf16-pull"])
def dtypes(request, monkeypatch):
    wire, pull = request.param
    for name, v in (("BPS_ASYNC_WIRE_DTYPE", wire),
                    ("BPS_ASYNC_PULL_DTYPE", pull)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    return wire, pull


def _registry(cls):
    reg = cls()
    reg.declare("Gradient.other")      # the model's name is the second
    return reg


def _drive(side, registry, wire):
    """One worker's life: init, pull, push_delta, push_delta_tree, pull."""
    rec = Recorder()
    p0, p1, p2 = _tree(0), _tree(1), _tree(2)
    if side == "jax":
        w = JWorker(rec, p0, name="net", init_store=True,
                    registry=_registry(JRegistry) if registry else None)
        pulled = [w.pull_weights()]
        w.push_delta(p1, p0)
        dt = jnp.dtype(wire) if wire else None
        deltas = jax.tree_util.tree_map(
            lambda a, b: (jnp.subtract(a, b).astype(dt) if dt
                          else jnp.subtract(a, b)), p2, p1)
        w.push_delta_tree(deltas)
        pulled.append(w.pull_weights())
        pulled = [_leaves(t) for t in pulled]
    else:
        w = AsyncPSWorker(rec, _leaves(p0), name="net", init_store=True,
                          registry=_registry(NameRegistry) if registry
                          else None)
        pulled = [w.pull_weights()]
        w.push_delta(_leaves(p1), _leaves(p0))
        deltas = [torch.from_numpy(a) - torch.from_numpy(b)
                  for a, b in zip(_leaves(p2), _leaves(p1))]
        if wire:
            deltas = [d.to(getattr(torch, wire)) for d in deltas]
        w.push_delta_tree(deltas)
        pulled.append(w.pull_weights())
    return w, rec.log, pulled


@pytest.mark.parametrize("registry", [True, False],
                         ids=["registry", "bare-range"])
def test_the_worker_calls_the_backend_as_the_jax_one(dtypes, registry):
    wire, pull = dtypes
    jw, jlog, jpulled = _drive("jax", registry, wire)
    pw, plog, ppulled = _drive("port", registry, wire)
    assert pw.keys == jw.keys
    if registry:
        assert pw.keys[0] == 1 << 16 and pw.keys[3] == (1 << 16) | 3
    else:
        assert pw.keys == [0, 1, 2, 3]
    assert (pw.wire_dtype, pw.pull_dtype) == (jw.wire_dtype, jw.pull_dtype)
    assert plog == jlog
    pushes = [e for e in plog if e[0] == "push"]
    assert len(pushes) == 2 * len(SHAPES)
    assert {e[2] for e in pushes} == {wire or "float32"}
    assert {e[2] for e in plog if e[0] == "pull"} == {pull or "float32"}
    for a_set, b_set in zip(ppulled, jpulled):
        for a, b in zip(a_set, b_set):
            assert a.shape == b.shape and str(a.dtype) == str(b.dtype)
            assert a.tobytes() == np.asarray(b).tobytes()


def test_init_store_is_idempotent_and_optional():
    rec = Recorder()
    leaves = _leaves(_tree(0))
    w = AsyncPSWorker(rec, leaves, init_store=False)
    assert rec.log == []
    w.init_store(leaves)
    w.init_store(leaves)          # the server keeps the first: a no-op there
    assert [e[0] for e in rec.log] == ["init"] * 2 * len(SHAPES)
    assert rec.log[:len(SHAPES)] == rec.log[len(SHAPES):]


def test_a_dtype_typo_fails_at_construction(monkeypatch):
    monkeypatch.setenv("BPS_ASYNC_WIRE_DTYPE", "bfloat61")
    with pytest.raises(TypeError):
        AsyncPSWorker(Recorder(), _leaves(_tree(0)))
    with pytest.raises(TypeError):
        JWorker(Recorder(), _tree(0))


def test_bf16_deltas_cross_as_their_bits():
    """A torch bfloat16 delta reaches the backend as a ``BF16`` array of
    the tensor's own bits, which the JAX worker's ml_dtypes array holds."""
    rec = Recorder()
    x = torch.randn(33) * 1e-3
    w = AsyncPSWorker(rec, [torch.zeros(33)], init_store=False)
    w.push_delta_tree([x.to(torch.bfloat16)])
    (_, _, name, data), = rec.log
    assert name == "bfloat16"
    want = x.numpy().astype(ml_dtypes.bfloat16).tobytes()
    assert data == want
