"""The port's full-tree checkpoints (``byteps_tpu_torch/checkpoint.py``): the
counterparts of ``tests/test_checkpoint.py:30-60``. A save, then 3 steps,
equals a restore into a fresh trainer built from other weights, then the
same 3 steps, bit for bit in every loss, parameter and optimizer-state
tensor (a toy model and BERT-tiny through ``DistributedTrainer``, dense and
on the PS path, whose ``state_dict()`` drains the cross-step tails); the
registry rides along; ``bps_meta.json`` is byte for byte the JAX package's
for the same step and declarations. The sharded checkpoints are in
``test_torch_sharded_checkpoint.py``.

Tolerance: none (the same fp32 state into the same computation).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu import checkpoint as jckpt
from byteps_tpu.common.naming import NameRegistry as JRegistry
from byteps_tpu_torch import checkpoint as ckpt
from byteps_tpu_torch.common.global_state import GlobalState
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

WIDTH = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=64)
_ENV = ("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS", "BPS_ENABLE_ASYNC",
        "BPS_NUM_WORKER", "DMLC_NUM_WORKER", "BPS_SERVER_ADDRS",
        "BPS_COMPRESS", "BPS_MAX_LAG", "BPS_SHARDED_UPDATE")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    bps.shutdown()
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _toy(seed):
    """The JAX test's problem: a 4 -> 1 linear fit under Adam(0.05)."""
    W = np.random.RandomState(0).randn(4, 1).astype(np.float32)
    x = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    batch = (torch.from_numpy(x), torch.from_numpy(x @ W))
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 1, bias=False)
    opt = torch.optim.Adam(model.parameters(), 0.05)
    tr = DistributedTrainer(
        lambda m, b: torch.mean((m(b[0]) - b[1]) ** 2), model, opt,
        device="cpu")
    return tr, [batch] * 5


def _bert(seed):
    cfg = tbert.bert_config(dtype="float32", **WIDTH)
    model = tbert.Transformer(cfg, generator=torch.Generator()
                              .manual_seed(seed))
    tr = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=10), model,
        adamw(model.parameters(), 1e-3, eps=1e-6), device="cpu")
    batches = [tbert.synth_mlm_batch(np.random.RandomState(s), 2, 64,
                                     WIDTH["vocab_size"]) for s in range(5)]
    return tr, batches


def _state_bytes(state):
    """Every tensor of a ``state_dict()`` tree, by path, as bytes."""
    out = {}

    def walk(x, path):
        if torch.is_tensor(x):
            out[path] = (x.dtype, tuple(x.shape), x.detach().cpu().numpy()
                         .tobytes())
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
    walk(state, "")
    return out


CASES = {"toy": (_toy, {}), "bert_tiny": (_bert, {}),
         "bert_tiny_ps": (_bert, {"BPS_ENABLE_PS": "1"})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_restore_then_three_steps_is_the_saved_run_bit_for_bit(
        case, tmp_path, monkeypatch):
    make, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bps.init(device="cpu")
    tr, batches = make(0)
    for b in batches[:2]:
        tr.step(b)
    st = tr.state_dict()
    ckpt.save_checkpoint(str(tmp_path / "ck"), st["model"], st["optimizer"],
                         step=st["step_count"],
                         registry=GlobalState.get().registry)
    saved = _state_bytes({"model": st["model"], "optimizer": st["optimizer"]})
    names = GlobalState.get().registry.declared_names()
    ref = [tr.step(b).item() for b in batches[2:]]
    final = _state_bytes(tr.state_dict())
    tr.close()
    if env:                 # a fresh PS server: the rounds start again
        bps.shutdown()
        bps.init(device="cpu")
    tr2, _ = make(1)        # other weights: a restore that did nothing fails
    fresh = tr2.state_dict()
    assert _state_bytes(fresh["model"]) != _state_bytes(st["model"])
    params, opt, step, declared = ckpt.restore_checkpoint(
        str(tmp_path / "ck"), fresh["model"], fresh["optimizer"])
    tr2.load_state_dict({"model": params, "optimizer": opt,
                         "step_count": step})
    assert step == tr2.step_count == 2
    again = tr2.state_dict()
    assert _state_bytes({"model": again["model"],
                         "optimizer": again["optimizer"]}) == saved
    got = [tr2.step(b).item() for b in batches[2:]]
    assert got == ref
    assert _state_bytes(tr2.state_dict()) == final
    assert [d["name"] for d in declared] == names
    assert bool(names) == bool(env)     # the PS exchange declares its keys
    tr2.close()


def test_the_registry_rides_along(tmp_path):
    bps.init(device="cpu")
    bps.declare_tensor("grad_a", priority=3)
    bps.declare_tensor("grad_b")
    reg = GlobalState.get().registry
    ckpt.save_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(2)},
                         registry=reg)
    _, opt, step, declared = ckpt.restore_checkpoint(str(tmp_path / "ck"),
                                                     {"w": torch.ones(2)})
    assert opt is None and step == 0
    names = [d["name"] for d in declared]
    assert names == ["grad_a", "grad_b"]
    assert {d["name"]: d for d in declared}["grad_a"]["priority"] == 3


@pytest.mark.parametrize("with_registry", [True, False])
def test_the_meta_file_is_the_jax_packages_byte_for_byte(with_registry,
                                                         tmp_path):
    regs = []
    for cls in (NameRegistry, JRegistry):
        r = cls()
        r.declare("embed.tok", priority=5)
        r.declare("block0.attn", compressor_type="onebit", ef_type="vanilla")
        r.declare("final_ln", priority=-9)
        regs.append(r if with_registry else None)
    ckpt.save_checkpoint(str(tmp_path / "port"), {"w": torch.zeros(2)},
                         step=41, registry=regs[0])
    jckpt.save_checkpoint(str(tmp_path / "jax"), {"w": jnp.zeros(2)},
                          step=41, registry=regs[1])
    mine = (tmp_path / "port" / "bps_meta.json").read_bytes()
    assert mine == (tmp_path / "jax" / "bps_meta.json").read_bytes()
    assert set(json.loads(mine)) == ({"step", "declared"} if with_registry
                                     else {"step"})
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "bps_meta.json", "state.pt"]


def test_a_restore_checks_the_templates_and_places_the_tensors(tmp_path):
    w, b = torch.arange(6.0).reshape(2, 3), torch.ones(3)
    ckpt.save_checkpoint(str(tmp_path / "ck"), {"w": w, "b": b},
                         {"state": {0: {"m": w * 2}}, "groups": [0.1]},
                         step=3)
    params, opt, step, declared = ckpt.restore_checkpoint(
        str(tmp_path / "ck"), {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
        {"state": {}, "groups": [0.5]})
    assert torch.equal(params["w"], w) and torch.equal(params["b"], b)
    assert params["w"].device.type == "cpu"
    assert torch.equal(opt["state"][0]["m"], w * 2) and opt["groups"] == [0.1]
    assert (step, declared) == (3, [])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path / "ck"),
                                {"w": torch.zeros(3, 2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="only one of"):
        ckpt.restore_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(2, 3)})
