"""Shared set-up of the PS route tests (``test_torch_ps_overlap.py``,
``test_torch_ps_overlap_jax.py``): BERT at 2 layers, hidden 128, 4 heads of
32, vocab 512, seq 64, in fp32, 8 buckets of 256 KiB, weights from the JAX
package's ``init_params(PRNGKey(0))``, one trainer per route."""

import threading

import jax
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
import byteps_tpu_torch as bps
from byteps_tpu_torch import convert
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
SEQ, BATCH, MAX_PRED, LR, EPS, STEPS = 64, 4, 10, 1e-3, 1e-6, 3
WAIT = 60.0
README = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
          "ef_type": "vanilla", "momentum_type": "nesterov"}
ROUTES = {"default": {}, "draining": {"BPS_CROSS_STEP": "0"},
          "unstaged": {"BPS_BWD_STAGED": "0"},
          "monolithic": {"BPS_APPLY_CHUNKED": "0"}}
_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
        "DMLC_NUM_WORKER", "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC",
        "BPS_SERVER_ADDRS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
        "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF", "BPS_COMPRESS",
        "BPS_APPLY_CHUNKED", "BPS_BWD_STAGED", "BPS_CROSS_STEP",
        "BPS_BWD_GROUPS")


@pytest.fixture(autouse=True)
def _ps_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_MIN_COMPRESS_BYTES", "0")
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    monkeypatch.setenv("BPS_PARTITION_BYTES", str(256 << 10))   # 8 buckets
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    tdev.reset_probe()
    yield
    bps.shutdown()
    jbps.shutdown()
    tdev.reset_probe()
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


_JCFG = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
_TCFG = tbert.bert_config(dtype="float32", **WIDTH)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray,
                        jtr.init_params(jax.random.PRNGKey(0), _JCFG))


def _batch(i):
    return tbert.synth_mlm_batch(np.random.RandomState(i), BATCH, SEQ,
                                 WIDTH["vocab_size"])


def _loss(m, b):
    return tbert.mlm_loss(m, b, max_predictions=MAX_PRED)


def _within(fn, timeout=WAIT):
    """``fn()`` on a helper thread, bounded: its result, or its error."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:        # noqa: BLE001 — re-raised below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"{fn} still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _trainer(jp, monkeypatch, env=None, codec="none", compression=None,
             loss_fn=_loss, optimizer=None, **kw):
    for k in ("BPS_APPLY_CHUNKED", "BPS_BWD_STAGED", "BPS_CROSS_STEP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BPS_COMPRESS", codec)
    bps.shutdown()
    bps.init(device="cpu")
    model = tbert.Transformer(_TCFG)
    model.load_state_dict(convert.params_from_jax(jp))
    opt = (optimizer or (lambda ps: adamw(ps, LR, eps=EPS)))(
        model.parameters())
    return DistributedTrainer(loss_fn, model, opt, device="cpu",
                              compression=compression, **kw)


def _snapshot(tt):
    """A copy of ``state_dict()`` (the optimizer's load keeps the tensors
    it is given: install copies of a snapshot)."""
    sd = tt.state_dict()
    return {"model": {k: v.clone() for k, v in sd["model"].items()},
            "optimizer": {k: [dict(g) for g in v] if k == "param_groups"
                          else {i: {n: (t.clone() if torch.is_tensor(t)
                                        else t) for n, t in s.items()}
                                for i, s in v.items()}
                          for k, v in sd["optimizer"].items()},
            "step_count": sd["step_count"]}


def _same_state(a, b):
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for n in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][n]),
                               torch.as_tensor(sb[i][n])), (i, n)


def _run(jp, monkeypatch, route, steps=STEPS, **kw):
    tt = _trainer(jp, monkeypatch, ROUTES[route], **kw)
    losses = [_within(lambda i=i: tt.step(_batch(i)).item())
              for i in range(steps)]
    _within(tt.drain)
    return losses, _snapshot(tt), tt


