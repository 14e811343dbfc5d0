"""The port's BERT and DistributedTrainer held against the JAX package on
the CPU.

Weights cross from JAX to the port by name alone
(``convert.params_from_jax(transformer.init_params(PRNGKey(0)))``) and the
batch is the same seeded ``synth_mlm_batch``. The model is BERT at small
width: hidden 64, 2 layers, 4 heads, vocab 128, seq 128. The JAX side runs
``attn_impl="naive"``; the port its flash wrapper, which on the CPU takes
the kernels' plain versions.

Tolerances, with their reasons:
  - fp32 loss 1e-5 relative, grads 1e-4 relative + 1e-6 absolute: the same
    fp32 arithmetic in another summation order;
  - bf16 loss 1e-3 relative: the two frameworks round to bf16 at slightly
    different points (GELU, the attention softmax);
  - trainer params after 3 AdamW steps, 1e-5 absolute (1% of one lr step):
    Adam divides each gradient by its own magnitude, which magnifies the
    summation-order differences of near-zero gradients.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.common import partition as jpartition
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.common import partition as tpartition
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

REPO = Path(__file__).resolve().parent.parent
WIDTH = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=128)
SEQ, MAX_PRED, LR = 128, 25, 1e-3
DP_EPS = 1e-6


# the port's env knobs: other tests in the same worker process may leave
# some set (BPS_NUM_WORKER, BPS_ENABLE_PS, ...), so each test here starts
# without them
_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK",
             "BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", "BPS_COORDINATOR_ADDRESS",
             "DMLC_PS_ROOT_URI", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
             "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC")


@pytest.fixture(autouse=True)
def _port_env_unset(monkeypatch):
    for name in _PORT_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """Full fp32 matmuls (the tolerances below assume them, whatever an
    earlier test in this worker set) and 2 torch threads (the suite runs
    in parallel workers)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _cfgs(dtype="float32"):
    jcfg = jbert.bert_config(dtype=dtype, attn_impl="naive", **WIDTH)
    tcfg = tbert.bert_config(dtype=dtype, **WIDTH)
    return jcfg, tcfg


def _port_model(tcfg, jparams):
    model = tbert.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return model


def _jax_loss(jcfg):
    return lambda p, b: jbert.mlm_loss(p, jcfg, b, max_predictions=MAX_PRED)


def _port_loss(model, batch):
    return tbert.mlm_loss(model, batch, max_predictions=MAX_PRED)


def _batch(seed, rows):
    return tbert.synth_mlm_batch(np.random.RandomState(seed), rows, SEQ,
                                 WIDTH["vocab_size"])


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))


def test_synth_batch_is_the_jax_packages():
    for a, b in zip(_batch(3, 2), jbert.synth_mlm_batch(
            np.random.RandomState(3), 2, SEQ, WIDTH["vocab_size"])):
        np.testing.assert_array_equal(a, b)


def test_params_carry_across_by_name():
    jcfg, tcfg = _cfgs()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    model = _port_model(tcfg, jp)
    back = convert.params_to_jax_layout(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, jp)))
    for (path, a), b in zip(_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        ".".join(k.key for k in p) for p, _ in _leaves(jp))


def test_mlm_loss_and_every_grad_match_jax_fp32():
    jcfg, tcfg = _cfgs("float32")
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    data = _batch(0, 4)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg)(p, data)))(jp)
    model = _port_model(tcfg, jp)
    loss = _port_loss(model, tuple(torch.from_numpy(x) for x in data))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    tg = convert.grads_to_jax_layout(model)
    for (path, a), b in zip(_leaves(jg), jax.tree_util.tree_leaves(tg)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_mlm_loss_matches_jax_bf16():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    data = _batch(0, 4)
    jl = jax.jit(lambda p: _jax_loss(jcfg)(p, data))(jp)
    model = _port_model(tcfg, jp)
    with torch.no_grad():
        loss = _port_loss(model, tuple(torch.from_numpy(x) for x in data))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)


def test_full_head_lm_loss_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    jp = jtr.init_params(jax.random.PRNGKey(1), jcfg)
    data = _batch(1, 2)
    jl = jax.jit(lambda p: jbert.mlm_loss(p, jcfg, data))(jp)
    model = _port_model(tcfg, jp)
    with torch.no_grad():
        loss = tbert.mlm_loss(model, tuple(torch.from_numpy(x) for x in data))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)


def _assert_params_close(jparams, model):
    tp = jax.tree_util.tree_leaves(convert.params_to_jax_layout(model))
    for (path, a), b in zip(_leaves(jparams), tp):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("passes", [1, 2])
def test_trainer_matches_jax_trainer_on_one_device(passes):
    """3 (or 4, accumulating over 2 passes) steps of the port's trainer
    against the JAX trainer on a 1-device mesh — one device, because a
    mean of per-shard MLM means differs from the global mean. The port
    runs with remat on (torch.utils.checkpoint), the JAX side without."""
    jcfg, tcfg = _cfgs("float32")
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(_jax_loss(jcfg), jp, optax.adamw(LR), mesh=mesh,
                    backward_passes_per_step=passes)
    model = _port_model(tcfg, jp)
    tt = DistributedTrainer(_port_loss, model, adamw(model.parameters(), LR),
                            backward_passes_per_step=passes, device="cpu")
    for i in range(3 if passes == 1 else 4):
        data = _batch(i, 4)
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    _assert_params_close(jt.params, tt.model)


_DP_WORKER = textwrap.dedent("""
    import datetime, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    rank, world, store, src, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    bps.init(Config.from_env(worker_id=rank, num_worker=world), device="cpu",
             init_method="file://" + store,
             timeout=datetime.timedelta(seconds=60))
    assert bps.rank() == rank and bps.size() == world
    z = np.load(src)
    cfg = bert.bert_config(dtype="float32", hidden=64, layers=2, heads=4,
                           vocab_size=128, max_seq=128)
    model = bert.Transformer(cfg)
    model.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("p.")})
    tr = DistributedTrainer(
        lambda m, b: bert.mlm_loss(m, b, max_predictions=25), model,
        adamw(model.parameters(), float(z["lr"]), eps=float(z["eps"])),
        device="cpu")
    rows = z["tokens"].shape[1] // world
    losses = []
    for i in range(z["tokens"].shape[0]):
        sl = slice(rank * rows, (rank + 1) * rows)
        losses.append(tr.step((z["tokens"][i, sl], z["targets"][i, sl])).item())
    np.savez(out, losses=np.array(losses), **{
        "p." + k: v.detach().numpy() for k, v in model.state_dict().items()})
    bps.shutdown()
""")


def test_trainer_dp2_gloo_matches_jax_two_device_step(tmp_path):
    """Two worker processes joined over gloo (a FileStore under tmp_path)
    run 3 steps, each on its half of the global batch; the result is held
    against the JAX trainer's step on a 2-device data mesh. Every wait is
    bounded: 60 s for the rendezvous, 120 s for each worker.

    AdamW runs with eps 1e-6 on both sides: the two sides sum the replicas'
    gradients in different orders, and at optax's default eps 1e-8 Adam's
    g / (|g| + eps) turns that rounding noise on gradients near 1e-8 into
    differences of a whole lr step."""
    jcfg, _ = _cfgs("float32")
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    batches = [_batch(10 + i, 4) for i in range(3)]
    src = tmp_path / "inputs.npz"
    np.savez(src, lr=LR, eps=DP_EPS, tokens=np.stack([b[0] for b in batches]),
             targets=np.stack([b[1] for b in batches]),
             **{"p." + k: v.numpy() for k, v in convert.params_from_jax(
                 jax.tree.map(np.asarray, jp)).items()})
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), "2", str(store), str(src),
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
        jt = JaxTrainer(_jax_loss(jcfg), jp, optax.adamw(LR, eps=DP_EPS),
                        mesh=mesh)
        jlosses = [float(jt.step(b)) for b in batches]
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for r, (p, out) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out}"
    results = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for r in results:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
    jflat = {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, jt.params)).items()}
    for name, ref in jflat.items():
        for r in results:
            np.testing.assert_allclose(r["p." + name], ref, rtol=0,
                                       atol=1e-5, err_msg=name)
    # both replicas hold the same weights, bit for bit
    for name in jflat:
        np.testing.assert_array_equal(results[0]["p." + name],
                                      results[1]["p." + name])


@pytest.mark.parametrize("partition_bytes", [256, 4096, 1 << 20])
def test_bucket_plan_is_the_jax_packages(partition_bytes):
    rng = np.random.RandomState(partition_bytes)
    leaves = [(f"l{i}", int(rng.randint(1, 3000)),
               "float32" if rng.rand() < 0.8 else "float16")
              for i in range(12)]
    jb = jpartition.plan_buckets([jpartition.LeafSpec(*x) for x in leaves],
                                 partition_bytes, reverse_order=True)
    tb = tpartition.plan_buckets([tpartition.LeafSpec(*x) for x in leaves],
                                 partition_bytes, reverse_order=True)
    assert [(b.index, b.size, b.dtype, b.priority,
             [tuple(vars(s).values()) for s in b.segments]) for b in tb] == \
        [(b.index, b.size, b.dtype, b.priority,
          [tuple(vars(s).values()) for s in b.segments]) for b in jb]
