"""The port's GPT-2 and its compressed DistributedTrainer held against the
JAX package on the CPU.

Weights cross from JAX to the port by name alone
(``convert.params_from_jax(transformer.init_params(PRNGKey(0)))``) and the
batch is the same seeded ``synth_lm_batch``. The fp32 model is
``gpt2_tiny`` (hidden 64, 2 layers, 4 heads, vocab 128, seq 64); the JAX
side runs ``attn_impl="naive"``, the port its flash wrapper, which on the
CPU takes the kernels' plain versions. The bf16 case runs at the GPT-2
context of 1024 (hidden 128, 2 heads of 64, 2 layers), where both sides
take the split flash backward: the JAX one its Pallas kernels in
interpret mode.

Compression runs the README's kwargs: onebit with the L1-mean scale,
vanilla error feedback and Nesterov momentum.

Tolerances, with their reasons:
  - fp32 loss 1e-5 relative, grads 1e-4 relative + 1e-6 absolute: the same
    fp32 arithmetic in another summation order;
  - bf16 at seq 1024: loss 1e-3 relative, each gradient leaf max |port -
    jax| <= 3e-2 · max |jax|. The two frameworks round to bf16 at slightly
    different points (GELU, the softmax around the kernels), and a
    gradient sums many values that are each one bf16 step apart (largest
    seen: 1.5e-2, on ``mlp_in_b``);
  - trainer params after 3 AdamW steps, 1e-5 absolute (1% of one lr
    step) for all but 1 in 1000 elements of each leaf: Adam divides each
    gradient by its own magnitude, which magnifies the summation-order
    differences of near-zero gradients. On compressed buckets the two
    sides pack the same sign bits, and so take the same ±lr step, except
    where the value compressed lies within rounding of zero: there the
    sign may differ, and the element (at most 1 in 1000, seen: 1 in 8192)
    may be off by up to two lr steps a step.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import flops as jflops
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import flops as tflops
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.optim import DistributedOptimizer, adamw
from byteps_tpu_torch.training import DistributedTrainer

REPO = Path(__file__).resolve().parent.parent
SEQ, LR, DP_EPS = 64, 1e-3, 1e-6
README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov"}
# small enough that the tiny model's plan holds compressed buckets and
# plain-sum ones side by side
PARTITION, MIN_COMPRESS = 16384, 8192

_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK",
             "BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", "BPS_COORDINATOR_ADDRESS",
             "DMLC_PS_ROOT_URI", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
             "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC", "BPS_FLASH_BQ",
             "BPS_FLASH_BK", "BPS_FLASH_FUSED_BWD")


@pytest.fixture(autouse=True)
def _port_env_unset(monkeypatch):
    for name in _PORT_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(autouse=True)
def _cpu_numerics():
    """Full fp32 matmuls and 2 torch threads (the suite runs in parallel
    workers)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _tiny():
    return jgpt2.gpt2_tiny(attn_impl="naive"), tgpt2.gpt2_tiny()


def _port_model(tcfg, jparams):
    model = tgpt2.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return model


def _jax_loss(jcfg):
    return lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b)


def _batch(seed, rows, seq=SEQ, vocab=128):
    return tgpt2.synth_lm_batch(np.random.RandomState(seed), rows, seq, vocab)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------------ model

def test_synth_lm_batch_is_the_jax_packages():
    np.testing.assert_array_equal(
        _batch(3, 2), jgpt2.synth_lm_batch(np.random.RandomState(3), 2, SEQ,
                                           128))


@pytest.mark.parametrize("name", ["gpt2_medium", "gpt2_small", "gpt2_tiny"])
def test_configs_are_the_jax_packages(name):
    jc, tc = getattr(jgpt2, name)(), getattr(tgpt2, name)()
    shared = {f.name for f in dataclasses.fields(tc)} & \
        {f.name for f in dataclasses.fields(jc)}
    assert {"hidden", "layers", "heads", "mlp_dim", "vocab_size", "max_seq",
            "causal", "dtype", "remat"} <= shared
    for f in sorted(shared):
        assert getattr(tc, f) == getattr(jc, f), f


def test_gpt2_medium_train_flops_are_the_jax_packages():
    """The causal model counts its full score square, as the JAX
    package's ``models/flops.py`` does."""
    for seq in (512, 1024):
        assert tflops.transformer_train_flops_per_sample(
            tgpt2.gpt2_medium(), seq) == \
            jflops.transformer_train_flops_per_sample(jgpt2.gpt2_medium(), seq)


def test_params_carry_across_by_name():
    jcfg, tcfg = _tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    model = _port_model(tcfg, jp)
    back = convert.params_to_jax_layout(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, jp)))
    for (path, a), b in zip(_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_causal_lm_loss_and_every_grad_match_jax_fp32():
    jcfg, tcfg = _tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    data = _batch(0, 4)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg)(p, data)))(jp)
    model = _port_model(tcfg, jp)
    loss = tgpt2.causal_lm_loss(model, torch.from_numpy(data))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    tg = convert.grads_to_jax_layout(model)
    for (path, a), b in zip(_leaves(jg), jax.tree_util.tree_leaves(tg)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_last_target_is_masked_not_shifted(monkeypatch):
    """The full sequence stays the input (s a multiple of the attention
    block); the last position's prediction is not scored."""
    _, tcfg = _tiny()
    tokens = torch.from_numpy(_batch(5, 2))
    seen = {}

    def spy(m, batch):
        seen["tokens"], seen["targets"] = batch
        return torch.zeros(())
    monkeypatch.setattr(tgpt2, "lm_loss", spy)
    tgpt2.causal_lm_loss(tgpt2.Transformer(tcfg), tokens)
    assert seen["tokens"].shape == (2, SEQ)
    assert torch.equal(seen["targets"][:, :-1], tokens[:, 1:])
    assert (seen["targets"][:, -1] == -1).all()


def test_seq1024_bf16_split_route_matches_jax_flash_interpret(monkeypatch):
    """Loss and every gradient at the GPT-2 context, both sides through
    the split flash backward (two 512 blocks each way)."""
    kw = dict(hidden=128, layers=2, heads=2, vocab_size=128, max_seq=1024,
              dtype="bfloat16")
    jcfg = jgpt2.gpt2_config(attn_impl="flash", **kw)
    tcfg = tgpt2.gpt2_config(**kw)
    orig = jfa.flash_attention

    def interpret(q, k, v, causal=False, scale=None, **_):
        return orig(q, k, v, causal, scale, 512, 512, True)

    def no_fused(*a, **k):
        raise AssertionError("the JAX backward took the fused kernel")
    monkeypatch.setattr(jfa, "flash_attention", interpret)
    monkeypatch.setattr(jfa, "_flash_bwd_fused", no_fused)
    calls = []
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        fn = getattr(tfa, name)

        def rec(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tfa, name, rec)

    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    data = _batch(6, 1, seq=1024)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg)(p, data)))(jp)
    model = _port_model(tcfg, jp)
    loss = tgpt2.causal_lm_loss(model, torch.from_numpy(data))
    loss.backward()
    assert sorted(set(calls)) == ["flash_bwd_dkv", "flash_bwd_dq"]
    assert calls.count("flash_bwd_dq") == kw["layers"]
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-3)
    tg = convert.grads_to_jax_layout(model)
    for (path, a), b in zip(_leaves(jg), jax.tree_util.tree_leaves(tg)):
        err = np.abs(b - a).max()
        assert err <= 3e-2 * np.abs(a).max(), \
            f"{jax.tree_util.keystr(path)}: max err {err}"


# ---------------------------------------------------------- compression

def _assert_params_close(ref, got, steps=3):
    """``got`` and ``ref``: {name: array}. All but 1 in 1000 elements of a
    leaf within 1e-5; the rest within two lr steps a step. Those are the
    sign flips: an element whose compressed value lies within rounding of
    zero can pack its sign differently on the two sides."""
    for name, a in ref.items():
        diff = np.abs(got[name] - a)
        off = int((diff > 1e-5).sum())
        assert off <= a.size // 1000 and diff.max() <= 2 * LR * steps, \
            f"{name}: {off} of {a.size} elements off, max {diff.max()}"


def _flat(tree):
    return {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def test_compressed_trainer_matches_jax_trainer_on_one_device():
    """3 steps under the README's compression at world 1: the JAX trainer
    keeps the size-1 data axis on this lossy path, so compression, error
    feedback and momentum shape its gradient; the port's must too."""
    jcfg, tcfg = _tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(_jax_loss(jcfg), jp, optax.adamw(LR), mesh=mesh,
                    partition_bytes=PARTITION, compression=README_KW,
                    min_compress_bytes=MIN_COMPRESS)
    model = _port_model(tcfg, jp)
    tt = DistributedTrainer(tgpt2.causal_lm_loss, model,
                            adamw(model.parameters(), LR),
                            partition_bytes=PARTITION, compression=README_KW,
                            min_compress_bytes=MIN_COMPRESS, device="cpu")
    plan = tt.tx.plan
    assert 0 < plan.n_compressed < len(plan.buckets)
    for i in range(3):
        data = _batch(i, 4)
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    _assert_params_close(_flat(jt.params), {
        k: v.detach().numpy() for k, v in tt.model.state_dict().items()})


class _GradSnapshot(torch.optim.SGD):
    """lr 0: records the gradients it is handed and changes nothing."""

    def __init__(self, params):
        super().__init__(params, lr=0.0)
        self.seen = None

    def step(self, closure=None):
        self.seen = [p.grad.clone() for g in self.param_groups
                     for p in g["params"]]


def test_world_one_compressed_gradient_is_not_the_dense_one():
    """At world 1 the dense path skips its reduction, but the compressed
    one must still compress: a compressed bucket hands the optimizer
    ±scale, a plain-sum bucket the raw gradient."""
    _, tcfg = _tiny()
    data = torch.from_numpy(_batch(7, 4))
    seen = {}
    for mode in ("dense", "onebit"):
        model = tgpt2.Transformer(tcfg)
        opt = _GradSnapshot(model.parameters())
        tx = DistributedOptimizer(
            opt, named_parameters=model.named_parameters(),
            partition_bytes=PARTITION,
            compression=README_KW if mode == "onebit" else None,
            min_compress_bytes=MIN_COMPRESS)
        tgpt2.causal_lm_loss(model, data).backward()
        tx.step()
        seen[mode] = (opt.seen, tx)
    dense, (comp, tx) = seen["dense"][0], seen["onebit"]
    plan, order = tx.plan, tx._order

    def bucket(grads, b):
        return torch.cat([grads[order[s.leaf_index]].reshape(-1)[
            s.leaf_offset:s.leaf_offset + s.length] for s in b.segments])

    kinds = set()
    for b, c in zip(plan.buckets, plan.compressors):
        got, ref = bucket(comp, b), bucket(dense, b)
        if c is None:
            assert torch.equal(got, ref), b.index
        else:
            # what a compressed bucket hands on is ±(its one scale)
            assert got.abs().unique().numel() == 1, b.index
            assert not torch.equal(got, ref), b.index
        kinds.add(c is None)
    assert kinds == {True, False}


_DP_WORKER = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    rank, world, store, src, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.models import gpt2
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    bps.init(Config.from_env(worker_id=rank, num_worker=world), device="cpu",
             init_method="file://" + store,
             timeout=datetime.timedelta(seconds=60))
    z = np.load(src)
    model = gpt2.Transformer(gpt2.gpt2_tiny())
    model.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files
                           if k.startswith("p.")})
    tr = DistributedTrainer(
        gpt2.causal_lm_loss, model,
        adamw(model.parameters(), float(z["lr"]), eps=float(z["eps"])),
        partition_bytes=int(z["partition"]),
        compression=json.loads(str(z["kwargs"])),
        min_compress_bytes=int(z["min_compress"]), device="cpu")
    rows = z["tokens"].shape[1] // world
    losses = []
    for i in range(z["tokens"].shape[0]):
        losses.append(tr.step(z["tokens"][i, rank * rows:(rank + 1) * rows])
                      .item())
    np.savez(out, losses=np.array(losses), **{
        "p." + k: v.detach().numpy() for k, v in model.state_dict().items()})
    bps.shutdown()
""")


def test_compressed_trainer_dp2_gloo_matches_jax_two_device_step(tmp_path):
    """Two worker processes joined over gloo (a FileStore under tmp_path)
    run 3 compressed steps, each on its half of the global batch, and are
    held against the JAX trainer on a 2-device data mesh: every replica
    all-gathers the others' packed signs and scales and decompress-sums
    them. Every wait is bounded: 60 s for the rendezvous, 120 s for each
    worker. AdamW eps 1e-6 on both sides, as in the dense two-process
    test of ``test_torch_bert.py``, for the plain-sum buckets."""
    import json
    jcfg, _ = _tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    batches = [_batch(20 + i, 4) for i in range(3)]
    src = tmp_path / "inputs.npz"
    np.savez(src, lr=LR, eps=DP_EPS, partition=PARTITION,
             min_compress=MIN_COMPRESS, kwargs=json.dumps(README_KW),
             tokens=np.stack(batches),
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
                        mesh=mesh, partition_bytes=PARTITION,
                        compression=README_KW,
                        min_compress_bytes=MIN_COMPRESS)
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
    jflat = _flat(jt.params)
    for r in results:
        _assert_params_close(jflat, {k: r["p." + k] for k in jflat})
    # both replicas hold the same weights, bit for bit
    for name in jflat:
        np.testing.assert_array_equal(results[0]["p." + name],
                                      results[1]["p." + name])
