"""The port's T5 seq2seq model and its DistributedTrainer held against the
JAX package on the CPU.

Weights cross from JAX to the port by name alone
(``convert.params_from_jax(t5.init_t5_params(PRNGKey(0)))``) and the batch
is the same seeded ``synth_seq2seq_batch``. The model is ``t5_tiny``
(hidden 64, 2 + 2 layers, 4 heads of 16, vocab 128) in fp32: source 64,
target 33 (so the decoder sees 32). On the CPU the JAX dispatcher takes
its naive route, which materializes each stack's table through
``relative_bias``; the port takes its flash wrapper, whose plain versions
add the table entry of each score's bucket (the table form), and its
cross-attention has no bias.

Tolerances, with their reasons:
  - fp32 loss 1e-5 relative, every gradient leaf 1e-4 relative + 1e-6
    absolute: the same fp32 arithmetic in another summation order;
  - bf16 loss 2e-3 relative: the two frameworks round to bf16 at slightly
    different points (GELU, the softmax around attention);
  - trainer params after 3 AdamW steps (eps 1e-6 on both sides, as the
    other trainer parity tests run it): 1e-5 absolute, 1% of one lr step.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import t5 as jt5
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import t5 as tt5
from byteps_tpu_torch.ops import flash_attention as tfa
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

SRC, TGT, LR, EPS = 64, 33, 1e-3, 1e-6
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


def _cfgs(pos="relative", dtype="float32"):
    return (jt5.t5_tiny(dtype=dtype, pos_encoding=pos),
            tt5.t5_tiny(dtype=dtype, pos_encoding=pos))


def _port_model(tcfg, jparams):
    model = tt5.T5(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return model


def _batch(seed, rows=2, src=SRC, tgt=TGT):
    return tt5.synth_seq2seq_batch(np.random.RandomState(seed), rows, src,
                                   tgt, 128)


def _torch_batch(data):
    return tuple(torch.from_numpy(x) for x in data)


def _jax_loss(jcfg):
    return lambda p, b: jt5.seq2seq_loss(p, jcfg, b)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", ["t5_small", "t5_tiny"])
def test_configs_are_the_jax_packages(name):
    jc, tc = getattr(jt5, name)(), getattr(tt5, name)()
    fields = {f.name for f in dataclasses.fields(jc)}
    assert fields == {f.name for f in dataclasses.fields(tc)}
    for f in sorted(fields):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.head_dim == jc.head_dim and tc.relative == jc.relative


def test_t5_small_is_the_published_geometry():
    c = tt5.t5_small()
    assert (c.hidden, c.enc_layers, c.dec_layers, c.heads, c.head_dim,
            c.mlp_dim, c.vocab_size) == (512, 6, 6, 8, 64, 2048, 32000)
    assert (c.pos_encoding, c.rel_buckets, c.rel_max_distance, c.dtype,
            c.remat) == ("relative", 32, 128, "bfloat16", True)


def test_synth_seq2seq_batch_is_the_jax_packages():
    for a, b in zip(_batch(3), jt5.synth_seq2seq_batch(
            np.random.RandomState(3), 2, SRC, TGT, 128)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pos", ["relative", "absolute"])
def test_params_carry_across_by_name(pos):
    jcfg, tcfg = _cfgs(pos)
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg)
    model = _port_model(tcfg, jp)
    back = convert.params_to_jax_layout(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, jp)))
    for (path, a), b in zip(_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    # the port's own init draws the same tree
    own = convert.params_to_jax_layout(tt5.T5(tcfg))
    assert (jax.tree_util.tree_structure(own)
            == jax.tree_util.tree_structure(back))


@pytest.mark.parametrize("pos", ["relative", "absolute"])
def test_seq2seq_loss_and_every_grad_match_jax_fp32(pos):
    """Loss and every gradient leaf, the two stacks' rel tables included,
    against ``jax.grad`` of the JAX ``seq2seq_loss``."""
    jcfg, tcfg = _cfgs(pos)
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg)
    data = _batch(0)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jcfg)(p, data)))(jp)
    model = _port_model(tcfg, jp)
    loss = tt5.seq2seq_loss(model, _torch_batch(data))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    tg = convert.grads_to_jax_layout(model)
    for (path, a), b in zip(_leaves(jg), jax.tree_util.tree_leaves(tg)):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    if pos == "relative":
        for name in ("enc_rel_bias", "dec_rel_bias"):
            assert np.abs(tg[name]).max() > 0, name


def test_seq2seq_loss_matches_jax_bf16():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = jt5.init_t5_params(jax.random.PRNGKey(1), jcfg)
    data = _batch(1)
    jl = jax.jit(lambda p: _jax_loss(jcfg)(p, data))(jp)
    loss = tt5.seq2seq_loss(_port_model(tcfg, jp), _torch_batch(data))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-3)


def test_naive_and_flash_routes_give_the_same_loss():
    """``attn_impl="naive"`` (the table materialized, plain softmax) and the
    flash route's plain versions (the table form) in the port."""
    _, tcfg = _cfgs()
    data = _torch_batch(_batch(2))
    flash = tt5.T5(tcfg)
    naive = tt5.T5(dataclasses.replace(tcfg, attn_impl="naive"))
    naive.load_state_dict(flash.state_dict())
    np.testing.assert_allclose(tt5.seq2seq_loss(flash, data).item(),
                               tt5.seq2seq_loss(naive, data).item(),
                               rtol=1e-6)


def test_attention_takes_the_table_form_and_cross_attention_none(
        monkeypatch):
    """Which kernel and form each attention call reaches, through a train
    step with remat (each layer's forward runs twice): the self-attention
    of both stacks the table form, bidirectional in the encoder and causal
    in the decoder, every backward the split route; cross-attention no
    bias. The source spans two blocks of 64 here (``BPS_FLASH_BK``), as
    T5-small's 1024-token source spans two of 512, so cross-attention too
    takes the split backward."""
    monkeypatch.setenv("BPS_FLASH_BQ", "64")
    monkeypatch.setenv("BPS_FLASH_BK", "64")
    jcfg, tcfg = _cfgs()
    seen = []
    for name in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv"):
        orig = getattr(tfa, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            args = inspect.signature(_orig).bind(*a, **kw)
            args.apply_defaults()
            args = args.arguments
            form = "none"
            if args.get("bias") is not None:
                form = "bias"
            elif args.get("rel_table") is not None:
                form = "rel-" + ("bidir" if args["rel_bidirectional"]
                                 else "causal")
            seen.append((_name, form, args["q"].shape[1],
                         args["k"].shape[1]))
            return _orig(*a, **kw)
        monkeypatch.setattr(tfa, name, rec)
    model = tt5.T5(tcfg)
    tt5.seq2seq_loss(model, _torch_batch(_batch(4, src=128, tgt=65))
                     ).backward()
    n_enc, n_dec = tcfg.enc_layers, tcfg.dec_layers
    counts = {}
    for key in seen:
        counts[key] = counts.get(key, 0) + 1
    assert counts == {
        ("flash_fwd", "rel-bidir", 128, 128): 2 * n_enc,
        ("flash_fwd", "rel-causal", 64, 64): 2 * n_dec,
        ("flash_fwd", "none", 64, 128): 2 * n_dec,
        ("flash_bwd_dq", "rel-bidir", 128, 128): n_enc,
        ("flash_bwd_dkv", "rel-bidir", 128, 128): n_enc,
        ("flash_bwd_dq", "rel-causal", 64, 64): n_dec,
        ("flash_bwd_dkv", "rel-causal", 64, 64): n_dec,
        ("flash_bwd_dq", "none", 64, 128): n_dec,
        ("flash_bwd_dkv", "none", 64, 128): n_dec,
    }


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt5.t5_small(tp_axis="model")
    with pytest.raises(ValueError, match="pos_encoding"):
        tt5.t5_small(pos_encoding="rotary")


# ---------------------------------------------------------------- trainer

def test_trainer_matches_jax_trainer_on_one_device():
    """3 steps of the port's DistributedTrainer against the JAX trainer on
    a 1-device mesh, both with AdamW at eps 1e-6: losses, then every
    parameter, the rel tables included."""
    jcfg, tcfg = _cfgs()
    jp = jt5.init_t5_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(_jax_loss(jcfg), jp, optax.adamw(LR, eps=EPS), mesh=mesh)
    model = _port_model(tcfg, jp)
    tt = DistributedTrainer(tt5.seq2seq_loss, model,
                            adamw(model.parameters(), LR, eps=EPS),
                            device="cpu")
    losses = []
    for i in range(3):
        data = _batch(10 + i)
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
        losses.append(tl)
    assert losses[-1] < losses[0]
    jflat = {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, jt.params)).items()}
    for name, p in tt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jflat[name], rtol=0, atol=1e-5,
                                   err_msg=name)
