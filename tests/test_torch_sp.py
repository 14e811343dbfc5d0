"""The port's sequence parallelism in one process on the CPU: the mesh,
``ShardedTrainer`` on a ``{"seq": 1}`` mesh (a ring of one) against the
JAX ``ShardedTrainer`` on a one-device ``seq`` mesh, and the refusals.

Weights cross from JAX by name (``convert.params_from_jax``); batches are
the same seeded numpy arrays. BERT and GPT-2 at small width (hidden 64, 2
layers, 4 heads, vocab 128, seq 64, fp32), ``sp_axis="seq"``, AdamW at eps
1e-6 on both sides (see ``test_torch_bert.py``). The JAX side's attention
is its naive ring (its default on the CPU), the port's its naive ring
("auto" on the CPU) and its flash ring (the kernels' plain versions).

Tolerances: losses 1e-5 relative, parameters after 3 steps 1e-5 absolute
(fp32 in another summation order; Adam magnifies near-zero gradients'
differences). The multi-rank trainer over gloo is
``test_torch_sp_gloo.py``.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu.training import ShardedTrainer as JaxShardedTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.models.transformer import Transformer
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.parallel import mesh as tmesh
from byteps_tpu_torch.training import DistributedTrainer, ShardedTrainer

WIDTH = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=64)
SEQ, ROWS, LR, EPS = 64, 4, 1e-3, 1e-6


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    """Full fp32 matmuls, 2 torch threads (the suite runs in parallel
    workers), and no port env knobs another test may have left set."""
    for name in ("BPS_NUM_WORKER", "BPS_ENABLE_PS", "BPS_ENABLE_ASYNC",
                 "BPS_PP_STAGES"):
        monkeypatch.delenv(name, raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _batches(model):
    if model == "bert":
        return [tbert.synth_mlm_batch(np.random.RandomState(i), ROWS, SEQ,
                                      WIDTH["vocab_size"]) for i in range(3)]
    return [tgpt2.synth_lm_batch(np.random.RandomState(i), ROWS, SEQ,
                                 WIDTH["vocab_size"]) for i in range(3)]


def _cfgs(model, **kw):
    jmod, tmod = (jbert, tbert) if model == "bert" else (jgpt2, tgpt2)
    make = "bert_config" if model == "bert" else "gpt2_config"
    jcfg = getattr(jmod, make)(dtype="float32", **WIDTH, **dict(
        kw, attn_impl="naive"))
    tcfg = getattr(tmod, make)(dtype="float32", **WIDTH, **kw)
    return jcfg, tcfg


def _jax_loss(model, jcfg):
    if model == "bert":
        return lambda p, b: jbert.mlm_loss(p, jcfg, b)
    return lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b)


def _port_loss(model):
    return tbert.mlm_loss if model == "bert" else tgpt2.causal_lm_loss


@functools.lru_cache(maxsize=None)
def _jax_run(model):
    """3 steps of the JAX ShardedTrainer on a one-device ``seq`` mesh:
    (initial params, losses, final params as a flat state dict)."""
    jcfg, _ = _cfgs(model, sp_axis="seq")
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1), ("seq",))
    tr = JaxShardedTrainer(_jax_loss(model, jcfg), params,
                           jax.tree.map(lambda _: P(), params),
                           optax.adamw(LR, eps=EPS), mesh=mesh, donate=False)
    losses = [float(tr.step(b)) for b in _batches(model)]
    return (convert.params_from_jax(jax.tree.map(np.asarray, params)),
            losses, convert.params_from_jax(jax.tree.map(np.asarray,
                                                         tr.params)))


def _port_model(tcfg, state):
    model = Transformer(tcfg)
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_seq1_trainer_matches_jax_sharded_trainer(model, impl):
    init, jlosses, jparams = _jax_run(model)
    _, tcfg = _cfgs(model, sp_axis="seq", attn_impl=impl)
    m = _port_model(tcfg, init)
    tr = ShardedTrainer(_port_loss(model), m,
                        adamw(m.parameters(), LR, eps=EPS),
                        tmesh.make_mesh({"seq": 1}), device="cpu")
    losses = [tr.step(b).item() for b in _batches(model)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for name, p in m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert tmesh.current_mesh() is None        # the step's mesh is scoped


@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_seq1_step_is_the_dense_step(model):
    """A ring of one: the same weights and batch through ShardedTrainer
    (sp_axis, full head) and DistributedTrainer (dense, full head) give
    the same losses, bit for bit, and the same weights."""
    init, _, _ = _jax_run(model)
    _, tcfg = _cfgs(model, sp_axis="seq", attn_impl="flash")
    _, dcfg = _cfgs(model, attn_impl="flash")
    ms, md = _port_model(tcfg, init), _port_model(dcfg, init)
    ts = ShardedTrainer(_port_loss(model), ms,
                        adamw(ms.parameters(), LR, eps=EPS),
                        tmesh.make_mesh({"seq": 1}), device="cpu")
    td = DistributedTrainer(_port_loss(model), md,
                            adamw(md.parameters(), LR, eps=EPS),
                            device="cpu")
    for b in _batches(model):
        assert ts.step(b).item() == td.step(b).item()
    for (n, a), (_, c) in zip(ms.state_dict().items(),
                              md.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


def test_gpt2_targets_on_a_ring_of_one_are_the_dense_targets():
    tokens = torch.from_numpy(_batches("gpt2")[0])
    with tmesh.use_mesh(tmesh.make_mesh({"seq": 1})):
        got = tgpt2.next_token_targets(tokens, "seq")
    assert torch.equal(got, tgpt2.next_token_targets(tokens))
    assert (got[:, -1] == -1).all()
    assert torch.equal(got[:, :-1], tokens[:, 1:])


def test_make_mesh_layout_and_refusals():
    m = tmesh.make_mesh({"seq": 1, "data": 1})
    assert m.axis_names == ("data", "seq")     # AXIS_ORDER, size 1 kept
    assert m.ring("seq") == tmesh.Ring(None, 1, 0)
    assert m.group("data") is None and m.size("model") == 1
    assert tmesh.make_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.make_mesh({"sequence": 1})
    with pytest.raises(ValueError, match="multiply"):
        tmesh.make_mesh({"seq": 2})
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tmesh.make_mesh({"data": 1}).ring("seq")
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(m):
        assert tmesh.current_mesh() is m
        assert tmesh.axis_ring("seq").size == 1
        assert tmesh.data_group() is None and tmesh.dp_size() == 1
    assert tmesh.current_mesh() is None


def test_sp_model_without_a_mesh_raises():
    _, tcfg = _cfgs("bert", sp_axis="seq")
    m = Transformer(tcfg)
    tokens = torch.from_numpy(_batches("bert")[0][0])
    with pytest.raises(RuntimeError, match="no mesh is current"):
        m(tokens)


@pytest.mark.parametrize("axes,kw,match", [
    ({"seq": 1, "model": 1}, {"param_spec_tree": {}}, "param_spec_tree"),
    ({"seq": 1}, {"compression": {"compressor_type": "onebit"}},
     "compression"),
    ({"seq": 1}, {"backward_passes_per_step": 2}, "backward_passes"),
])
def test_sharded_trainer_refusals(axes, kw, match):
    """A ``param_spec_tree`` raises. Compression and accumulation,
    refused until they were ported, now construct
    (``test_seq1_trainer_options_match_jax_sharded_trainer``)."""
    _, tcfg = _cfgs("bert", sp_axis="seq")
    m = Transformer(tcfg)
    if match != "param_spec_tree":
        tr = ShardedTrainer(tbert.mlm_loss, m, adamw(m.parameters(), LR),
                            tmesh.make_mesh(axes), device="cpu", **kw)
        assert (tr.tx.plan is not None) == ("compression" in kw)
        assert tr.tx.backward_passes_per_step == \
            kw.get("backward_passes_per_step", 1)
        return
    with pytest.raises(NotImplementedError, match=match):
        ShardedTrainer(tbert.mlm_loss, m, adamw(m.parameters(), LR),
                       tmesh.make_mesh(axes), device="cpu", **kw)


README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov"}
# small enough that the tiny model's plan holds compressed buckets and
# plain-sum ones side by side
PARTITION, MIN_COMPRESS = 16384, 8192
OPTIONS = {"accumulate2": {"backward_passes_per_step": 2},
           "onebit": {"compression": README_KW},
           "accumulate2_onebit": {"backward_passes_per_step": 2,
                                  "compression": README_KW}}


@functools.lru_cache(maxsize=None)
def _jax_options_run(option):
    """4 steps of the JAX ShardedTrainer on a one-device ``data`` ×
    ``seq`` mesh with ``OPTIONS[option]``."""
    jcfg, _ = _cfgs("gpt2", sp_axis="seq")
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    tr = JaxShardedTrainer(_jax_loss("gpt2", jcfg), params,
                           jax.tree.map(lambda _: P(), params),
                           optax.adamw(LR, eps=EPS), mesh=mesh, donate=False,
                           partition_bytes=PARTITION,
                           min_compress_bytes=MIN_COMPRESS,
                           **OPTIONS[option])
    losses = [float(tr.step(b)) for b in _batches("gpt2") + _batches("gpt2")[:1]]
    return (convert.params_from_jax(jax.tree.map(np.asarray, params)),
            losses, {k: v.numpy() for k, v in convert.params_from_jax(
                jax.tree.map(np.asarray, tr.params)).items()})


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_seq1_trainer_options_match_jax_sharded_trainer(option):
    """``backward_passes_per_step=2`` and the README's onebit compression
    on a ring of one: 4 steps (two sync boundaries under accumulation)
    against the JAX trainer's. Parameters within 1e-5 for all but 1 in
    1000 elements of a leaf, the rest within two lr steps a step
    (``test_torch_compress_trainer.py``: a compressed value within
    rounding of a sign)."""
    init, jlosses, jparams = _jax_options_run(option)
    _, tcfg = _cfgs("gpt2", sp_axis="seq", attn_impl="flash")
    m = _port_model(tcfg, init)
    tr = ShardedTrainer(_port_loss("gpt2"), m,
                        adamw(m.parameters(), LR, eps=EPS),
                        tmesh.make_mesh({"data": 1, "seq": 1}), device="cpu",
                        partition_bytes=PARTITION,
                        min_compress_bytes=MIN_COMPRESS, **OPTIONS[option])
    losses = []
    for i, b in enumerate(_batches("gpt2") + _batches("gpt2")[:1]):
        losses.append(tr.step(b).item())
        if i == 0:      # mid-window under accumulation: no update yet
            moved = any(not torch.equal(p, init[n])
                        for n, p in m.state_dict().items())
            assert moved != ("backward_passes_per_step" in OPTIONS[option])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for name, p in m.state_dict().items():
        diff = np.abs(p.numpy() - jparams[name])
        off = int((diff > 1e-5).sum())
        assert off <= diff.size // 1000 and diff.max() <= 2 * LR * 4, \
            f"{name}: {off} of {diff.size} elements off, max {diff.max()}"
    assert (tr.tx.plan is not None) == ("compression" in OPTIONS[option])


def test_sharded_trainer_refuses_tp_pp_expert_axes():
    """Axes above 1 other than data and seq: a 4-rank mesh is made here
    without a process group by stubbing its shape."""
    _, tcfg = _cfgs("bert", sp_axis="seq")
    m = Transformer(tcfg)
    for ax in ("model", "pipe", "expert", "dcn"):
        mesh = tmesh.make_mesh({"seq": 1})
        mesh.shape = {ax: 2, "seq": 1}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ShardedTrainer(tbert.mlm_loss, m, adamw(m.parameters(), LR),
                           mesh, device="cpu")


@pytest.mark.parametrize("kw", [{"tp_axis": "model"}, {"pp_axis": "pipe"}])
def test_tp_and_pp_axes_still_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbert.bert_large(**kw)
    assert tbert.bert_large(sp_axis="seq").sp_axis == "seq"


def test_sharded_trainer_defaults_to_the_card():
    _, tcfg = _cfgs("bert", sp_axis="seq")
    m = Transformer(tcfg)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedTrainer(tbert.mlm_loss, m, adamw(m.parameters(), LR),
                       tmesh.make_mesh({"seq": 1}))
