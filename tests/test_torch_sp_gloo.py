"""The port's ``ShardedTrainer`` over gloo on the CPU, at seq 2 (2
processes) and at data 2 × seq 2 (4 processes), held against the JAX
``ShardedTrainer`` on the same mesh of CPU devices.

Each rank (``_torch_sp_worker.py``, mode "trainer") builds BERT and GPT-2
at small width (hidden 64, 2 layers, 4 heads, vocab 128, seq 64, fp32,
``sp_axis="seq"``, remat on: the ring's exchanges run again in the
backward's recompute) from ``convert.params_from_jax`` weights, and
trains 3 steps on the same seeded global batches (4 rows), each rank on
the sequence block of its data rows. The JAX side runs its naive ring,
the port its naive ring ("auto" on the CPU). AdamW at eps 1e-6 on both
sides (see ``test_torch_bert.py``).

Tolerances: losses 1e-5 relative; parameters after 3 steps 1e-5 absolute
(fp32 sums in other orders; Adam magnifies near-zero gradients'
differences); every rank the same parameters, bit for bit. GPT-2's
targets: each shard's last target is the next shard's first token, the
global last -1, exactly. Every wait is bounded (60 s rendezvous, 120 s a
rank); every process is reaped.
"""

import functools

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from _torch_sp_worker import WIDTH, Ranks
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh as jmake_mesh
from byteps_tpu.training import ShardedTrainer as JaxShardedTrainer
from byteps_tpu_torch import convert

SEQ, ROWS, LR, EPS = 64, 4, 1e-3, 1e-6
MESHES = {"seq2": {"seq": 2}, "data2_seq2": {"data": 2, "seq": 2}}


def _jcfg(model):
    make = jbert.bert_config if model == "bert" else jgpt2.gpt2_config
    return make(dtype="float32", attn_impl="naive", sp_axis="seq", **WIDTH)


def _batches():
    return {"bert": [jbert.synth_mlm_batch(np.random.RandomState(10 + i),
                                           ROWS, SEQ, WIDTH["vocab_size"])
                     for i in range(3)],
            "gpt2": [jgpt2.synth_lm_batch(np.random.RandomState(20 + i), ROWS,
                                          SEQ, WIDTH["vocab_size"])
                     for i in range(3)]}


@functools.lru_cache(maxsize=None)
def _init(model):
    return jtr.init_params(jax.random.PRNGKey(0), _jcfg(model))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both gloo worlds, started before any JAX reference is computed."""
    tmp = tmp_path_factory.mktemp("sp_gloo")
    b = _batches()
    arrays = {"lr": LR, "eps": EPS,
              "bert_tokens": np.stack([x[0] for x in b["bert"]]),
              "bert_targets": np.stack([x[1] for x in b["bert"]]),
              "gpt2_tokens": np.stack(b["gpt2"])}
    for model in ("bert", "gpt2"):
        for k, v in convert.params_from_jax(
                jax.tree.map(np.asarray, _init(model))).items():
            arrays[f"{model}.p.{k}"] = v.numpy()
    worlds = {}
    for name, axes in MESHES.items():
        src = tmp / f"{name}.npz"
        np.savez(src, axes=np.array(list(axes)),
                 sizes=np.array(list(axes.values())), **arrays)
        worlds[name] = Ranks("trainer", int(np.prod(list(axes.values()))),
                             src, tmp)
    yield worlds
    for w in worlds.values():
        w.close()


@functools.lru_cache(maxsize=None)
def _jax_run(mesh_name, model):
    axes = MESHES[mesh_name]
    n = int(np.prod(list(axes.values())))
    jcfg = _jcfg(model)
    loss = ((lambda p, b: jbert.mlm_loss(p, jcfg, b)) if model == "bert"
            else (lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b)))
    params = _init(model)
    tr = JaxShardedTrainer(loss, params, jax.tree.map(lambda _: P(), params),
                           optax.adamw(LR, eps=EPS),
                           mesh=jmake_mesh(axes, devices=jax.devices()[:n]),
                           donate=False)
    losses = [float(tr.step(b)) for b in _batches()[model]]
    return losses, {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, tr.params)).items()}


@pytest.mark.parametrize("model", ["bert", "gpt2"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_trainer_over_gloo_matches_jax(ranks, mesh_name, model):
    jlosses, jparams = _jax_run(mesh_name, model)   # the ranks run meanwhile
    res = ranks[mesh_name].result()
    for r in res:
        np.testing.assert_allclose(r[f"{model}.losses"], jlosses, rtol=1e-5)
    for name, ref in jparams.items():
        np.testing.assert_allclose(res[0][f"{model}.p.{name}"], ref, rtol=0,
                                   atol=1e-5, err_msg=name)
        for r in res[1:]:           # every replica holds the same weights
            np.testing.assert_array_equal(r[f"{model}.p.{name}"],
                                          res[0][f"{model}.p.{name}"])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_gpt2_next_token_exchange_at_shard_boundaries(ranks, mesh_name):
    """Rank (i, j)'s targets are its rows' next tokens over its sequence
    block: the last one borrowed from block j + 1, -1 on the last
    block."""
    res = ranks[mesh_name].result()
    tokens = _batches()["gpt2"][0]
    want = np.concatenate([tokens[:, 1:], np.full((ROWS, 1), -1)], axis=1)
    axes = MESHES[mesh_name]
    dp, sp = axes.get("data", 1), axes["seq"]
    rows, cols = ROWS // dp, SEQ // sp
    for r in res:
        i, j = (r["coords"] if dp > 1 else (0, *r["coords"]))
        np.testing.assert_array_equal(
            r["gpt2.targets"],
            want[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols])
