"""The port's ``ShardedTrainer`` options over gloo on the CPU, held
against the JAX ``ShardedTrainer`` on the same mesh of CPU devices:

  - data 2 × seq 2 (4 processes) with ``backward_passes_per_step=2`` and
    the README's onebit compression (the exchange over the data axis,
    each rank its own compressor state), 4 micro-steps: two sync
    boundaries;
  - seq 2 (2 processes) with the chunked LM head (``lm_head_chunk=16``
    on each rank's 32 positions: two chunks a shard), 3 steps.

Each rank (``_torch_sp_worker.py``, mode "options") builds GPT-2 at small
width (hidden 64, 2 layers, 4 heads, vocab 128, seq 64, fp32,
``sp_axis="seq"``, remat on) from ``convert.params_from_jax`` weights and
trains on the same seeded global batches (4 rows). The JAX side runs its
naive ring, the port its naive ring ("auto" on the CPU). AdamW at eps
1e-6 on both sides.

Tolerances: losses 1e-5 relative; parameters 1e-5 absolute (fp32 sums in
other orders; Adam magnifies near-zero gradients' differences), under
compression for all but 1 in 1000 elements of a leaf, the rest within
two lr steps a step (a compressed value within rounding of a sign,
``test_torch_compress_trainer.py``); every rank the same parameters, bit
for bit. Every wait is bounded (60 s rendezvous, 120 s a rank); every
process is reaped.
"""

import functools

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from _torch_sp_worker import README_KW, WIDTH, Ranks
from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh as jmake_mesh
from byteps_tpu.training import ShardedTrainer as JaxShardedTrainer
from byteps_tpu_torch import convert

SEQ, ROWS, LR, EPS = 64, 4, 1e-3, 1e-6
# small enough that the tiny model's plan holds compressed buckets and
# plain-sum ones side by side
PARTITION, MIN_COMPRESS = 16384, 8192
CASES = {
    "data2_seq2_accum2_onebit": dict(axes={"data": 2, "seq": 2}, accum=2,
                                     onebit=1, chunk=0, steps=4),
    "seq2_chunk16": dict(axes={"seq": 2}, accum=1, onebit=0, chunk=16,
                         steps=3),
}


def _batches(steps):
    return [jgpt2.synth_lm_batch(np.random.RandomState(30 + i), ROWS, SEQ,
                                 WIDTH["vocab_size"]) for i in range(steps)]


def _jcfg(chunk):
    return jgpt2.gpt2_config(dtype="float32", attn_impl="naive",
                             sp_axis="seq", lm_head_chunk=chunk, **WIDTH)


@functools.lru_cache(maxsize=None)
def _init():
    return jtr.init_params(jax.random.PRNGKey(0), _jcfg(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both gloo worlds, started before any JAX reference is computed."""
    tmp = tmp_path_factory.mktemp("sp_options_gloo")
    params = {f"gpt2.p.{k}": v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, _init())).items()}
    worlds = {}
    for name, c in CASES.items():
        src = tmp / f"{name}.npz"
        np.savez(src, axes=np.array(list(c["axes"])),
                 sizes=np.array(list(c["axes"].values())), lr=LR, eps=EPS,
                 partition=PARTITION, min_compress=MIN_COMPRESS,
                 accum=c["accum"], onebit=c["onebit"], chunk=c["chunk"],
                 gpt2_tokens=np.stack(_batches(c["steps"])), **params)
        worlds[name] = Ranks("options", int(np.prod(list(c["axes"].values()))),
                             src, tmp)
    yield worlds
    for w in worlds.values():
        w.close()


def _jax_run(name):
    c = CASES[name]
    n = int(np.prod(list(c["axes"].values())))
    jcfg = _jcfg(c["chunk"])
    params = _init()
    tr = JaxShardedTrainer(lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b),
                           params, jax.tree.map(lambda _: P(), params),
                           optax.adamw(LR, eps=EPS),
                           mesh=jmake_mesh(c["axes"],
                                           devices=jax.devices()[:n]),
                           partition_bytes=PARTITION,
                           min_compress_bytes=MIN_COMPRESS,
                           backward_passes_per_step=c["accum"],
                           compression=README_KW if c["onebit"] else None,
                           donate=False)
    losses = [float(tr.step(b)) for b in _batches(c["steps"])]
    return losses, {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, tr.params)).items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_trainer_options_over_gloo_match_jax(ranks, name):
    jlosses, jparams = _jax_run(name)       # the ranks run meanwhile
    res = ranks[name].result()
    c = CASES[name]
    for r in res:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
    allowed = (lambda n: n // 1000) if c["onebit"] else (lambda n: 0)
    for key, ref in jparams.items():
        diff = np.abs(res[0][f"p.{key}"] - ref)
        off = int((diff > 1e-5).sum())
        assert off <= allowed(diff.size) and \
            diff.max() <= max(1e-5, 2 * LR * c["steps"]), \
            f"{key}: {off} of {diff.size} elements off, max {diff.max()}"
        for r in res[1:]:           # every replica holds the same weights
            np.testing.assert_array_equal(r[f"p.{key}"], res[0][f"p.{key}"])
