"""The port's compressed ``DistributedTrainer`` beyond the gather
exchange's onebit, and its custom reducers, held against the JAX trainer
on the CPU: GPT-2 tiny (fp32) for 3 steps at world 1 from the same
weights (``convert.params_from_jax``) and batches.

Compression: topk (5%) with error feedback; the README's onebit over the
rs exchange; randomk and dithering. Those two draw from a
``torch.Generator`` where the JAX package draws from ``jax.random``:
their test patches both sides to one numpy stream (a patch inside the
test; the JAX package is not edited). A custom reducer: a lossy one
(each bucket rounded through bf16, then summed), which the JAX trainer
keeps on its size-1 data axis and the port runs at world 1 too.

Tolerances: those of ``test_torch_gpt2.py::
test_compressed_trainer_matches_jax_trainer_on_one_device`` (losses 1e-5
relative; parameters 1e-5 for all but 1 in 1000 elements of a leaf, the
rest within two lr steps a step, for an element whose compressed value
lies within rounding of a decision: a sign, a selection, a level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models import gpt2 as jgpt2
from byteps_tpu.models import transformer as jtr
from byteps_tpu.ops.compression import dithering as jdith
from byteps_tpu.ops.compression import randomk as jrandomk
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import gpt2 as tgpt2
from byteps_tpu_torch.ops.compression import dithering, randomk
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov"}
# small enough that the tiny model's plan holds compressed buckets and
# plain-sum ones side by side
PARTITION, MIN_COMPRESS = 16384, 8192


@pytest.fixture(autouse=True)
def _cpu_numerics(monkeypatch):
    for name in ("BPS_ENABLE_PS", "BPS_FLASH_BQ", "BPS_FLASH_BK",
                 "BPS_FLASH_FUSED_BWD"):
        monkeypatch.delenv(name, raising=False)
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


SEQ, LR = 64, 1e-3


def _batch(seed, rows=4):
    return tgpt2.synth_lm_batch(np.random.RandomState(seed), rows, SEQ, 128)


def _assert_params_close(ref, got, steps=3):
    for name, a in ref.items():
        diff = np.abs(got[name] - a)
        off = int((diff > 1e-5).sum())
        assert off <= a.size // 1000 and diff.max() <= 2 * LR * steps, \
            f"{name}: {off} of {a.size} elements off, max {diff.max()}"


def _trainers(kw):
    jcfg, tcfg = jgpt2.gpt2_tiny(attn_impl="naive"), tgpt2.gpt2_tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b), jp,
                    optax.adamw(LR), mesh=mesh, partition_bytes=PARTITION,
                    compression=kw, min_compress_bytes=MIN_COMPRESS)
    model = tgpt2.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, jp)))
    tt = DistributedTrainer(tgpt2.causal_lm_loss, model,
                            adamw(model.parameters(), LR),
                            partition_bytes=PARTITION, compression=kw,
                            min_compress_bytes=MIN_COMPRESS, device="cpu")
    return jt, tt


def _run_both(jt, tt):
    plan = tt.tx.plan
    assert 0 < plan.n_compressed < len(plan.buckets)
    for i in range(3):
        data = _batch(i)
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    _assert_params_close(
        {k: v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, jt.params)).items()},
        {k: v.detach().numpy() for k, v in tt.model.state_dict().items()})


@pytest.mark.parametrize("case", ["topk", "onebit_rs"])
def test_compressed_trainer_is_the_jax_trainer(case):
    kw = ({"compressor_type": "topk", "compressor_k": "0.05",
           "ef_type": "vanilla"} if case == "topk"
          else dict(README_KW, exchange="rs"))
    jt, tt = _trainers(kw)
    assert tt.tx.plan.exchange == ("rs" if case == "onebit_rs" else "gather")
    assert tt.tx.plan.world == 1
    _run_both(jt, tt)


def _draws(kind, size, k, step):
    """One numpy stream of draws for both sides: a bucket of ``size``'s
    draws at ``step``."""
    rng = np.random.RandomState(1000 * size + step)
    if kind == "randomk":
        return rng.randint(0, size, k).astype(np.int32)
    return rng.uniform(size=size).astype(np.float32)


@pytest.mark.parametrize("kind", ["randomk", "dithering"])
def test_random_compressor_trainer_is_the_jax_trainer_on_one_stream(
        kind, monkeypatch):
    """Both sides' draws patched to ``_draws``: the step count rides in
    the compressor state (a traced int under the JAX trainer's jit)."""
    steps = 3
    table = {}

    def drawn(comp):
        key = (comp.size, getattr(comp, "k", 0))
        if key not in table:
            table[key] = np.stack([_draws(kind, comp.size, key[1], s)
                                   for s in range(steps)])
        return table[key]

    port_cls, jax_cls = ((randomk.RandomkCompressor, jrandomk.RandomkCompressor)
                         if kind == "randomk" else
                         (dithering.DitheringCompressor,
                          jdith.DitheringCompressor))
    monkeypatch.setattr(port_cls, "init_state",
                        lambda self, device=None: {"n": 0})
    monkeypatch.setattr(port_cls, "draw", lambda self, st, device: (
        torch.from_numpy(drawn(self)[st["n"]]).to(device),
        {"n": st["n"] + 1}))
    monkeypatch.setattr(jax_cls, "init_state",
                        lambda self: {"n": jnp.int32(0)})

    def jcompress(self, x, st):
        d = jnp.asarray(drawn(self))[st["n"]]
        if kind == "randomk":
            pay = self.compress_with_indices(x, d)[0]
        else:
            q, scale = self.quantize(x, d)
            pay = {"q": q, "scale": scale}
        return pay, {"n": st["n"] + 1}
    monkeypatch.setattr(jax_cls, "compress", jcompress)
    kw = ({"compressor_type": "randomk", "compressor_k": "0.05",
           "ef_type": "vanilla", "seed": "7"} if kind == "randomk" else
          {"compressor_type": "dithering", "compressor_k": "4", "seed": "7"})
    jt, tt = _trainers(kw)
    _run_both(jt, tt)


def test_custom_reducer_trainer_is_the_jax_trainer(monkeypatch):
    """A lossy reducer (each bucket rounded through bf16, then summed)
    runs on every bucket at world 1, where the plain sum would skip it,
    and trains as the JAX trainer does with the same reducer. PS mode
    refuses a custom reducer with the JAX trainer's ValueError, and
    compression excludes one."""
    from byteps_tpu_torch.parallel.collectives import psum_reducer
    seen = []

    def reducer(buf, group):
        seen.append((buf.numel(), group))
        return psum_reducer(buf.to(torch.bfloat16).to(buf.dtype), group)

    def jreducer(x, axes):
        return jax.lax.psum(x.astype(jnp.bfloat16).astype(x.dtype), axes)

    jcfg, tcfg = jgpt2.gpt2_tiny(attn_impl="naive"), tgpt2.gpt2_tiny()
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jt = JaxTrainer(lambda p, b: jgpt2.causal_lm_loss(p, jcfg, b), jp,
                    optax.adamw(LR), mesh=mesh, partition_bytes=PARTITION,
                    reducer=jreducer)

    def model():
        m = tgpt2.Transformer(tcfg)
        m.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, jp)))
        return m

    m = model()
    tt = DistributedTrainer(tgpt2.causal_lm_loss, m,
                            adamw(m.parameters(), LR),
                            partition_bytes=PARTITION, reducer=reducer,
                            device="cpu")
    for i in range(3):
        data = _batch(i)
        jl, tl = float(jt.step(data)), tt.step(data).item()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"step {i}")
    n_params = sum(p.numel() for p in m.parameters())
    assert sum(n for n, _ in seen) == 3 * n_params
    assert {g for _, g in seen} == {None}             # world 1: no group
    _assert_params_close(
        {k: v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, jt.params)).items()},
        {k: v.detach().numpy() for k, v in tt.model.state_dict().items()})
    # the reducer moved the gradient: a dense run ends elsewhere
    m2 = model()
    dense = DistributedTrainer(tgpt2.causal_lm_loss, m2,
                               adamw(m2.parameters(), LR),
                               partition_bytes=PARTITION, device="cpu")
    for i in range(3):
        dense.step(_batch(i))
    assert any(not torch.equal(a, b) for a, b in zip(m.parameters(),
                                                     m2.parameters()))
    with pytest.raises(ValueError, match="exclusive"):
        DistributedTrainer(tgpt2.causal_lm_loss, m2,
                           adamw(m2.parameters(), LR), reducer=reducer,
                           compression=README_KW, device="cpu")
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    with pytest.raises(ValueError, match="silently unused in PS mode"):
        DistributedTrainer(tgpt2.causal_lm_loss, m2,
                           adamw(m2.parameters(), LR), reducer=reducer,
                           device="cpu")
