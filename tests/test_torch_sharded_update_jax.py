"""The port's sharded PS trainers against the JAX package's on the same
numpy inputs, on the CPU: ``dp`` trainers of each framework in threads,
each with its own connection pool, against one server of its own
framework over TCP (the shape of ``tests/test_sharded_update.py``'s
harness), each worker its own seeded batches.

The JAX trainers run with ``BPS_BWD_STAGED=0``: the JAX staged head reads
``jax.core.Var``, which some jax releases lack, and the JAX package holds
its staged head bit for bit to the monolithic one, so the oracle's numbers
are the same either way. The port runs its default route (staged head,
streamed tail, cross-step driver).

Tolerances are ``test_torch_ps_remote.py``'s: losses within 1e-5
relative, parameters within 1e-5 absolute (the two frameworks' fp32
matmuls and optimizers round apart). Within each framework both replicas
end bit for bit equal: every replica installs its owners' exact bytes.
"""

import threading

import jax
import numpy as np
import optax
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.server.engine import PSServer as JServer
from byteps_tpu.server.transport import PSTransportServer as JTransport
from byteps_tpu.server.transport import RemotePSBackend as JRemote
from byteps_tpu.training import DistributedTrainer as JTrainer
from byteps_tpu_torch import convert
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.optim import adamw

import _torch_sharded as h

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
SEQ, BATCH, MAX_PRED, LR, EPS, STEPS = 32, 4, 6, 1e-3, 1e-6, 3


@pytest.fixture(autouse=True)
def _torch_env():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    with h.env():
        yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def run_jax_arm(loss_fn, params0, tx, worker_batches, *, dp, name,
                partition_bytes, steps):
    """The JAX package's sharded trainers: ``dp`` threads over one JAX
    server. Returns (per-worker final leaves, per-worker losses, the owned
    groups of each worker)."""
    eng = JServer(num_workers=dp, engine_threads=2)
    srv = JTransport(eng, host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{srv.port}"
    privs = []
    with h.env(BPS_ENABLE_PS=1, BPS_NUM_WORKER=dp, BPS_SERVER_ADDRS=addr,
               BPS_SHARDED_UPDATE=1, BPS_CROSS_STEP=0, BPS_BWD_STAGED=0,
               BPS_PS_CONNS=8):
        try:
            jbps.init(config=jbps.Config.from_env())
            mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
            trs = []
            for w in range(dp):
                tr = JTrainer(loss_fn, params0, tx, mesh=mesh,
                              partition_bytes=partition_bytes, name=name,
                              shard_rank=w)
                priv = JRemote([addr], conns_per_shard=8)
                tr._ps_exchange.backend = priv
                privs.append(priv)
                trs.append(tr)
            errs, losses = [], [[] for _ in range(dp)]

            def run(w):
                try:
                    for b in worker_batches[w][:steps]:
                        losses[w].append(float(trs[w].step(b)))
                    trs[w].drain()
                except BaseException as e:   # noqa: BLE001 — asserted
                    errs.append((w, e))

            ts = [threading.Thread(target=run, args=(w,), daemon=True)
                  for w in range(dp)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(h.WAIT)
            assert not any(t.is_alive() for t in ts), "JAX workers hung"
            assert not errs, errs
            assert all(tr._sharded is not None for tr in trs)
            owned = [set(tr._sharded.plan.owned) for tr in trs]
            finals = [[np.asarray(x)
                       for x in jax.tree_util.tree_leaves(tr.params)]
                      for tr in trs]
            for tr in trs:
                tr.close()
            return finals, losses, owned
        finally:
            jbps.shutdown()
            for p in privs:
                p.close()
            srv.close()
            eng.close()


def _compare(port, jax_, dp):
    (pf, pl, _, powned), (jf, jl, jowned) = port, jax_
    for f in (pf, jf):                 # replicas bit for bit
        for other in f[1:]:
            for a, b in zip(f[0], other):
                np.testing.assert_array_equal(a, b)
    # the same groups on the same workers
    assert [o for o, _ in powned] == jowned
    assert [s for _, s in powned] == jowned
    for w in range(dp):
        np.testing.assert_allclose(pl[w], jl[w], rtol=LOSS_RTOL)
    assert len(pf[0]) == len(jf[0])
    for a, b in zip(pf[0], jf[0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("dp", [2, 4])
def test_chain_mlp_against_the_jax_trainer(dp):
    import test_sharded_update as ref        # the JAX test's chain loss
    dim, steps = 96, 4
    p0 = h.chain_params(dim=dim)
    batches = [h.chain_batches(dim, 10 + w, steps) for w in range(dp)]
    port = h.run_port_arm(lambda: h.Chain(p0), h.chain_loss, batches,
                          dp=dp, sharded="1", name=f"pz{dp}",
                          partition_bytes=dim * dim * 4, steps=steps,
                          cross="1")
    jx = run_jax_arm(ref._chain_loss, dict(p0), optax.adam(1e-3), batches,
                     dp=dp, name=f"jz{dp}", partition_bytes=dim * dim * 4,
                     steps=steps)
    _compare(port, jx, dp)


def test_bert_tiny_against_the_jax_trainer():
    jcfg = jbert.bert_tiny(attn_impl="naive")
    jp = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    state = convert.params_from_jax(jp)
    dp = 2
    batches = [[tbert.synth_mlm_batch(np.random.RandomState(100 * w + s),
                                      BATCH, SEQ, jcfg.vocab_size)
                for s in range(STEPS)] for w in range(dp)]

    def model():
        m = tbert.Transformer(tbert.bert_tiny())
        m.load_state_dict(state)
        return m

    port = h.run_port_arm(
        model, lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED),
        batches, dp=dp, sharded="1", name="pb", partition_bytes=16 << 10,
        steps=STEPS, cross="1",
        optimizer=lambda ps: adamw(ps, LR, eps=EPS))
    jx = run_jax_arm(
        lambda p, b: jbert.mlm_loss(p, jcfg, b, max_predictions=MAX_PRED),
        jp, optax.adamw(LR, eps=EPS), batches, dp=dp, name="jb",
        partition_bytes=16 << 10, steps=STEPS)
    assert len(port[3][0][0]) >= 2          # several groups to own
    _compare(port, jx, dp)
