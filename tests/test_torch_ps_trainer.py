"""The slice as a whole on the CPU: the port's ``DistributedTrainer`` trains
a small BERT through the parameter-server path, held against the JAX
package's trainer on the same weights and batches.

BERT at 2 layers, hidden 128, 4 heads of 32, vocab 512, seq 64, one fixed
seeded batch of 4, in fp32, cut into 8 buckets of 256 KiB; weights from
``transformer.init_params(PRNGKey(0))`` through ``convert.params_from_jax``.
Both sides run ``bps.init()`` with ``BPS_ENABLE_PS=1`` (the in-process
server at world 1),
``BPS_MIN_COMPRESS_BYTES=0`` and ``BPS_COMPRESS_DEVICE=1``: the port
encodes with its kernels' plain versions on CPU tensors, the JAX package
with its Pallas kernels in interpret mode. The JAX trainer runs its
monolithic tail (``BPS_APPLY_CHUNKED=0``), the one the port has.

Tolerances, with their reasons:
  - losses 1e-5 relative and parameters 1e-5 absolute after 3 AdamW steps:
    those of the dense parity tests (``test_torch_bert.py``), the same fp32
    arithmetic in another summation order. AdamW runs with eps 1e-6 on
    both sides, as the two-process dense test does: at optax's 1e-8,
    g / (|g| + eps) turns that rounding noise on gradients near 1e-8 into
    a whole lr step;
  - under int8 and fp8 a gradient within rounding of a code boundary may
    take the neighbouring code in the two frameworks, and the JAX encode's
    residual rounds its x - q·s as one FMA (``test_torch_quant.py``): a
    code step moves that element's Adam update by up to a whole lr step,
    so at most 1 in 1000 parameter elements may lie outside 1e-5, and at
    most 1 in 1000 payload bytes of step 1 may differ.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.training import DistributedTrainer as JaxTrainer
import byteps_tpu_torch as bps
from byteps_tpu_torch import convert
from byteps_tpu_torch.common.global_state import GlobalState
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.compress import wire
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.ops.compression import kernels as qk
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.training import DistributedTrainer

WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
SEQ, BATCH, MAX_PRED, LR, EPS, STEPS = 64, 4, 10, 1e-3, 1e-6, 3

_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK",
             "BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", "BPS_COORDINATOR_ADDRESS",
             "DMLC_PS_ROOT_URI", "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC",
             "BPS_SERVER_ADDRS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
             "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF")


@pytest.fixture(autouse=True)
def _ps_env(monkeypatch):
    for name in _PORT_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_MIN_COMPRESS_BYTES", "0")
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    monkeypatch.setenv("BPS_APPLY_CHUNKED", "0")
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


def _batch(i):
    return tbert.synth_mlm_batch(np.random.RandomState(i), BATCH, SEQ,
                                 WIDTH["vocab_size"])


def _record_pushes(backend):
    """Keep every fused payload the trainer pushes, in push order."""
    seen, push = [], backend.push_fused

    def recording(key, payload, *a, **kw):
        seen.append((key, bytes(payload)))
        return push(key, payload, *a, **kw)

    backend.push_fused = recording
    return seen


def _run_jax(jcfg, jp):
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    seen = _record_pushes(jbps.common.global_state.GlobalState.get()
                          .ps_backend)
    jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, jcfg, b,
                                                max_predictions=MAX_PRED),
                    jp, optax.adamw(LR, eps=EPS), mesh=mesh)
    losses, first = [], None
    for i in range(STEPS):
        losses.append(float(jt.step(_batch(0))))
        if i == 0:
            first = list(seen)
    return losses, jax.tree.map(np.asarray, jt.params), first


def _run_port(tcfg, jp):
    bps.init(device="cpu")
    gs = GlobalState.get()
    seen = _record_pushes(gs.ps_backend)
    model = tbert.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray,
                                                               jp)))
    tt = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED), model,
        adamw(model.parameters(), LR, eps=EPS), device="cpu")
    launches = (qk.int8_quantize.launches, qk.fp8_sr_quantize.launches)
    d0 = get_registry().counter("ps/d2h_bytes").value
    losses, first = [], None
    for i in range(STEPS):
        losses.append(tt.step(_batch(0)).item())
        if i == 0:
            first = list(seen)
            d2h = get_registry().counter("ps/d2h_bytes").value - d0
    # the plain versions ran on the CPU: no kernel launch was counted
    assert (qk.int8_quantize.launches, qk.fp8_sr_quantize.launches) == \
        launches
    return losses, convert.params_to_jax_layout(model), first, tt, d2h


@pytest.mark.parametrize("codec", ["none", "int8", "fp8_e4m3", "fp16",
                                   "topk"])
def test_ps_trainer_matches_the_jax_ps_trainer(codec, monkeypatch):
    monkeypatch.setenv("BPS_COMPRESS", codec)
    jcfg = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
    tcfg = tbert.bert_config(dtype="float32", **WIDTH)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)

    jl, jparams, jfirst = _run_jax(jcfg, jp)
    tl, tparams, tfirst, tt, d2h = _run_port(tcfg, jp)

    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    ref = jax.tree_util.tree_leaves(jparams)
    got = jax.tree_util.tree_leaves(tparams)
    assert [a.shape for a in got] == [a.shape for a in ref]
    a, b = (np.concatenate([x.ravel() for x in v]) for v in (got, ref))
    off = np.count_nonzero(np.abs(a - b) > 1e-5)
    if codec == "none":
        assert off == 0
        assert not tfirst and not jfirst
        return
    assert off <= a.size // 1000, off
    # step 1's payloads: the same keys, sizes and codec headers, scales
    # within rounding, and the codes byte for byte up to boundary flips
    tfirst, jfirst = dict(tfirst), dict(jfirst)      # pushed on threads
    assert sorted(tfirst) == sorted(jfirst)
    nc = tt.ps_exchange.n_compressed()
    assert len(tfirst) == nc > 1
    diff = total = 0
    h = wire._HDR.size
    for p, q in ((tfirst[k], jfirst[k]) for k in sorted(tfirst)):
        assert len(p) == len(q) and p[:h] == q[:h]      # the header
        if codec == "fp16":
            # the casts of gradients that agree within fp32 rounding: an
            # element may round to the neighbouring fp16 value
            x, y = (np.frombuffer(b[h:], np.float16).astype(np.float32)
                    for b in (p, q))
            np.testing.assert_allclose(x, y, rtol=2.0 ** -9, atol=2.0 ** -22)
            diff += np.count_nonzero(x != y)
            total += x.size
            continue
        if codec == "topk":
            # k, then the indices (a selection at a near-tie may differ)
            # and their fp32 values, within fp32 rounding where both
            # sides picked the same index
            assert p[h:h + 4] == q[h:h + 4]
            k = int(np.frombuffer(p[h:h + 4], np.uint32)[0])
            pi, qi = (np.frombuffer(b[h + 4:h + 4 + 4 * k], np.int32)
                      for b in (p, q))
            pv, qv = (np.frombuffer(b[h + 4 + 4 * k:], np.float32)
                      for b in (p, q))
            same = pi == qi
            diff += np.count_nonzero(~same)
            total += k
            np.testing.assert_allclose(pv[same], qv[same], rtol=1e-4,
                                       atol=1e-6)
            continue
        np.testing.assert_allclose(np.frombuffer(p[h:h + 4], np.float32),
                                   np.frombuffer(q[h:h + 4], np.float32),
                                   rtol=1e-4)             # the scale
        x, y = np.frombuffer(p[h + 4:], np.uint8), np.frombuffer(q[h + 4:],
                                                                 np.uint8)
        diff += np.count_nonzero(x != y)
        total += x.size
    # fp16's rounding points lie 2^-11 apart (relative), int8's codes
    # 1/127 of the bucket's largest value: a gradient a few fp32 ulps off
    # lands on the other side of one far more often under fp16
    assert diff <= total // (100 if codec == "fp16" else 1000), (diff, total)
    if wire.codec_id(codec) in tdev.DEVICE_CODECS:
        # only the payloads crossed to the host: code bytes plus the scale
        assert d2h == sum(len(p) - h for p in tfirst.values())
    else:
        # fp16 and topk have no device encode: the port encodes them on
        # the host, so the dense buckets crossed
        assert d2h == sum(4 * wire._HDR.unpack(p[:h])[-1]
                          for p in tfirst.values())


def test_ps_trainer_needs_init_and_refuses_unported_options(monkeypatch):
    model = tbert.Transformer(tbert.bert_tiny())
    opt = adamw(model.parameters(), LR)
    with pytest.raises(RuntimeError, match="bps.init"):
        DistributedTrainer(lambda m, b: 0, model, opt, device="cpu")
    bps.init(device="cpu")
    # accumulation in PS mode, refused until it was ported, now takes the
    # JAX package's running mean (test_torch_ps_overlap.py)
    tt = DistributedTrainer(lambda m, b: 0, model, opt, device="cpu",
                            backward_passes_per_step=2)
    assert tt.backward_passes_per_step == 2 and not tt._staged_route()
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        DistributedTrainer(lambda m, b: 0, model, opt, device="cpu",
                           backward_passes_per_step=0)
    # the legacy compression kwargs in PS mode, refused until they were
    # ported, now ride the declaration (test_torch_ps_legacy_compress.py)
    tt = DistributedTrainer(lambda m, b: 0, model, opt, device="cpu",
                            compression={"compressor_type": "onebit"})
    decl = GlobalState.get().registry.get(tt._name)
    assert decl.compression_kwargs == {"compressor_type": "onebit"}
    bps.shutdown()
    monkeypatch.setenv("BPS_NUM_WORKER", "2")
    with pytest.raises(ValueError, match="BPS_SERVER_ADDRS"):
        bps.init(device="cpu")
    # standalone servers, refused until the transport was ported, now give
    # world 2 its remote backend (test_torch_ps_remote.py); the managed
    # server plane over them stays refused
    from byteps_tpu_torch.server.engine import PSServer
    from byteps_tpu_torch.server.transport import (PSTransportServer,
                                                   RemotePSBackend)
    eng = PSServer(num_workers=2, engine_threads=1)
    srv = PSTransportServer(eng, host="127.0.0.1")
    try:
        monkeypatch.setenv("BPS_SERVER_ADDRS", f"127.0.0.1:{srv.port}")
        bps.init(device="cpu")
        gs = GlobalState.get()
        assert isinstance(gs.ps_backend, RemotePSBackend)
        assert gs.engine.ps_world == 2
        bps.shutdown()
        monkeypatch.setenv("BPS_PLANE_REPLICAS", "1")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bps.init(device="cpu")
    finally:
        srv.close()
        eng.close()


def test_a_trainer_run_holds_only_the_trainers_exchange(monkeypatch):
    """The engine behind ``bps.push_pull`` builds its PS exchange at its
    first use: a run that trains through ``DistributedTrainer`` alone
    holds one exchange, the trainer's, and ``bps.shutdown`` closes
    whichever were built."""
    monkeypatch.setenv("BPS_COMPRESS", "int8")
    bps.init(device="cpu")
    gs = GlobalState.get()
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH))
    tt = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED), model,
        adamw(model.parameters(), LR, eps=EPS), device="cpu")
    assert np.isfinite(tt.step(_batch(0)).item())
    assert gs.exchanges == [tt.ps_exchange]
    assert gs.engine._ps_exchange is None
    ex = gs.engine.ps_exchange
    assert ex is not None and ex is not tt.ps_exchange
    assert gs.engine.ps_exchange is ex
    assert gs.exchanges == [tt.ps_exchange, ex]
    out = bps.push_pull({"g": torch.ones(1 << 16)}, name="g")
    assert out["g"].shape == (1 << 16,)


def test_shutdown_frees_the_exchanges_at_once(monkeypatch):
    """``bps.shutdown`` drops the state, its exchanges and their error-
    feedback residuals (on the card, the size of the gradients) at once,
    without waiting for the cycle collector: nothing the engine holds
    refers back to the state."""
    import gc
    import weakref
    monkeypatch.setenv("BPS_COMPRESS", "int8")
    bps.init(device="cpu")
    gs = GlobalState.get()
    bps.push_pull({"g": torch.ones(1 << 16)}, name="g")
    refs = [weakref.ref(gs), weakref.ref(gs.engine),
            weakref.ref(gs.engine.ps_exchange)]
    del gs
    gc.disable()
    try:
        bps.shutdown()
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()
