"""The legacy ``compression=`` chains through the port's parameter server,
held against the JAX package on the CPU: the server's compressed keys
(decompress every push, sum, recompress the merged round once), the
worker's chains in ``PSGradientExchange`` beside the fused plane, and
``DistributedTrainer`` in PS mode with the README's onebit kwargs
(``compressor_type`` onebit, ``compressor_onebit_scaling``, ``ef_type``
vanilla, ``momentum_type`` nesterov) training a small BERT.

Tolerances, with their reasons:
  - the server and the exchange: none. The same bytes go in, and the
    codecs, sums and chains are bit for bit the JAX package's
    (``test_torch_host_codecs.py``);
  - the trainer: those of ``test_torch_ps_trainer.py``, whose reasons
    hold here: losses 1e-5 relative and parameters 1e-5 absolute after 3
    AdamW steps (eps 1e-6), at most 1 in 1000 parameter elements outside
    1e-5. Both frameworks' fp32 gradients agree to rounding; onebit keeps
    each element's sign, so an element within rounding of 0 may take the
    other sign and move its Adam update by up to a whole lr step.
"""

import threading

import jax
import numpy as np
import optax
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.common.naming import NameRegistry as JNameRegistry
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.ops.compression import host as jhost
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.server.engine import HostPSBackend as JBackend
from byteps_tpu.server.ps_mode import PSGradientExchange as JExchange
from byteps_tpu.training import DistributedTrainer as JaxTrainer
import byteps_tpu_torch as bps
from byteps_tpu_torch import convert
from byteps_tpu_torch.common.global_state import GlobalState
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.models import bert as tbert
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.ops.compression import host as thost
from byteps_tpu_torch.optim import adamw
from byteps_tpu_torch.server.engine import HostPSBackend
from byteps_tpu_torch.server.ps_mode import PSGradientExchange
from byteps_tpu_torch.training import DistributedTrainer

README = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
          "ef_type": "vanilla", "momentum_type": "nesterov"}
SIZE = 4099
KWARGS = {
    "onebit": {"compressor_type": "onebit",
               "compressor_onebit_scaling": "true"},
    "onebit_ef": dict(README),          # the server chain drops momentum
    "topk": {"compressor_type": "topk", "compressor_k": "0.02"},
    "randomk": {"compressor_type": "randomk", "compressor_k": "0.02",
                "seed": "17"},
    "dithering_ef": {"compressor_type": "dithering", "compressor_k": "6",
                     "seed": "4", "ef_type": "vanilla"},
}

_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK",
             "BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", "BPS_COORDINATOR_ADDRESS",
             "DMLC_PS_ROOT_URI", "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC",
             "BPS_SERVER_ADDRS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
             "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF", "BPS_COMPRESS",
             "BPS_NATIVE_CODEC")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _PORT_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tdev.reset_probe()
    yield
    tdev.reset_probe()
    torch.set_num_threads(n)


@pytest.fixture(params=["numpy", "native"])
def route(request, monkeypatch):
    monkeypatch.setenv("BPS_NATIVE_CODEC",
                       "0" if request.param == "numpy" else "1")
    return request.param


# ------------------------------------------------------------ the server

def _two_worker_rounds(backend, codecs, kwargs, data):
    """Two worker threads push their compressed rounds into one backend
    (``num_workers=2``) and pull each round: every pulled payload."""
    key = (3 << 16) | 1
    backend.init_key(key, SIZE * 4, "float32", compression=kwargs)
    pulled = [[None] * len(data) for _ in (0, 1)]
    errors = []

    def worker(w):
        try:
            for r, rnd in enumerate(data):
                backend.push_bytes(key, codecs[w].compress(rnd[w]))
                pulled[w][r] = backend.pull_bytes(key, round=r + 1,
                                                  timeout_ms=20000)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    backend.close()
    assert not errors, errors
    return pulled


@pytest.mark.parametrize("case", sorted(KWARGS))
def test_two_worker_compressed_sum_is_the_jax_servers(case, route):
    """Three rounds: each worker compresses with its own chain and pushes;
    the server decompresses both, sums and recompresses the round once
    through its chain; both workers pull the same bytes, which are the JAX
    package's server's."""
    kwargs = KWARGS[case]
    rng = np.random.RandomState(len(case))
    data = [[(rng.randn(SIZE) * (r + 1)).astype(np.float32) for _ in (0, 1)]
            for r in range(3)]
    ours = _two_worker_rounds(
        HostPSBackend(num_servers=1, num_workers=2, engine_threads=2),
        [thost.create_host_chain(kwargs, SIZE) for _ in (0, 1)], kwargs,
        data)
    ref = _two_worker_rounds(
        JBackend(num_servers=1, num_workers=2, engine_threads=2),
        [jhost.create_host_chain(kwargs, SIZE) for _ in (0, 1)], kwargs,
        data)
    for r in range(len(data)):
        assert ours[0][r] == ours[1][r]
        assert ours[0][r] == ref[0][r], r


def test_compressed_key_refuses_fused_payloads():
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        with pytest.raises(ValueError, match="fused"):
            be.init_key(1, SIZE * 4, compression=KWARGS["onebit"],
                        fused=True)
        be.init_key(2, SIZE * 4, compression=KWARGS["onebit"])
        with pytest.raises(KeyError, match="legacy compression"):
            be.push_fused(2, b"\0" * 64)
        # a registration with other kwargs is a misconfigured worker
        with pytest.raises(ValueError, match="disagree"):
            be.init_key(2, SIZE * 4, compression=KWARGS["topk"])
    finally:
        be.close()


# ---------------------------------------------------------- the exchange

def _tree(seed):
    rng = np.random.RandomState(seed)
    shapes = [(64, 33), (900,), (17, 5, 12), (3000,), (1,)]
    return {f"l{i}": (rng.randn(*s) * (i + 1)).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("plane", ["none", "int8"])
def test_exchange_chains_are_the_jax_exchanges(plane, route):
    """A declaration with the README's kwargs, beside the fused plane or
    without it: its buckets at or above the floor take their chains and
    stay out of the plane, the smaller one goes dense; three rounds
    of summed leaves are the JAX exchange's, bit for bit; the chains'
    stages and wire bytes are counted."""
    trees = [_tree(30 + r) for r in range(3)]
    floor = 6 << 10
    reg = NameRegistry()
    reg.declare("legacy", **README)
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=8 << 10, registry=reg,
                            min_compress_bytes=floor, compress=plane,
                            device="cpu")
    m = get_registry()
    c0, d0 = m.stage("PS_COMPRESS").count, m.stage("PS_DECOMPRESS").count
    p0 = m.counter("ps/push_bytes").value
    try:
        got = [[o.copy() for o in ex.exchange(
            [(k, torch.from_numpy(v)) for k, v in t.items()], name="legacy")]
            for t in trees]
        (_, keyed), = ex._plans.values()
        sizes = {k: b.size * 4 for k, b in keyed}
        chained = {k for k in sizes if sizes[k] >= floor}
        assert set(ex._chains) == chained and 1 < len(chained) < len(keyed)
        assert ex.n_chained() == len(chained)
        for k in chained:
            assert be.compressed.has(k)
            assert ex._cplane is None or not ex._cplane.active(k)
        if plane != "none":
            # the buckets under the floor are under the plane's floor too
            assert ex.n_compressed() == 0
        wire = sum(ex._chains[k].payload_nbytes() for k in chained) + sum(
            s for k, s in sizes.items() if k not in chained)
        assert m.counter("ps/push_bytes").value - p0 == 3 * wire
        assert m.stage("PS_COMPRESS").count - c0 == 3 * len(chained)
        assert m.stage("PS_DECOMPRESS").count - d0 == 3 * len(chained)
    finally:
        ex.close()
        be.close()
    import jax.numpy as jnp
    jreg = JNameRegistry()
    jreg.declare("legacy", **README)
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    jex = JExchange(jbe, partition_bytes=8 << 10, registry=jreg,
                    min_compress_bytes=floor, compress=plane)
    try:
        for r, (t, g) in enumerate(zip(trees, got)):
            want = jex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                                name="legacy")
            for o, k in zip(g, sorted(t)):
                assert o.tobytes() == np.asarray(want[k]).tobytes(), (r, k)
        assert sorted(jex._chains) == sorted(chained)
    finally:
        jex.close()
        jbe.close()


def test_legacy_keys_skip_the_fused_plane():
    """With the plane on and no floor, a legacy declaration keeps every
    bucket on its chain; another tree in the same exchange rides the
    plane."""
    reg = NameRegistry()
    reg.declare("legacy", compressor_type="onebit")
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=8 << 10, registry=reg,
                            min_compress_bytes=0, compress="int8",
                            device="cpu")
    try:
        g = torch.from_numpy(np.random.RandomState(7).randn(3000)
                             .astype(np.float32))
        ex.exchange([("g", g)], name="legacy")
        assert ex._chains
        assert not any(ex._cplane.active(k) for k in ex._chains)
        assert ex.n_compressed() == 0
        ex.exchange([("h", g)], name="plain")
        assert ex.n_compressed() >= 1
    finally:
        ex.close()
        be.close()


# ----------------------------------------------------------- the trainer

WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
SEQ, BATCH, MAX_PRED, LR, EPS, STEPS = 64, 4, 10, 1e-3, 1e-6, 3


def _batch(i):
    return tbert.synth_mlm_batch(np.random.RandomState(i), BATCH, SEQ,
                                 WIDTH["vocab_size"])


def test_bert_tiny_with_the_readme_kwargs_matches_the_jax_trainer(
        monkeypatch):
    """BERT (2 layers, hidden 128) through both trainers in PS mode with
    the README's onebit kwargs, 8 buckets of 256 KiB, every one compressed
    (``BPS_MIN_COMPRESS_BYTES=0``), 3 steps on one seeded batch."""
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    monkeypatch.setenv("BPS_MIN_COMPRESS_BYTES", "0")
    monkeypatch.setenv("BPS_APPLY_CHUNKED", "0")
    monkeypatch.setenv("BPS_PARTITION_BYTES", str(256 << 10))
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    jcfg = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
    tcfg = tbert.bert_config(dtype="float32", **WIDTH)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    try:
        mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
        jbps.init(mesh=mesh)
        jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, jcfg, b,
                                                    max_predictions=MAX_PRED),
                        jp, optax.adamw(LR, eps=EPS), mesh=mesh,
                        compression=dict(README))
        jl = [float(jt.step(_batch(0))) for _ in range(STEPS)]
        jparams = jax.tree.map(np.asarray, jt.params)
        jchains = len(jt._ps_exchange._chains)
        jbps.shutdown()

        bps.init(device="cpu")
        model = tbert.Transformer(tcfg)
        model.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, jp)))
        tt = DistributedTrainer(
            lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED),
            model, adamw(model.parameters(), LR, eps=EPS), device="cpu",
            compression=dict(README))
        m = get_registry()
        p0 = m.counter("ps/push_bytes").value
        tl = [tt.step(_batch(0)).item() for _ in range(STEPS)]
        pushed = m.counter("ps/push_bytes").value - p0
        ex = tt.ps_exchange
        assert ex.n_chained() == jchains == 8
        assert GlobalState.get().registry.get(tt._name) \
            .compression_kwargs == README
        dense = 4 * sum(p.numel() for p in model.parameters())
        assert pushed == STEPS * sum(c.payload_nbytes()
                                     for c in ex._chains.values())
        assert pushed < STEPS * dense / 25      # onebit: 1/32 and a scale
        tparams = convert.params_to_jax_layout(model)
    finally:
        bps.shutdown()
        jbps.shutdown()
        torch.set_float32_matmul_precision(prec)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    a, b = (np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(v)])
            for v in (tparams, jparams))
    assert a.shape == b.shape
    off = np.count_nonzero(np.abs(a - b) > 1e-5)
    assert off <= a.size // 1000, off
