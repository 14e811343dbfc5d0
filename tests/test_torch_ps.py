"""The port's parameter-server path held against the JAX package on the
CPU: its own copy of the C++ summation server, the in-process backend, and
``PSGradientExchange`` with the fused compression plane.

The port encodes on the gradients' device (``BPS_COMPRESS_DEVICE=1``); on
CPU tensors that runs the kernels' plain versions. The JAX package runs its
host codec (``BPS_COMPRESS_DEVICE=0``) or its device encode in Pallas
interpret mode. The same seeded numpy gradients go through both.

Tolerance: none where the contract is bytes (sums, payloads, every round's
output). The fp8 convergence test states its own bound.
"""

import threading

import numpy as np
import pytest
import torch

from byteps_tpu.common.naming import NameRegistry as JNameRegistry
from byteps_tpu.compress import device as jdev
from byteps_tpu.server.engine import HostPSBackend as JBackend
from byteps_tpu.server.ps_mode import PSGradientExchange as JExchange
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.server import engine as tengine
from byteps_tpu_torch.server.engine import HostPSBackend
from byteps_tpu_torch.server.ps_mode import PSGradientExchange

CODECS = ("none", "int8", "fp8_e4m3", "fp8_e5m2", "fp16", "topk")
# one code step relative to the bucket's largest value (fp16 and topk run
# the host codec on both sides, whose rounds are bit for bit)
STEP = {"none": 0.0, "int8": 1 / 127, "fp8_e4m3": 2.0 ** -3,
        "fp8_e5m2": 2.0 ** -2, "fp16": 0.0, "topk": 0.0}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    for name in ("BPS_COMPRESS", "BPS_PS_PIPELINE", "BPS_MAX_LAG",
                 "BPS_WATCHDOG_SEC", "BPS_COMPRESS_EF"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    tdev.reset_probe()
    jdev.reset_probe()
    yield
    tdev.reset_probe()
    jdev.reset_probe()
    torch.set_num_threads(n)


def _grads(seed, shapes):
    """Named gradients in the JAX tree's flatten order (sorted names)."""
    rng = np.random.RandomState(seed)
    return {f"l{i}": (rng.randn(*s) * (i + 1)).astype(np.float32)
            for i, s in enumerate(shapes)}


SHAPES = [(64, 33), (900,), (17, 5, 12), (3000,), (1,)]


# ------------------------------------------------------------ the server

@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int32"])
def test_server_copy_sums_two_workers_like_the_jax_server(dtype):
    """Two threads push into one backend with ``num_workers=2`` and pull
    each round: the sums equal the JAX package's server, bit for bit."""
    rng = np.random.RandomState(3)
    keys = [(0 << 16) | 0, (0 << 16) | 1, (1 << 16) | 0]
    sizes = [1, 1000, 4097]
    data = [[[(rng.randn(n) * 100).astype(dtype) for n in sizes]
             for _ in range(2)] for _ in range(3)]           # round, worker

    def run(backend):
        for k, n in zip(keys, sizes):
            backend.init_key(k, n * np.dtype(dtype).itemsize, dtype)
        outs = [[None] * 2 for _ in data]
        errors = []

        def worker(w):
            try:
                for r, rnd in enumerate(data):
                    for k, x in zip(keys, rnd[w]):
                        backend.push(k, x)
                    got = []
                    for k, x in zip(keys, rnd[w]):
                        out = np.empty_like(x)
                        backend.pull(k, out, round=r + 1, timeout_ms=20000)
                        got.append(out)
                    outs[r][w] = got
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        backend.close()
        assert not errors, errors
        return outs

    port = run(HostPSBackend(num_servers=1, num_workers=2, engine_threads=2))
    ref = run(JBackend(num_servers=1, num_workers=2, engine_threads=2))
    for r in range(len(data)):
        for w in (0, 1):
            for got, want, x0, x1 in zip(port[r][w], ref[r][w],
                                         data[r][0], data[r][1]):
                assert got.tobytes() == want.tobytes()
                assert got.tobytes() == (x0 + x1).astype(dtype).tobytes()


def test_native_pack_unpack_and_reduce():
    rng = np.random.RandomState(4)
    src = [rng.randn(n).astype(np.float32) for n in (10, 1, 300)]
    segs = [(0, 2, 5), (1, 0, 1), (2, 100, 150)]      # leaf, offset, length
    buf = np.empty(sum(s[2] for s in segs), np.float32)
    offs = np.cumsum([0] + [s[2] for s in segs])[:-1]
    tengine.pack_segments([src[i].ctypes.data + o * 4 for i, o, _ in segs],
                          [int(b) * 4 for b in offs], [n * 4 for *_, n in segs],
                          buf)
    want = np.concatenate([src[i][o:o + n] for i, o, n in segs])
    np.testing.assert_array_equal(buf, want)
    dst = [np.zeros_like(s) for s in src]
    tengine.unpack_segments(buf, [int(b) * 4 for b in offs],
                            [dst[i].ctypes.data + o * 4 for i, o, _ in segs],
                            [n * 4 for *_, n in segs])
    for (i, o, n) in segs:
        np.testing.assert_array_equal(dst[i][o:o + n], src[i][o:o + n])
    a, b = rng.randn(1000).astype(np.float32), rng.randn(1000).astype(np.float32)
    want = a + b
    tengine.reduce_sum_inplace(a, b)
    assert a.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        tengine.reduce_sum_inplace(a, b.astype(np.float64))


# ---------------------------------------------------------- the exchange

def _port_exchange(codec, dev=True, backend=None, registry=None, **kw):
    be = backend or HostPSBackend(num_servers=1, num_workers=1,
                                  engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=kw.pop("partition_bytes",
                                                       16 << 10),
                            registry=registry, min_compress_bytes=0,
                            compress=codec,
                            device="cpu" if dev else None, **kw)
    return be, ex


def _port_run(ex, trees, name="g"):
    return [[o.copy() for o in ex.exchange(
        [(k, torch.from_numpy(v)) for k, v in t.items()], name=name)]
        for t in trees]


def _jax_run(codec, trees, dev, monkeypatch, name="g"):
    import jax.numpy as jnp
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1" if dev else "0")
    jdev.reset_probe()
    be = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        ex = JExchange(be, partition_bytes=16 << 10, min_compress_bytes=0,
                       compress=codec)
        outs = []
        for t in trees:
            got = ex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                              name=name)
            outs.append([np.asarray(got[k]).copy() for k in sorted(t)])
        ex.close()
        return outs
    finally:
        be.close()
        monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")


@pytest.mark.parametrize("codec", CODECS)
def test_exchange_is_the_jax_exchange_every_round(codec, monkeypatch):
    """Three rounds with error feedback over five leaves cut into several
    buckets (some spanning leaves): every round's summed leaves equal the
    JAX package's exchange with its host codec, bit for bit. Against its
    device encode the first round is bit for bit too. Later rounds fold
    in a residual that XLA computes as one FMA (``test_torch_quant.py``):
    one ulp off the host codec's, which can move a bucket's amax and with
    it the bucket's scale, so there they agree within two code steps of
    the leaf's largest value."""
    trees = [_grads(10 + r, SHAPES) for r in range(3)]
    be, ex = _port_exchange(codec)
    try:
        got = _port_run(ex, trees)
        if codec != "none":
            assert ex.n_compressed() > 1
    finally:
        ex.close()
        be.close()
    for dev in (False, True):
        ref = _jax_run(codec, trees, dev, monkeypatch)
        for r, (g, w) in enumerate(zip(got, ref)):
            a, b = np.concatenate([x.ravel() for x in g]), \
                np.concatenate([x.ravel() for x in w])
            assert [x.shape for x in g] == [x.shape for x in w]
            if dev and r > 0:
                for x, y in zip(g, w):
                    np.testing.assert_allclose(
                        x, y, rtol=0, atol=2 * STEP[codec] * np.abs(y).max())
            else:
                assert a.tobytes() == b.tobytes(), (codec, dev, r)


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3"])
def test_device_encode_exchange_bitwise_vs_host(codec, monkeypatch):
    """The device encode (plain versions on CPU tensors) against the
    port's host codec over 3 EF rounds: bit-identical outputs, while
    ``ps/d2h_bytes`` drops to the payload size."""
    g = np.random.RandomState(61).randn(8000).astype(np.float32)
    reg = get_registry()

    def run(dev):
        monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1" if dev else "0")
        be, ex = _port_exchange(codec, dev=dev)
        d0 = reg.counter("ps/d2h_bytes").value
        try:
            outs = _port_run(ex, [{"g": g * (r + 1)} for r in range(3)],
                             name="dv")
        finally:
            ex.close()
            be.close()
        return outs, reg.counter("ps/d2h_bytes").value - d0

    host, host_d2h = run(False)
    dev, dev_d2h = run(True)
    for a, b in zip(host, dev):
        assert a[0].tobytes() == b[0].tobytes()
    # dense 32000 B a bucket against 8000 code bytes + 4 a round
    assert 0 < dev_d2h < 0.3 * host_d2h, (dev_d2h, host_d2h)


def test_fp8_device_encode_with_ef_converges():
    """fp8 + EF + device encode: residuals stay on the device and commit
    on pull, so the mean of 24 rounds' outputs converges on the input
    (EF telescoping: |mean - g| <= 0.05 here); the per-layer d2h counters
    register."""
    g = np.random.RandomState(62).randn(8000).astype(np.float32)
    be, ex = _port_exchange("fp8_e4m3")
    try:
        acc = np.zeros(8000)
        for _ in range(24):
            acc += ex.exchange([("g", torch.from_numpy(g))], name="d8")[0]
        key = next(iter(ex._cplane._keys.values()))
        assert torch.is_tensor(key.residual)
    finally:
        ex.close()
        be.close()
    np.testing.assert_allclose(acc / 24, g, atol=0.05)
    reg = get_registry()
    layers = [n for n in reg.names() if n.startswith("ps/d2h_bytes/d8.")]
    assert layers and any(reg.counter(n).value > 0 for n in layers)


@pytest.mark.parametrize("codec", ["none", "int8", "fp8_e4m3"])
def test_two_workers_over_one_backend_are_the_jax_packages(codec,
                                                           monkeypatch):
    """Two workers on threads, each with its own exchange and registry,
    over one backend with ``num_workers=2``: two rounds, each worker gets
    the same sum, equal bit for bit to the JAX package doing the same."""
    import jax.numpy as jnp
    trees = [[_grads(100 * w + r, SHAPES[:3]) for r in range(2)]
             for w in (0, 1)]

    def run(make_backend, make_exchange, plan, call):
        be = make_backend()
        exs = [make_exchange(be) for _ in (0, 1)]
        # both workers declare their keys before either pushes: a key's
        # declaration on the in-process server is a new tenancy that drops
        # arrivals already buffered (standalone servers are declared once)
        for ex in exs:
            plan(ex, trees[0][0])
        outs, errors = [None, None], []

        def worker(w):
            try:
                outs[w] = [call(exs[w], t) for t in trees[w]]
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for ex in exs:
            ex.close()
        be.close()
        assert not errors, errors
        return outs

    port = run(lambda: HostPSBackend(num_servers=1, num_workers=2,
                                     engine_threads=2),
               lambda be: _port_exchange(codec, backend=be,
                                         registry=NameRegistry())[1],
               lambda ex, t: ex._plan([(k, torch.from_numpy(v))
                                       for k, v in t.items()], "g"),
               lambda ex, t: [o.copy() for o in ex.exchange(
                   [(k, torch.from_numpy(v)) for k, v in t.items()],
                   name="g")])
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "0")
    ref = run(lambda: JBackend(num_servers=1, num_workers=2,
                               engine_threads=2),
              lambda be: JExchange(be, partition_bytes=16 << 10,
                                   registry=JNameRegistry(),
                                   min_compress_bytes=0, compress=codec),
              lambda ex, t: ex.plan_for({k: jnp.asarray(v)
                                         for k, v in t.items()}, "g"),
              lambda ex, t: [np.asarray(v).copy() for _, v in sorted(
                  ex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                              name="g").items())])
    for r in range(2):
        for a, b, c in zip(port[0][r], port[1][r], ref[0][r]):
            assert a.tobytes() == b.tobytes() == c.tobytes(), (codec, r)
    if codec == "none":
        for a, x0, x1 in zip(port[0][0], *(t[0].values() for t in trees)):
            assert a.tobytes() == (x0 + x1).tobytes()


@pytest.mark.parametrize("depth", [1, 4])
def test_serial_and_pipelined_routes_agree(depth):
    trees = [_grads(30 + r, SHAPES) for r in range(2)]
    runs = []
    for d in (depth, 2):
        be, ex = _port_exchange("int8", pipeline_depth=d,
                                partition_bytes=4 << 10)
        try:
            runs.append(_port_run(ex, trees))
        finally:
            ex.close()
            be.close()
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("n1,dense", [(4096, 100), (5000, 100 + 5000)],
                         ids=["apart", "shared"])
def test_host_leaves_of_a_mixed_plan_are_copied_and_counted(n1, dense):
    """A bucket under the compression floor stays dense on the host while
    the other encodes on the device. ``ps/d2h_bytes`` counts the dense
    bucket and the payload, plus, where the two buckets share a leaf, the
    shared leaf's device-encoded segments too: that leaf crosses to the
    host whole anyway."""
    reg = get_registry()
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=16 << 10,
                            min_compress_bytes=8 << 10, compress="int8",
                            device="cpu")
    t = _grads(7, [(100,), (n1,)])
    d0 = reg.counter("ps/d2h_bytes").value
    try:
        out = ex.exchange([(k, torch.from_numpy(v)) for k, v in t.items()],
                          name="mixed")
    finally:
        ex.close()
        be.close()
    np.testing.assert_array_equal(out[0], t["l0"])      # dense, exact
    # the compressed bucket: the first 4096 elements of l1
    q = out[1][:4096] - t["l1"][:4096]
    assert np.abs(q).max() <= 2 * np.abs(t["l1"][:4096]).max() / 127
    np.testing.assert_array_equal(out[1][4096:], t["l1"][4096:])
    assert ex.n_compressed() == 1
    assert reg.counter("ps/d2h_bytes").value - d0 == 4 * dense + 4096 + 4


@pytest.mark.parametrize("env,value,exc", [
    ("BPS_MAX_LAG", "2", None),
    ("BPS_WATCHDOG_SEC", "5", None),
    ("BPS_COMPRESS", "auto", None),
])
def test_exchange_refuses_what_is_not_ported(env, value, exc, monkeypatch):
    """Nothing left here raises. Bounded staleness, the stall watchdog and
    the auto controller, refused until they were ported, now construct
    (``test_torch_lag_exchange.py``, ``test_torch_flight_watchdog.py``,
    ``test_torch_compress_controller.py`` hold them against the JAX
    package); K=2 allocates no lag store before the first plan."""
    from byteps_tpu_torch.compress.controller import CompressController
    monkeypatch.setenv(env, value)
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        if exc is not None:
            with pytest.raises(exc, match="ROADMAP"):
                PSGradientExchange(be)
            return
        ex = PSGradientExchange(be)
        if env == "BPS_MAX_LAG":
            assert ex.plane.max_lag == 2 and ex.plane.gate.depth == 2
            assert be._stale is None
        elif env == "BPS_WATCHDOG_SEC":
            assert ex._watchdog_sec == 5.0 and ex._watchdog is None
        else:
            assert isinstance(ex._cplane.controller, CompressController)
        ex.close()
    finally:
        be.close()


def test_pp_stages_is_refused_by_both_trainers(monkeypatch):
    """``BPS_PP_STAGES=2``: the JAX ``DistributedTrainer`` refuses to run
    its whole-model step on a pipeline stage, and so does the port's,
    with and without ``bps.init()``."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    import byteps_tpu_torch as bps
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu.training import DistributedTrainer as JaxTrainer
    from byteps_tpu_torch.training import DistributedTrainer
    for name in ("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS", "BPS_NUM_WORKER",
                 "DMLC_NUM_WORKER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BPS_PP_STAGES", "2")
    stem = "BPS_PP_STAGES=2: DistributedTrainer is the data-parallel step"
    mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jbps.init(mesh=mesh)
    try:
        with pytest.raises(ValueError, match=stem):
            JaxTrainer(lambda p, b: jnp.sum(p["w"] * b), {"w": jnp.ones(3)},
                       optax.sgd(0.1), mesh=mesh)
    finally:
        jbps.shutdown()
    model = torch.nn.Linear(3, 1)
    with pytest.raises(ValueError, match=stem):
        DistributedTrainer(lambda m, b: m(b).sum(), model,
                           torch.optim.SGD(model.parameters(), 0.1),
                           device="cpu")
    bps.init(device="cpu")
    try:
        with pytest.raises(ValueError, match=stem):
            DistributedTrainer(lambda m, b: m(b).sum(), model,
                               torch.optim.SGD(model.parameters(), 0.1))
    finally:
        bps.shutdown()


def test_server_builds_without_openmp_and_sums_alike(monkeypatch, tmp_path):
    """A g++ that cannot link OpenMP builds the engine without it (its
    OpenMP use is pragmas only); that build sums bit for bit alike."""
    import ctypes

    from byteps_tpu_torch.ops import _build_host
    assert _build_host.openmp_flags("false") == ["-Wno-unknown-pragmas"]
    monkeypatch.setattr(_build_host, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build_host, "openmp_flags",
                        lambda cxx: ["-Wno-unknown-pragmas"])
    flags = _build_host.CXX_FLAGS
    assert _build_host._lib_path(flags + ["-fopenmp"]) != \
        _build_host._lib_path(flags + ["-Wno-unknown-pragmas"])
    lib = ctypes.CDLL(str(_build_host.build()))
    fn = lib.bps_reduce_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                   ctypes.c_int]
    rng = np.random.RandomState(8)
    a, b = rng.randn(100_003).astype(np.float32), \
        rng.randn(100_003).astype(np.float32)
    want = a + b
    fn(a.ctypes.data, b.ctypes.data, a.nbytes, 0)
    assert a.tobytes() == want.tobytes()


def test_key_placement_is_the_jax_packages_djb2():
    """Keys land on the shard the JAX package's default placement picks."""
    from byteps_tpu.common.naming import place_key as jplace
    from byteps_tpu_torch.common.naming import place_key
    for key in [0, 1, 7, (3 << 16) | 2, (1234 << 16) | 65535]:
        for n in (1, 2, 3, 8):
            assert place_key(key, n) == jplace(key, n, "djb2"), (key, n)


def test_fused_push_of_an_undeclared_key_raises():
    """A key not declared ``fused=True`` takes the engine-side route, as
    ``byteps_tpu/server/engine.py:782-797`` does: a payload that does not
    fit the key's store raises ``CodecError`` before a byte lands, one that
    fits is decoded into the engine's sum. A fused declaration hands the
    key to the homogeneous store."""
    from byteps_tpu_torch.compress import wire
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    try:
        be.init_key(5, 64 * 4, "float32")
        payload = wire.encode(wire.CODEC_INT8, np.ones(64, np.float32))
        with pytest.raises(wire.CodecError, match="expects 64"):
            be.push_fused(5, wire.encode(wire.CODEC_INT8,
                                         np.ones(65, np.float32)))
        assert be.round(5) == 0
        be.push_fused(5, payload)
        out = np.empty(64, np.float32)
        be.pull(5, out, round=1)
        assert out.tobytes() == wire.decode(payload, 64).tobytes()
        be.init_key(5, 64 * 4, "float32", fused=True)
        be.push_fused(5, payload)
        got = be.pull_fused(5, 64 * 4, "float32", wire.CODEC_INT8, round=1)
        assert got == wire.encode(wire.CODEC_INT8, np.ones(64, np.float32),
                                  seed=wire.sr_seed(5, 1))
    finally:
        be.close()
