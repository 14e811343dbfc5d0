"""The port's int8 and fp8 quantizers, its wire codec and its device encode
held against the JAX package on the CPU, bit for bit.

On the CPU the port's ``int8_quantize``, ``int8_dequantize`` and
``fp8_sr_quantize`` take their plain versions (the Hopper kernels run only
on the card, ``test_torch_kernels_cuda.py``); the JAX Pallas kernels run in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them. The same
seeded numpy inputs go through both, and through the JAX package's numpy
codec (``compress/wire.py``, ``ops/compression/fp8sr.py``), which the port
keeps its own copies of.

Tolerance: none. The contract is bytes: payloads, codes, scales and
error-feedback residuals must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.compress import device as jdev
from byteps_tpu.compress import wire as jwire
from byteps_tpu.ops.compression import fp8sr as jfp8
from byteps_tpu.ops.compression import pallas_kernels as jpk
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.compress import wire as twire
from byteps_tpu_torch.ops.compression import fp8sr as tfp8
from byteps_tpu_torch.ops.compression import kernels as qk

SIZES = (1, 127, 128 * 256 + 3, 1_024_000)
SEEDS = (0, 0xFFFFFFFF)
KINDS = (tfp8.E4M3, tfp8.E5M2)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vectors():
    """(name, x, scale): the probe's adversarial vector and seeded normal
    vectors, each at its codec scale; one with scale 0 (taken as 1.0)."""
    x = tdev.probe_vector()
    yield "probe", x, twire.amax_scale(x, 127.0)
    for n in SIZES:
        x = np.random.RandomState(n).randn(n).astype(np.float32) * 3
        yield f"n{n}", x, twire.amax_scale(x, 127.0)
    yield "scale0", np.random.RandomState(5).randn(300).astype(np.float32), \
        np.float32(0.0)


VECTORS = list(_vectors())
IDS = [v[0] for v in VECTORS]


def _bytes(t) -> bytes:
    return (t.numpy() if torch.is_tensor(t) else np.asarray(t)).tobytes()


@pytest.mark.parametrize("name,x,scale", VECTORS, ids=IDS)
def test_int8_quantize_plain_is_the_pallas_kernel_and_the_codec(name, x,
                                                                scale):
    got = qk.int8_quantize(torch.from_numpy(x), scale)
    assert got.dtype == torch.int8 and got.shape == x.shape
    ref = jpk.int8_quantize(jnp.asarray(x), jnp.float32(scale))
    assert _bytes(got) == _bytes(ref)
    s = scale if scale > 0 else np.float32(1.0)
    assert _bytes(got) == np.clip(np.rint(x / s), -127, 127) \
        .astype(np.int8).tobytes()


@pytest.mark.parametrize("name,x,scale", VECTORS, ids=IDS)
def test_int8_dequantize_plain_is_the_pallas_kernel(name, x, scale):
    s = scale if scale > 0 else np.float32(1.0)
    q = np.clip(np.rint(x / s), -127, 127).astype(np.int8)
    got = qk.int8_dequantize(torch.from_numpy(q), s)
    assert got.dtype == torch.float32
    ref = jpk.int8_dequantize(jnp.asarray(q), jnp.float32(s))
    assert _bytes(got) == _bytes(ref)
    assert _bytes(got) == (q.astype(np.float32) * s).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS, ids=["e4m3", "e5m2"])
@pytest.mark.parametrize("name,x,scale", VECTORS, ids=IDS)
def test_fp8_sr_plain_is_the_pallas_kernel_and_the_codec(name, x, scale,
                                                         kind, seed):
    s = (twire.amax_scale(x, tfp8.fmt_max(kind)) if scale > 0
         else np.float32(0.0))
    got = qk.fp8_sr_quantize(torch.from_numpy(x), s, seed, kind)
    assert got.dtype == torch.uint8 and got.shape == x.shape
    ref = jpk.fp8_sr_quantize(jnp.asarray(x), jnp.float32(s),
                              jnp.uint32(seed), kind)
    assert _bytes(got) == _bytes(ref)
    host_s = s if s > 0 else np.float32(1.0)
    assert _bytes(got) == jfp8.sr_quantize_bits(x, host_s, kind, seed) \
        .tobytes()
    assert _bytes(got) == tfp8.sr_quantize_bits(x, host_s, kind, seed) \
        .tobytes()


@pytest.mark.parametrize("kind", KINDS, ids=["e4m3", "e5m2"])
def test_fp8_decode_bits_is_ml_dtypes_on_every_code(kind):
    codes = np.arange(256, dtype=np.uint8)
    got, ref = tfp8.decode_bits(codes, kind), jfp8.decode_bits(codes, kind)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert got[ok].tobytes() == ref[ok].tobytes()
    # the device decode (plain tensor ops) on every code an encode makes
    dev = tdev._fp8_decode_device(torch.from_numpy(codes), kind).numpy()
    finite = np.isfinite(ref)
    assert dev[finite].tobytes() == ref[finite].tobytes()


@pytest.mark.parametrize("cid", range(len(twire.LEVELS)), ids=twire.LEVELS)
def test_port_wire_copy_gives_the_jax_packages_bytes(cid):
    x = np.random.RandomState(cid).randn(5000).astype(np.float32)
    x[:9] = [0.0, -0.0, 0.5, -0.5, 1.0, 3.5, -3.5, 1e-30, -1e-30]
    got = twire.encode(cid, x, seed=twire.sr_seed(7 << 16, 3))
    assert got == jwire.encode(cid, x, seed=jwire.sr_seed(7 << 16, 3))
    assert twire.peek(got) == jwire.peek(got)
    assert twire.validate(got, x.size) == cid
    np.testing.assert_array_equal(twire.decode(got, x.size),
                                  jwire.decode(got, x.size))
    assert twire.wire_nbytes(cid, x.size, np.float32) == len(got)


def test_port_wire_refuses_torn_payloads_loudly():
    p = twire.encode(twire.CODEC_INT8, np.ones(64, np.float32))
    with pytest.raises(twire.CodecError, match="magic"):
        twire.decode(b"\0\0" + p[2:])
    with pytest.raises(twire.CodecError, match="expects"):
        twire.decode(p, expect_elems=65)
    with pytest.raises(twire.CodecError, match="body"):
        twire.validate(p[:-1], 64)


def test_sr_seed_and_scale_rule_are_the_jax_packages():
    for key, rnd in ((0, 1), (3 << 16 | 7, 12), (2 ** 40, 2 ** 33)):
        assert twire.sr_seed(key, rnd) == jwire.sr_seed(key, rnd)
    for amax in (0.0, -1.0, 1e-38, 3.3, 448.0, float("inf")):
        for denom in (127.0, 448.0, 57344.0):
            assert twire.scale_from_amax(amax, denom).tobytes() == \
                jwire.scale_from_amax(amax, denom).tobytes()


def _parts(x, split):
    """The same bucket as two leaves (a split at ``split``) on both sides."""
    a, b = x[:split], x[split:]
    return ([(torch.from_numpy(a), 0, a.size), (torch.from_numpy(b), 0, b.size)],
            [(jnp.asarray(a), 0, a.size), (jnp.asarray(b), 0, b.size)])


@pytest.mark.parametrize("ef", [False, True], ids=["no_ef", "ef"])
@pytest.mark.parametrize("cid", tdev.DEVICE_CODECS,
                         ids=["int8", "fp8_e4m3", "fp8_e5m2"])
def test_device_encode_is_the_jax_device_encode_and_the_codec(cid, ef):
    """``encode_bucket`` on CPU tensors (the plain versions) against the
    JAX ``encode_bucket`` (Pallas interpret) and ``wire.encode``: payload
    and new residual byte for byte, with and without a residual."""
    rng = np.random.RandomState(cid)
    x = rng.randn(40_000).astype(np.float32)
    r = (rng.randn(x.size) * 1e-2).astype(np.float32) if ef else None
    seed = twire.sr_seed(5 << 16, 2)
    tparts, jparts = _parts(x, 12_345)
    got, got_r, d2h = tdev.encode_bucket(
        tparts, x.size, cid, seed, None if r is None else torch.from_numpy(r),
        ef)
    ref, ref_r, ref_d2h = jdev.encode_bucket(
        jparts, x.size, cid, seed, None if r is None else jnp.asarray(r), ef)
    assert got == ref and d2h == ref_d2h == x.size + 4
    assert got == jwire.encode(cid, x + r if ef else x, seed=seed)
    if ef:
        # the residual is exactly what the host codec leaves behind
        xr = x + r
        host = xr - jwire.decode(got, x.size, np.float32)
        assert got_r.numpy().tobytes() == host.tobytes()
        # XLA fuses the JAX encode's x - q·s into one FMA, which skips the
        # rounding of q·s: its residual may differ from the host codec's
        # (and the port's) by that rounding, at most one ulp of x + r
        tol = np.spacing(np.abs(xr))
        assert np.all(np.abs(got_r.numpy() - np.asarray(ref_r)) <= tol)
    else:
        assert got_r is None


def test_device_encode_probe_passes_on_the_cpu(monkeypatch):
    assert tdev._probe("cpu") is True
    tdev.reset_probe()
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "auto")
    assert tdev.device_encode_enabled("cpu") is False     # auto: card only
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    assert tdev.device_encode_enabled("cpu") is True
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "0")
    assert tdev.device_encode_enabled("cpu") is False
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "sometimes")
    with pytest.raises(ValueError, match="BPS_COMPRESS_DEVICE"):
        tdev.device_encode_enabled("cpu")
    tdev.reset_probe()


@pytest.mark.parametrize("value", ["0", "off"])
def test_host_codec_is_refused_for_gradients_on_the_card(value, monkeypatch):
    """``BPS_COMPRESS_DEVICE=0`` picks the host codec for CPU tensors only:
    for CUDA gradients it raises before anything is probed or copied."""
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", value)
    tdev.reset_probe()
    with pytest.raises(ValueError, match="never copied dense"):
        tdev.device_encode_enabled(torch.device("cuda", 0))
    assert tdev.device_encode_enabled("cpu") is False


def test_device_encode_probe_mismatch_raises_instead_of_falling_back(
        monkeypatch):
    """The JAX package falls back to the host codec on a probe mismatch;
    the port raises."""
    real = qk.int8_quantize

    def off_by_one(x, scale):
        q = real(x, scale)
        q[0] = q[0] + 1
        return q

    monkeypatch.setattr(qk, "int8_quantize", off_by_one)
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    tdev.reset_probe()
    with pytest.raises(RuntimeError, match="differs from the host codec"):
        tdev.device_encode_enabled("cpu")
    tdev.reset_probe()


def test_device_encode_refuses_host_only_codecs():
    x = torch.ones(64)
    with pytest.raises(ValueError, match="no device encode"):
        tdev.encode_bucket([(x, 0, 64)], 64, twire.CODEC_TOPK, 0, None, False)


@pytest.mark.parametrize("t,dtype,exc", [
    (torch.zeros(8, dtype=torch.float64), torch.float32, TypeError),
    (torch.zeros(2, 4), torch.float32, TypeError),
    (torch.zeros(0), torch.float32, TypeError),
    (torch.zeros(16)[::2], torch.float32, ValueError),
    (torch.zeros(8), torch.int8, TypeError),
])
def test_quant_input_check_refuses_what_the_kernels_do_not_take(t, dtype,
                                                                exc):
    with pytest.raises(exc):
        qk.check_quant_input(t, dtype, "test")
    qk.check_quant_input(torch.zeros(8, dtype=dtype), dtype, "test")


def test_fp8_quantize_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        qk.fp8_sr_quantize(torch.ones(4), 1.0, 0, 2)
