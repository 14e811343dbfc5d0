"""The port's host codecs and chains of the PS path
(``byteps_tpu_torch/ops/compression/host.py``) held against the JAX
package's (``byteps_tpu/ops/compression/host.py``) on the same seeded
numpy inputs, on the numpy route (``BPS_NATIVE_CODEC=0``) and on the
native one (the ``bps_codec_*`` primitives of each package's own server
library).

Tolerance: none. The contract is bytes: payloads, decompressed buffers,
chain state and generator state are compared bit for bit, round after
round.
"""

import numpy as np
import pytest

from byteps_tpu.ops.compression import host as jhost
from byteps_tpu.ops.compression import rng as jrng
from byteps_tpu_torch.ops.compression import host as thost
from byteps_tpu_torch.ops.compression import rng as trng

SIZE = 3001          # not a multiple of 32: onebit's last word is partial
ROUNDS = 3

ONEBIT = {"compressor_type": "onebit", "compressor_onebit_scaling": "true"}
README = dict(ONEBIT, ef_type="vanilla", momentum_type="nesterov")

# (id, kwargs, dtype): every codec, both dithering partitions and
# normalizations, seeded draws, and the chain decorators
CASES = [
    ("onebit", {"compressor_type": "onebit"}, "float32"),
    ("onebit_scaled", ONEBIT, "float32"),
    ("onebit_fp16", ONEBIT, "float16"),
    ("topk", {"compressor_type": "topk", "compressor_k": "0.05"}, "float32"),
    ("topk_count", {"compressor_type": "topk", "compressor_k": "40"},
     "float32"),
    ("topk_fp16", {"compressor_type": "topk", "compressor_k": "0.05"},
     "float16"),
    ("randomk", {"compressor_type": "randomk", "compressor_k": "0.05",
                 "seed": "123"}, "float32"),
    ("dithering_linear", {"compressor_type": "dithering",
                          "compressor_k": "4", "seed": "7"}, "float32"),
    ("dithering_natural", {"compressor_type": "dithering",
                           "compressor_k": "5", "seed": "9",
                           "dithering_partition": "1"}, "float32"),
    ("dithering_l2", {"compressor_type": "dithering", "compressor_k": "8",
                      "seed": "11", "dithering_normalize": "1"}, "float32"),
    ("dithering_wide", {"compressor_type": "dithering",
                        "compressor_k": "200", "seed": "3"}, "float32"),
    ("ef_onebit", dict(ONEBIT, ef_type="vanilla"), "float32"),
    ("readme", README, "float32"),
    ("nesterov_topk", {"compressor_type": "topk", "compressor_k": "0.05",
                       "momentum_type": "nesterov", "momentum_mu": "0.8"},
     "float32"),
    ("ef_randomk", {"compressor_type": "randomk", "compressor_k": "0.05",
                    "seed": "5", "ef_type": "vanilla"}, "float32"),
    ("ef_dithering", {"compressor_type": "dithering", "compressor_k": "4",
                      "seed": "13", "ef_type": "vanilla",
                      "momentum_type": "nesterov"}, "float32"),
]


def _inputs(seed, dtype, rounds=ROUNDS):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(SIZE) * (r + 1)).astype(dtype) for r in range(rounds)]
    xs[0][::97] = 0.0                        # zeros: onebit's sign edge
    return xs


def _state(chain):
    """Every piece of a chain's state, outermost first."""
    out = []
    c = chain
    while c is not None:
        for attr in ("_m", "_error"):
            if hasattr(c, attr):
                out.append(np.asarray(getattr(c, attr)).copy())
        for attr in ("_rng", "_xs"):
            g = getattr(c, attr, None)
            if g is not None:
                out.append(np.array([g._a, g._b], np.uint64))
        c = getattr(c, "inner", None)
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(params=["numpy", "native"])
def route(request, monkeypatch):
    monkeypatch.setenv("BPS_NATIVE_CODEC",
                       "0" if request.param == "numpy" else "1")
    return request.param


def _makers():
    """(case, kwargs, dtype, maker): the bare codec for the cases without
    decorators, both chains for every case."""
    for case, kwargs, dtype in CASES:
        bare = "ef_type" not in kwargs and "momentum_type" not in kwargs
        for make in (("create_host_codec",) if bare else ()) + (
                "create_host_chain", "create_server_chain"):
            yield pytest.param(case, kwargs, dtype, make,
                               id=f"{case}-{make}")


@pytest.mark.parametrize("case,kwargs,dtype,make", _makers())
def test_codec_and_chains_bit_for_bit(case, kwargs, dtype, make, route):
    """Each round: the payload, its decompressed buffer and the chain's
    whole state (momentum, residual, generator words) are the JAX
    package's, bit for bit."""
    ours = getattr(thost, make)(kwargs, SIZE, dtype)
    ref = getattr(jhost, make)(kwargs, SIZE, dtype)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.payload_nbytes() == ref.payload_nbytes()
    for x in _inputs(len(case), dtype):
        got, want = ours.compress(x), ref.compress(x)
        assert isinstance(got, bytes) and got == want
        assert len(got) == ours.payload_nbytes()
        _same(ours.decompress(got), ref.decompress(want))
        for a, b in zip(_state(ours), _state(ref), strict=True):
            _same(a, b)


def test_native_and_numpy_routes_give_the_same_bytes(monkeypatch):
    """The route is a speed knob: for every case the port's two routes
    give the same payloads and decompressed buffers."""
    for case, kwargs, dtype in CASES:
        outs = {}
        for flag in ("0", "1"):
            monkeypatch.setenv("BPS_NATIVE_CODEC", flag)
            chain = thost.create_host_chain(kwargs, SIZE, dtype)
            outs[flag] = [(p := chain.compress(x), chain.decompress(p))
                          for x in _inputs(len(case), dtype)]
        for (p0, d0), (p1, d1) in zip(outs["0"], outs["1"]):
            assert p0 == p1, case
            _same(d0, d1)


@pytest.mark.parametrize("make,order", [
    ("create_host_chain", ["HostNesterovMomentum", "HostErrorFeedback",
                           "HostOnebit"]),
    ("create_server_chain", ["HostErrorFeedback", "HostOnebit"]),
])
def test_chain_order(make, order):
    """Worker: momentum → ef → compressor; server: ef → compressor (the
    reference's server registry skips only momentum)."""
    for mod in (thost, jhost):
        chain, names = getattr(mod, make)(README, SIZE), []
        while chain is not None:
            names.append(type(chain).__name__)
            chain = getattr(chain, "inner", None)
        assert names == order


def test_error_feedback_lr_ratio(monkeypatch):
    """``set_lr`` scales the carried residual by η_{t-1}/η_t on both
    sides."""
    monkeypatch.setenv("BPS_NATIVE_CODEC", "1")
    kw = dict(ONEBIT, ef_type="vanilla")
    ours = thost.create_server_chain(kw, SIZE)
    ref = jhost.create_server_chain(kw, SIZE)
    for lr, x in zip((0.1, 0.05, 0.2), _inputs(4, "float32")):
        ours.set_lr(lr)
        ref.set_lr(lr)
        assert ours.compress(x) == ref.compress(x)
        _same(ours._error, ref._error)


@pytest.mark.parametrize("kwargs", [README, {"compressor_type": "topk",
                                             "compressor_k": "0.01",
                                             "seed": "3"}, {}])
def test_kwargs_wire_form(kwargs):
    """``k\\0v\\0...`` in sorted key order, both ways, the JAX package's
    bytes."""
    blob = thost.serialize_kwargs(kwargs)
    assert blob == jhost.serialize_kwargs(kwargs)
    assert thost.deserialize_kwargs(blob) == kwargs
    assert jhost.deserialize_kwargs(blob) == kwargs
    with pytest.raises(ValueError):
        thost.deserialize_kwargs(b"odd")


def test_xorshift_stream():
    """The port's XorShift128+ is the JAX package's stream: draws,
    ranges, uniforms and Bernoulli trials from one seed."""
    a, b = trng.XorShift128Plus(987654321), jrng.XorShift128Plus(987654321)
    assert [a.next() for _ in range(50)] == [b.next() for _ in range(50)]
    np.testing.assert_array_equal(a.randint_array(3, 1000, 64),
                                  b.randint_array(3, 1000, 64))
    assert [a.rand() for _ in range(20)] == [b.rand() for _ in range(20)]
    assert [a.bernoulli(0.3) for _ in range(40)] == \
        [b.bernoulli(0.3) for _ in range(40)]


@pytest.mark.parametrize("case", ["onebit", "sparse"])
def test_torn_payload_is_refused(case, route):
    """A payload of the wrong length raises on both routes instead of
    being read past its end."""
    kw = (ONEBIT if case == "onebit"
          else {"compressor_type": "topk", "compressor_k": "10"})
    codec = thost.create_host_codec(kw, SIZE)
    payload = codec.compress(np.ones(SIZE, np.float32))
    with pytest.raises(ValueError, match="payload"):
        codec.decompress(payload[:-1])
