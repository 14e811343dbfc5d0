"""The port's host bfloat16 codec (``byteps_tpu_torch/common/bf16.py``),
which the async PS path's bf16 delta wire rides on where ``ml_dtypes`` is
not installed, against ``ml_dtypes`` byte for byte on every value class:
ties (to even, both ways), ±0, subnormals, ±inf, NaN payloads of both
signs, and the largest finite values, the ones that round to inf
included. Widening is checked on all 65,536 patterns.

The delta itself is rounded where it is computed: by torch's
``.to(torch.bfloat16)`` in the port (on the card there, here on the CPU)
and by XLA's ``astype`` in the JAX trainer. Both must round alike, and
alike with the host codec, which the server's narrow pulls use: held bit
for bit here on the same adversarial values, NaN aside, which every
converter turns into a NaN of its own bits (torch's CPU kernel writes
0xFFFF, ``ml_dtypes`` and XLA keep the sign, the card writes 0x7FFF).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu_torch.common import bf16

MAX = np.float32(np.finfo(np.float32).max)


def _bits(*words):
    return np.array(words, dtype=np.uint32)


# float32 bit patterns of each class; each bracket is a few patterns
CLASSES = {
    "zeros": _bits(0x00000000, 0x80000000),
    "ties_to_even_down": _bits(0x3F808000, 0xBF808000, 0x40008000),
    "ties_to_even_up": _bits(0x3F818000, 0xBF818000, 0x40018000),
    "near_ties": _bits(0x3F807FFF, 0x3F808001, 0x3F817FFF, 0x3F818001),
    "subnormals": _bits(0x00000001, 0x00008000, 0x00018000, 0x00017FFF,
                        0x007FFFFF, 0x807FFFFF, 0x80008000, 0x00400000),
    "smallest_normals": _bits(0x00800000, 0x80800000, 0x00807FFF,
                              0x00808000),
    "infinities": _bits(0x7F800000, 0xFF800000),
    "largest_finite": _bits(0x7F7F7FFF, 0x7F7F0000, 0xFF7F7FFF),
    "round_to_inf": _bits(0x7F7F8000, 0x7F7FFFFF, 0xFF7F8000, 0xFF7FFFFF),
    "nan_payloads": _bits(0x7F800001, 0x7FC00000, 0x7FBFFFFF, 0x7FFFFFFF,
                          0xFF800001, 0xFFC12345, 0xFFFFFFFF, 0x7F808000),
}


def _class_values(name):
    return CLASSES[name].view(np.float32)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_narrow_is_ml_dtypes_byte_for_byte(name):
    x = _class_values(name)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = bf16.narrow(x)
    assert got.dtype == bf16.BF16 and bf16.dtype_name(got) == "bfloat16"
    assert got.view(np.uint16).tobytes() == want.tobytes()


def test_narrow_on_random_patterns_is_ml_dtypes():
    u = np.random.RandomState(0).randint(0, 2 ** 32, size=1 << 20,
                                         dtype=np.uint64).astype(np.uint32)
    x = u.view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert bf16.narrow(x).view(np.uint16).tobytes() == want.tobytes()


def test_widen_every_pattern_is_ml_dtypes():
    b = np.arange(1 << 16, dtype=np.uint16)
    want = b.view(ml_dtypes.bfloat16).astype(np.float32)
    got = bf16.widen(b.view(bf16.BF16))
    assert got.dtype == np.float32
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


def test_cast_and_names_take_both_kinds_of_bf16_array():
    x = np.linspace(-3, 3, 17, dtype=np.float32)
    ours, theirs = bf16.cast(x, "bfloat16"), x.astype(ml_dtypes.bfloat16)
    for a in (ours, theirs):
        assert bf16.dtype_name(a) == "bfloat16"
        back = bf16.cast(a, "float32")
        assert back.tobytes() == theirs.astype(np.float32).tobytes()
        assert bf16.cast(a, "float64").dtype == np.float64
    assert bf16.cast(x, "float32") is x
    assert bf16.dtype_name(x) == "float32"
    assert bf16.np_dtype("bfloat16") == bf16.BF16
    assert bf16.frombuffer(ours.tobytes(), "bfloat16").dtype == bf16.BF16
    # the dtype's name survives the views the transport takes
    assert bf16.dtype_name(np.ascontiguousarray(ours[2:])) == "bfloat16"


def _torch_bits(x):
    t = torch.from_numpy(x.copy()).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _xla_bits(x):
    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(
            np.uint16)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_torch_xla_and_the_host_codec_round_alike(name):
    """The port rounds the delta with torch, the JAX trainer with XLA, the
    server's narrow pull with the host codec: one rounding, bit for bit,
    NaN aside (then each gives a NaN of its own bits)."""
    x = _class_values(name)
    # a run long enough for torch's vectorized conversion, the tail for
    # its scalar one
    x = np.concatenate([np.repeat(x, 9), x])
    with np.errstate(invalid="ignore"):
        t, j, h = _torch_bits(x), _xla_bits(x), bf16.narrow(x).view(np.uint16)
    nan = np.isnan(x)
    for a in (t, j):
        assert a[~nan].tobytes() == h[~nan].tobytes()
        assert np.isnan(bf16.widen(a[nan])).all()
    assert np.isnan(bf16.widen(h[nan])).all()


def test_torch_and_xla_round_real_deltas_alike():
    """Weight deltas of one AdamW step's size at every magnitude."""
    rng = np.random.RandomState(3)
    x = (rng.randn(1 << 16) * 10.0 ** rng.randint(-12, 3, 1 << 16)).astype(
        np.float32)
    assert _torch_bits(x).tobytes() == _xla_bits(x).tobytes() \
        == bf16.narrow(x).view(np.uint16).tobytes()
