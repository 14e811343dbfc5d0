"""Deterministic counter-based stochastic rounding to fp8, in numpy (the
port's copy of ``byteps_tpu/ops/compression/fp8sr.py``).

The host reference of the fused plane's fp8 codecs: ``wire.encode`` calls
``sr_quantize_bits``, and the Hopper kernel ``csrc/fp8_sr_quantize.cu``
must produce the same bytes. The noise is a pure function of
``(element index, seed)`` through a murmur3-style 32-bit mixer, and the
rounding runs as integer bit math on the f32 representation:

  1. ``y = clip(x / scale, ±MAX)`` (true division; MAX is the format's
     largest finite value),
  2. the number of low f32 mantissa bits below the fp8 grid comes from
     the exponent (``base = 23 - mant`` for normals, more toward the
     subnormal range); values under the subnormal quantum take a
     Bernoulli branch,
  3. hashed noise of exactly that width is added to the magnitude bits
     and the low bits truncated: rounds up with probability equal to the
     discarded fraction,
  4. the on-grid magnitude is packed into the fp8 byte (sign | exp |
     mantissa) directly; no float8 cast is ever taken.

Both formats follow the OCP encodings (``e4m3fn``: bias 7, no inf, max
448; ``e5m2``: bias 15, max finite 57344). Encodes never produce NaN or
inf. ``decode_bits`` is integer bit math too (the JAX package reads the
bytes through ``ml_dtypes``, which the port does not need).
"""

from __future__ import annotations

import numpy as np

#: kind ids (shared with the kernel; NOT wire codec ids)
E4M3, E5M2 = 0, 1

#: per-format constants: (max finite, mantissa bits, min-normal biased f32
#: exponent). e4m3: min normal 2^-6 -> 121; e5m2: 2^-14 -> 113.
_FMT = {
    E4M3: (448.0, 3, 121),
    E5M2: (57344.0, 2, 113),
}

_U32 = np.uint32


def fmt_max(kind: int) -> float:
    return _FMT[kind][0]


def fmt_params(kind: int):
    """(MAX, mant_bits, base_discard, emin, e_sub, quantum_bits):
    ``base_discard`` = f32 mantissa bits below a normal fp8 grid point,
    ``e_sub`` = biased f32 exponent of the subnormal quantum, and
    ``quantum_bits`` = the f32 bit pattern of that quantum."""
    mx, mant, emin = _FMT[kind]
    base = 23 - mant
    e_sub = emin - mant
    return mx, mant, base, emin, e_sub, _U32(e_sub) << _U32(23)


def mix32(idx: np.ndarray, seed: int) -> np.ndarray:
    """murmur3 fmix32 over ``idx * golden ^ seed``, uint32 wraparound."""
    h = (idx.astype(_U32) * _U32(0x9E3779B9)) ^ _U32(seed & 0xFFFFFFFF)
    h ^= h >> _U32(16)
    h *= _U32(0x85EBCA6B)
    h ^= h >> _U32(13)
    h *= _U32(0xC2B2AE35)
    h ^= h >> _U32(16)
    return h


def sr_quantize_bits(x: np.ndarray, scale: np.float32, kind: int,
                     seed: int) -> np.ndarray:
    """Stochastically round ``x / scale`` to fp8 ``kind``; returns the raw
    fp8 byte encodings (uint8). Deterministic in (x, scale, seed)."""
    mx, _, base, emin, e_sub, qbits = fmt_params(kind)
    x = np.ascontiguousarray(np.asarray(x, np.float32).reshape(-1))
    y = x / np.float32(scale)
    y = np.clip(y, np.float32(-mx), np.float32(mx))
    bits = y.view(_U32)
    sign = bits >> _U32(31)
    mag = bits & _U32(0x7FFFFFFF)
    e = mag >> _U32(23)
    h = mix32(np.arange(x.size, dtype=np.uint32), seed)
    # on the grid of the binade: add noise of the discard width, truncate
    d = np.clip(np.int64(emin + base) - e.astype(np.int64), base, 23) \
        .astype(_U32)
    mask = (_U32(1) << d) - _U32(1)
    mag_grid = (mag + (h & mask)) & ~mask
    # under the subnormal quantum: neighbours {0, quantum}, Bernoulli with
    # p = |y| / quantum from a 24-bit uniform of the same hash
    tiny = e < _U32(e_sub)
    u24 = (h >> _U32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    t = np.abs(y) * np.float32(2.0 ** (127 - e_sub))   # |y| / quantum
    mag_tiny = np.where(u24 < t, qbits, _U32(0))
    mag2 = np.where(tiny, mag_tiny, mag_grid)
    mag2 = np.where(mag == 0, _U32(0), mag2)
    # pack the on-grid magnitude into the fp8 byte (mant = 23 - base)
    e2 = mag2 >> _U32(23)
    f2 = mag2 & _U32(0x7FFFFF)
    norm = ((e2 - _U32(emin - 1)) << _U32(23 - base)) | (f2 >> _U32(base))
    sub_shift = np.clip(np.int64(emin + base) - e2.astype(np.int64),
                        0, 31).astype(_U32)
    sub = ((_U32(1) << _U32(23)) | f2) >> sub_shift
    out = np.where(e2 >= _U32(emin), norm, sub)
    out = np.where(mag2 == 0, _U32(0), out)
    return ((sign << _U32(7)) | out).astype(np.uint8)


def decode_bits(q: np.ndarray, kind: int) -> np.ndarray:
    """fp8 byte encodings -> float32 values (unscaled), as uint32 bit math.
    The codes an encode never makes read as the OCP formats define them:
    e4m3fn's S.1111.111 is NaN; e5m2's exponent 31 is inf (mantissa 0) or
    NaN."""
    _, mant, base, emin, e_sub, _ = fmt_params(kind)
    b = np.asarray(q, np.uint8).astype(_U32)
    sign = b >> _U32(7)
    e8 = (b & _U32(0x7F)) >> _U32(mant)
    f8 = b & _U32((1 << mant) - 1)
    norm = (((e8 + _U32(emin - 1)) << _U32(23)) | (f8 << _U32(base))) \
        .view(np.float32)
    sub = f8.astype(np.float32) * np.float32(2.0 ** (e_sub - 127))
    val = np.where(e8 > 0, norm, sub)
    emax = (1 << (7 - mant)) - 1            # the all-ones exponent field
    if kind == E4M3:
        val = np.where((e8 == emax) & (f8 == (1 << mant) - 1),
                       np.float32(np.nan), val)
    else:
        val = np.where(e8 == emax, np.where(f8 == 0, np.float32(np.inf),
                                            np.float32(np.nan)), val)
    return np.where(sign > 0, -val, val).astype(np.float32)
