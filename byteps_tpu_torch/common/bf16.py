"""bfloat16 on the host without ``ml_dtypes``.

The JAX package's host code names bfloat16 arrays through ``ml_dtypes``,
which registers the type with numpy; the port runs where that package is
not installed. Here a bfloat16 host array is a ``uint16`` array of the
raw bits whose dtype carries the name in its metadata (``BF16``), and the
conversions are integer operations on ``uint16`` / ``uint32`` views:

  - widen: the bits shifted into the top half of a float32, exactly;
  - narrow: round to nearest, ties to even, on the float32 bits; a NaN
    becomes the quiet NaN of its sign (``0x7FC0`` / ``0xFFC0``).

Both are ``ml_dtypes``' conversions byte for byte, on every value class
(``tests/test_torch_async_bf16.py``). Where a dtype name travels (the
transport's frames, ``PSServer``'s per-key store dtype), ``dtype_name``
reads it from either kind of array, so an ``ml_dtypes`` array handed to
the port is taken as well.
"""

from __future__ import annotations

import numpy as np

BF16 = np.dtype(np.uint16, metadata={"bps_dtype": "bfloat16"})


def dtype_name(a) -> str:
    """The element type's name: ``"bfloat16"`` for a ``BF16`` array (and
    an ``ml_dtypes`` one), else numpy's name."""
    md = a.dtype.metadata
    if md and "bps_dtype" in md:
        return md["bps_dtype"]
    return str(a.dtype)


def np_dtype(name: str) -> np.dtype:
    """The host dtype of a dtype name (``BF16`` for ``"bfloat16"``)."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def frombuffer(buf, name: str) -> np.ndarray:
    """A read-only host array over ``buf``'s bytes, in dtype ``name``."""
    return np.frombuffer(buf, dtype=np_dtype(name))


def widen(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits to float32, exactly."""
    u = np.ascontiguousarray(bits).view(np.uint16).astype(np.uint32)
    return (u << 16).view(np.float32)


def narrow(x: np.ndarray) -> np.ndarray:
    """float32 values to bfloat16 bits (a ``BF16`` array): round to
    nearest even; a NaN keeps its sign and becomes quiet."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    # no carry out of 32 bits: the largest non-NaN pattern, 0xFF800000,
    # plus 0x8000 stays below 2**32
    r = np.where(nan, 0, u) + (0x7FFF + ((u >> 16) & 1))
    out = (r >> 16).astype(np.uint16)
    out[nan] = np.where((u[nan] >> 31) != 0, 0xFFC0, 0x7FC0)
    return out.view(BF16)


def cast(a: np.ndarray, name: str) -> np.ndarray:
    """``a`` in dtype ``name`` (bfloat16 through float32; a copy unless it
    already has that dtype)."""
    have = dtype_name(a)
    if have == name:
        return a
    if have == "bfloat16":
        a = widen(a)
        return a if name == "float32" else a.astype(name)
    if name == "bfloat16":
        return narrow(a.astype(np.float32, copy=False))
    return a.astype(name)
