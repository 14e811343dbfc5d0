"""Host (numpy) compressor codecs and chains of the PS path (the port's
copy of ``byteps_tpu/ops/compression/host.py``).

The reference runs one C++ compressor implementation in two places: on
the worker's CPU staging buffer right before PUSH and after PULL
(core_loops.cc:498-536, 620-648), and inside the server engine, which
decompresses every worker's push, sums the dense values, and re-compresses
the merged result once per round (server.cc:86-113, registered from kwargs
the worker serializes, server.cc:222-252). These codecs play that role:
numpy on the host data path, shared by ``PSGradientExchange`` (the worker)
and the in-process server (``server/compressed.py``). The legacy
``compression=`` chains are defined on that host buffer, in the reference
as in the JAX package: they are the path itself, not a stand-in for a
kernel. Payloads are flat little-endian byte strings of a fixed size
(``payload_nbytes``).

Numerics: onebit and topk are bit for bit the JAX package's codecs; randomk
draws its indices from the reference's seeded XorShift128+
(utils.h:72-158); dithering drives its Bernoulli from the same generator
when a ``seed`` kwarg is given and from a numpy stream otherwise.

Chains mirror the reference's registry (compressor_registry.cc:40-56),
whose server build skips only ``momentum_type``: error feedback is part of
the server's chain, so the merged buffer's recompression error is
compensated. Workers use ``create_host_chain`` (momentum → ef →
compressor); servers use ``create_server_chain`` (ef → compressor).

The O(n) loops of onebit's decompress, topk's selection, the sparse
scatter, randomk's index draws and seeded dithering run in the server
library's ``bps_codec_*`` primitives (``csrc/host/bps_server.cc``, GIL
released) unless ``BPS_NATIVE_CODEC=0``; the chains' state (residuals,
momentum, the generator's two words) stays in these objects, and both
routes give the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, Optional

import numpy as np

from .dithering import LINEAR, MAX
from .kernels import PACK
from .rng import XorShift128Plus
from .topk import resolve_k


def _native():
    """The server library with its codec primitives, or None under
    ``BPS_NATIVE_CODEC=0`` (read at every call, so a test can flip it).
    A library that fails to build raises: the numpy route is chosen by
    the knob, never by a failure."""
    if os.environ.get("BPS_NATIVE_CODEC", "1") in ("0", "false"):
        return None
    from ...server.engine import _lib
    return _lib()


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return arr.ctypes.data_as(ctypes.c_void_p)


def serialize_kwargs(kwargs: Dict[str, str]) -> bytes:
    """``k\\0v\\0...``: the reference's wire form of the compression kwargs
    (utils.h:33-46, pushed to the server at init, operations.cc:396-408)."""
    out = []
    for k in sorted(kwargs):
        out.append(str(k).encode())
        out.append(str(kwargs[k]).encode())
    return b"\0".join(out)


def deserialize_kwargs(buf: bytes) -> Dict[str, str]:
    if not buf:
        return {}
    parts = bytes(buf).split(b"\0")
    if len(parts) % 2:
        raise ValueError("malformed kwargs blob")
    return {parts[i].decode(): parts[i + 1].decode()
            for i in range(0, len(parts), 2)}


class HostCodec:
    """compress(np [size]) -> bytes of payload_nbytes(); decompress -> np."""

    def __init__(self, size: int, dtype: str = "float32") -> None:
        self.size = int(size)
        self.dtype = np.dtype(dtype)

    def compress(self, x: np.ndarray) -> bytes:
        raise NotImplementedError

    def decompress(self, buf) -> np.ndarray:
        raise NotImplementedError

    def payload_nbytes(self) -> int:
        raise NotImplementedError


class HostOnebit(HostCodec):
    """Sign bits packed 32 to a uint32 word, MSB first, with an optional
    L1-mean scale (reference: impl/onebit.cc:34-67; the layout of the
    port's ``onebit_pack`` kernel)."""

    def __init__(self, size: int, dtype: str = "float32",
                 use_scale: bool = False) -> None:
        super().__init__(size, dtype)
        self.use_scale = use_scale
        self.chunks = (size + PACK - 1) // PACK

    def compress(self, x: np.ndarray) -> bytes:
        # fp32 math whatever the wire dtype: the sign test is the same and
        # the fp32 L1 mean is the better one for fp16/bf16 keys. numpy's
        # packbits serves both routes (the library has no pack primitive)
        x = np.ascontiguousarray(np.asarray(x).reshape(-1), np.float32)
        bits = np.zeros(self.chunks * PACK, np.uint8)
        bits[: self.size] = (x < 0)
        # packbits is MSB-first per byte; the big-endian word view keeps
        # element 0 in the top bit of word 0
        packed = np.packbits(bits).view(">u4").astype(np.uint32)
        scale = np.float32(np.abs(x).mean()) if self.use_scale \
            else np.float32(1.0)
        return packed.tobytes() + struct.pack("<f", scale)

    def decompress(self, buf) -> np.ndarray:
        buf = bytes(buf)
        if len(buf) != self.payload_nbytes():
            # both routes: the native primitive reads exactly chunks·4 + 4
            # bytes, so a torn frame must never reach it
            raise ValueError(
                f"onebit payload is {len(buf)} bytes, expected "
                f"{self.payload_nbytes()}")
        lib = _native()
        if lib is not None:
            src = np.frombuffer(buf, np.uint8)
            out = np.empty(self.size, np.float32)
            lib.bps_codec_onebit_decompress(_ptr(src), self.size, _ptr(out))
            return out.astype(self.dtype, copy=False)
        packed = np.frombuffer(buf[:-4], np.uint32)
        (scale,) = struct.unpack("<f", buf[-4:])
        bits = np.unpackbits(
            np.frombuffer(packed.astype(">u4").tobytes(), np.uint8))
        signs = 1.0 - 2.0 * bits[: self.size].astype(np.float32)
        return (signs * scale).astype(self.dtype)

    def payload_nbytes(self) -> int:
        return self.chunks * 4 + 4


class _SparseCodec(HostCodec):
    """The (int32 indices | values) layout of topk and randomk."""

    def __init__(self, size: int, dtype: str, k: int) -> None:
        super().__init__(size, dtype)
        self.k = min(int(k), size)

    def _pack(self, idx: np.ndarray, vals: np.ndarray) -> bytes:
        return idx.astype(np.int32).tobytes() + \
            vals.astype(self.dtype).tobytes()

    def decompress(self, buf) -> np.ndarray:
        buf = bytes(buf)
        if len(buf) != self.payload_nbytes():
            raise ValueError(
                f"sparse payload is {len(buf)} bytes, expected "
                f"{self.payload_nbytes()}")
        idx = np.frombuffer(buf[: self.k * 4], np.int32)
        vals = np.frombuffer(buf[self.k * 4:], self.dtype)
        lib = _native()
        if lib is not None and self.dtype == np.float32:
            out = np.empty(self.size, np.float32)
            rc = lib.bps_codec_scatter_f32(_ptr(idx), _ptr(vals),
                                           self.k, self.size, _ptr(out))
            if rc != 0:
                raise IndexError(
                    f"sparse payload index out of range 0..{self.size}")
            return out
        out = np.zeros(self.size, self.dtype)
        out[idx] = vals
        return out

    def payload_nbytes(self) -> int:
        return self.k * (4 + self.dtype.itemsize)


class HostTopk(_SparseCodec):
    """The k largest magnitudes, ties to the lower index (reference:
    impl/topk.h:26-37). The selection runs in fp32 for every wire dtype
    (monotone and injective from fp16/bf16, so the same set); values are
    packed in the wire dtype."""

    def compress(self, x: np.ndarray) -> bytes:
        x = np.asarray(x).reshape(-1)
        lib = _native()
        if lib is not None and x.size >= self.k:
            x32 = np.ascontiguousarray(x, np.float32)
            idx = np.empty(self.k, np.int32)
            vals = np.empty(self.k, np.float32)
            rc = lib.bps_codec_topk_select(_ptr(x32), x32.size, self.k,
                                           _ptr(idx), _ptr(vals))
            if rc != 0:
                raise ValueError(
                    f"topk select failed: n={x32.size} k={self.k}")
            if self.dtype != np.float32:
                vals = np.asarray(x)[idx]       # the wire dtype's values
            return self._pack(idx, vals)
        idx = np.argsort(-np.abs(x), kind="stable")[: self.k]
        return self._pack(idx, x[idx])


class HostRandomk(_SparseCodec):
    """k coordinates drawn with replacement from the reference's seeded
    XorShift128+ (impl/randomk.cc; utils.h:72-92). The generator's state
    lives here; the native route draws from it in place, so both routes
    follow one stream."""

    def __init__(self, size: int, dtype: str, k: int, seed: int = 0) -> None:
        super().__init__(size, dtype, k)
        self._rng = XorShift128Plus(seed)

    def compress(self, x: np.ndarray) -> bytes:
        x = np.asarray(x).reshape(-1)
        lib = _native()
        if lib is not None:
            state = np.array([self._rng._a, self._rng._b], np.uint64)
            idx = np.empty(self.k, np.int32)
            lib.bps_codec_xorshift_indices(self.size, self.k,
                                           _ptr(state), _ptr(idx))
            self._rng._a, self._rng._b = (np.uint64(state[0]),
                                          np.uint64(state[1]))
            return self._pack(idx, x[idx])
        idx = self._rng.randint_array(0, self.size, self.k)
        return self._pack(idx, x[idx])


class HostDithering(HostCodec):
    """Stochastic quantization onto linear {i/s} or natural {2^(i-s)}
    levels (reference: impl/dithering.{cc,h}), elementwise the math of
    ``DitheringCompressor.quantize``."""

    def __init__(self, size: int, dtype: str = "float32", s: int = 4,
                 seed: int = 0, ptype: int = LINEAR, ntype: int = MAX) -> None:
        super().__init__(size, dtype)
        self.s, self.ptype, self.ntype = int(s), int(ptype), int(ntype)
        qmax = self.s if self.ptype == LINEAR else (1 << (self.s - 1))
        self.qdtype = np.dtype(np.int8 if qmax <= 127 else np.int16)
        # seeded: the reference's sequential generator (deterministic);
        # unseeded: a numpy stream (the reference is nondeterministic then)
        self._xs = XorShift128Plus(seed) if seed else None
        self._np_rng = None if seed else np.random.RandomState()

    def _uniform(self, n: int) -> np.ndarray:
        if self._xs is not None:
            return np.array([self._xs.rand() for _ in range(n)], np.float64)
        return self._np_rng.random_sample(n)

    def compress(self, x: np.ndarray) -> bytes:
        x = np.asarray(x, np.float32).reshape(-1)
        scale = (np.abs(x).max() if self.ntype == MAX
                 else np.sqrt(np.sum(x * x)))
        lib = _native() if self._xs is not None else None
        if lib is not None:
            # seeded: the generator is sequential, a Python loop per
            # element in ``_uniform``; the primitive runs that loop with
            # the same draws, one a element, advancing the state in place.
            # The scale is numpy's on both routes
            xc = np.ascontiguousarray(x)
            state = np.array([self._xs._a, self._xs._b], np.uint64)
            q = np.empty(self.size, self.qdtype)
            lib.bps_codec_dithering_compress(
                _ptr(xc), self.size, float(scale), self.s, self.ptype,
                self.qdtype.itemsize * 8, _ptr(state), _ptr(q))
            self._xs._a, self._xs._b = (np.uint64(state[0]),
                                        np.uint64(state[1]))
            return q.tobytes() + struct.pack("<f", np.float32(scale))
        u = self._uniform(self.size)
        safe = scale if scale > 0 else 1.0
        absx = np.abs(x)
        if self.ptype == LINEAR:
            normalized = absx / safe * self.s
            floor = np.floor(normalized)
            q = floor + (u < (normalized - floor))
        else:
            level = 1 << (self.s - 1)
            normalized = absx / safe * level
            c = np.ceil(normalized).astype(np.uint32)
            # round-next-pow2 >> 1 (reference RoundNextPow2, utils.h)
            v = np.maximum(c, 1).astype(np.uint32) - np.uint32(1)
            for shift in (1, 2, 4, 8, 16):
                v = v | (v >> np.uint32(shift))
            fl = ((v.astype(np.uint64) + 1) >> np.uint64(1)).astype(np.float32)
            length = np.where(fl != 0, fl, 1.0)
            p = (normalized - fl) / length
            q = fl + length * (u < p)
        q = (np.sign(x) * q).astype(self.qdtype)
        return q.tobytes() + struct.pack("<f", np.float32(scale))

    def decompress(self, buf) -> np.ndarray:
        buf = bytes(buf)
        q = np.frombuffer(buf[:-4], self.qdtype).astype(np.float32)
        (scale,) = struct.unpack("<f", buf[-4:])
        denom = self.s if self.ptype == LINEAR else (1 << (self.s - 1))
        return (q * scale / denom).astype(self.dtype)

    def payload_nbytes(self) -> int:
        return self.size * self.qdtype.itemsize + 4


def create_host_codec(kwargs: Dict[str, str], size: int,
                      dtype: str = "float32") -> Optional[HostCodec]:
    """The bare compressor of string kwargs, no decorators."""
    ctype = kwargs.get("compressor_type")
    if ctype is None:
        return None
    if ctype == "onebit":
        scaled = str(kwargs.get("compressor_onebit_scaling",
                                "false")).lower() in ("1", "true", "yes")
        return HostOnebit(size, dtype, use_scale=scaled)
    if ctype == "topk":
        return HostTopk(size, dtype, k=resolve_k(kwargs, size, dtype))
    if ctype == "randomk":
        return HostRandomk(size, dtype, k=resolve_k(kwargs, size, dtype),
                           seed=int(kwargs.get("seed", 0)))
    if ctype == "dithering":
        return HostDithering(
            size, dtype, s=int(float(kwargs.get("compressor_k", 4))),
            seed=int(kwargs.get("seed", 0)),
            ptype=int(kwargs.get("dithering_partition", LINEAR)),
            ntype=int(kwargs.get("dithering_normalize", MAX)))
    raise ValueError(f"unknown compressor_type {ctype!r} for the host path")


class HostErrorFeedback:
    """Error feedback: compress(g + e · lr ratio); e = that minus its
    decompressed value (reference: error_feedback.h:26-46; the vanilla
    variant's η_{t-1}/η_t arrives through ``set_lr``, where the reference
    reads an mmap'd lr.s file, vanilla_error_feedback.h:26-38)."""

    def __init__(self, inner: HostCodec) -> None:
        self.inner = inner
        self.size, self.dtype = inner.size, inner.dtype
        self._error = np.zeros(inner.size, np.float32)
        self._lr_prev = self._lr_now = 1.0

    def set_lr(self, lr: float) -> None:
        self._lr_prev, self._lr_now = self._lr_now, float(lr)

    def compress(self, x: np.ndarray) -> bytes:
        ratio = self._lr_prev / max(self._lr_now, 1e-30)
        corrected = np.asarray(x, np.float32).reshape(-1) + \
            self._error * ratio
        buf = self.inner.compress(corrected.astype(self.dtype))
        self._error = corrected - \
            self.inner.decompress(buf).astype(np.float32)
        return buf

    def decompress(self, buf) -> np.ndarray:
        return self.inner.decompress(buf)

    def payload_nbytes(self) -> int:
        return self.inner.payload_nbytes()


class HostNesterovMomentum:
    """Worker-side momentum: m = μm + g; send g + μm (reference:
    nesterov_momentum.h:26-34)."""

    def __init__(self, inner, mu: float = 0.9) -> None:
        self.inner = inner
        self.size, self.dtype = inner.size, inner.dtype
        self.mu = float(mu)
        self._m = np.zeros(inner.size, np.float32)

    def compress(self, x: np.ndarray) -> bytes:
        g = np.asarray(x, np.float32).reshape(-1)
        self._m = self.mu * self._m + g
        return self.inner.compress((g + self.mu * self._m)
                                   .astype(self.dtype))

    def decompress(self, buf) -> np.ndarray:
        return self.inner.decompress(buf)

    def payload_nbytes(self) -> int:
        return self.inner.payload_nbytes()


def create_server_chain(kwargs: Dict[str, str], size: int,
                        dtype: str = "float32"):
    """The server's chain: ef → compressor (the reference server's registry
    skips only momentum_type, compressor_registry.cc:40-56)."""
    comp = create_host_codec(kwargs, size, dtype)
    if comp is None:
        return None
    if kwargs.get("ef_type") == "vanilla":
        comp = HostErrorFeedback(comp)
    return comp


def create_host_chain(kwargs: Dict[str, str], size: int,
                      dtype: str = "float32"):
    """The worker's chain: momentum → ef → compressor, outermost first
    (reference: CompressorRegistry::Create, compressor_registry.cc:40-56)."""
    comp = create_host_codec(kwargs, size, dtype)
    if comp is None:
        return None
    if kwargs.get("ef_type") == "vanilla":
        comp = HostErrorFeedback(comp)
    if kwargs.get("momentum_type") == "nesterov":
        comp = HostNesterovMomentum(
            comp, mu=float(kwargs.get("momentum_mu", 0.9)))
    return comp
