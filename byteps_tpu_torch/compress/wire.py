"""Self-describing wire format for the fused compression plane (the port's
copy of ``byteps_tpu/compress/wire.py``, byte for byte the same format).

Every compressed payload carries its own codec HEADER, so a server can
decode any round's push without out-of-band state, and two rounds of the
same key in flight can carry different codec decisions.

Header (little-endian, ``_HDR``)::

    magic:u16 | version:u8 | codec:u8 | dtype:char[8] | elems:u64

``magic``/``version`` are checked LOUDLY on decode: a torn frame, a
stale-version peer, or plain-dense bytes routed onto the fused path
raise :class:`CodecError` instead of scattering garbage into the store
— the codec analogue of the server plane's ``WrongEpoch`` refusal.

Codecs (the controller's ladder, cheapest first):

    ``none``      raw bytes (self-describing dense — used by replay paths)
    ``fp16``      float16 cast, 2x on fp32 buckets
    ``int8``      symmetric max-abs linear quantization, one fp32 scale
                  per bucket, round-half-even — deterministic, 4x
    ``fp8_e4m3``  max-abs-scaled fp8 (OCP e4m3fn) with DETERMINISTIC
                  counter-based stochastic rounding — same 4x as int8
                  but an unbiased quantizer with ~2^13 dynamic range
                  under the scale (EQuARX-style, arXiv 2506.17615);
                  sits ABOVE int8 in the ladder
    ``fp8_e5m2``  as above at e5m2 (range over mantissa) — the rung for
                  long-tailed gradient distributions
    ``topk``      largest-k magnitudes as (int32 idx | fp32 val), k =
                  elems/topk_div — sparse, ~4x over int8 at div=32

All codecs are DETERMINISTIC functions of the dense input — the fp8
rungs' stochastic rounding draws its noise from a counter-based hash of
``(element index, seed)`` with the seed derived from ``(key, round)``
(``sr_seed``) or supplied by the caller, never from a global RNG — so a
fixed codec decision trace makes compressed training reproducible
bit-for-bit, and a server re-encoding a merged round serves
byte-identical payloads to every puller.

The engine-side fused route (``BPS_FUSED_HOMOG=0``, or a fused push to a
key the homogeneous store does not own) shares three recipes with the JAX
package's: ``decode_for_store`` decodes a push into the engine,
``pull_encoded`` serves a pull as the merged round re-encoded under
``sr_seed(key, round)``, and ``FusedPullCache`` keeps the last
``_CACHE_ROUNDS`` encoded rounds of each key.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional

import numpy as np

MAGIC = 0xB5C1
#: v2 renumbered the codec ids to keep ladder order == codec id when
#: the fp8 rungs landed above int8 (topk moved 3 -> 5) — a v1 peer's
#: payloads are refused LOUDLY by the version check below, never
#: misdecoded through the shifted id space
VERSION = 2

(CODEC_NONE, CODEC_FP16, CODEC_INT8, CODEC_FP8_E4M3, CODEC_FP8_E5M2,
 CODEC_TOPK) = 0, 1, 2, 3, 4, 5

#: controller ladder order — index = aggressiveness level (the fp8
#: rungs ride above int8: same wire bytes, unbiased quantizer)
LEVELS = ("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2", "topk")
_NAME_TO_ID = {n: i for i, n in enumerate(LEVELS)}

FP8_CODECS = (CODEC_FP8_E4M3, CODEC_FP8_E5M2)


def _fp8_kind(cid: int) -> int:
    from ..ops.compression import fp8sr
    return fp8sr.E4M3 if cid == CODEC_FP8_E4M3 else fp8sr.E5M2


def sr_seed(key: int, rnd: int) -> int:
    """The one (key, round) -> stochastic-rounding seed derivation,
    shared by every server-side encode site (pull re-encode, the
    homogeneous merge renormalize) so divergent paths serve
    byte-identical fp8 payloads for the same round. splitmix64-style
    fold to 32 bits; pure, no state."""
    h = (int(key) * 0x9E3779B97F4A7C15 + int(rnd) * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 29
    return h & 0xFFFFFFFF

_HDR = struct.Struct("<HBB8sQ")

#: default top-k keep fraction denominator (k = elems // TOPK_DIV)
TOPK_DIV = 32


class CodecError(RuntimeError):
    """A payload that cannot be decoded safely: bad magic (dense bytes
    or a torn frame on the fused path), codec-version mismatch between
    peers, an unknown codec id, or a body whose length disagrees with
    its header. Always LOUD — decoding a torn payload into plausible
    garbage and summing it would corrupt the round silently."""


def codec_id(name: str) -> int:
    try:
        return _NAME_TO_ID[name]
    except KeyError:
        raise ValueError(
            f"unknown fused codec {name!r}; expected one of {LEVELS}")


def codec_name(cid: int) -> str:
    if not 0 <= cid < len(LEVELS):
        raise ValueError(f"unknown fused codec id {cid}")
    return LEVELS[cid]


def lossy(cid: int) -> bool:
    return cid != CODEC_NONE


def topk_k(elems: int, div: int = TOPK_DIV) -> int:
    return max(1, int(elems) // int(div))


def wire_nbytes(cid: int, elems: int, dtype, div: int = TOPK_DIV) -> int:
    """Exact payload size (header included) for ``elems`` elements."""
    dt = np.dtype(dtype)
    if cid == CODEC_NONE:
        body = elems * dt.itemsize
    elif cid == CODEC_FP16:
        body = elems * 2
    elif cid in (CODEC_INT8, CODEC_FP8_E4M3, CODEC_FP8_E5M2):
        body = 4 + elems
    elif cid == CODEC_TOPK:
        body = 4 + topk_k(elems, div) * 8
    else:
        raise ValueError(f"unknown fused codec id {cid}")
    return _HDR.size + body


def scale_from_amax(amax, denom: float) -> np.float32:
    """``amax / denom`` in PURE f32 numpy ops — the one scale rule
    every encode site shares. The device pipeline feeds its (exact)
    device-computed amax through THIS host division rather than
    dividing on device: XLA's constant-divide strength reduction is ~1
    ulp off numpy's IEEE divide, which would break host<->device
    payload byte-identity."""
    amax = np.float32(amax)
    if not amax > 0:
        return np.float32(1.0)
    return np.float32(amax / np.float32(denom))


def amax_scale(x: np.ndarray, denom: float) -> np.float32:
    return scale_from_amax(
        np.max(np.abs(x)) if x.size else 0.0, denom)


def encode(cid: int, arr: np.ndarray, div: int = TOPK_DIV,
           seed: int = 0) -> bytes:
    """Compress a flat dense array into a self-describing payload.

    Lossy codecs run their math in fp32 regardless of the wire dtype
    recorded in the header (the decode target); ``none`` ships the raw
    bytes. Deterministic for every codec: the fp8 rungs' stochastic
    rounding is a pure function of ``(arr, seed)`` (see module
    docstring) — callers that need cross-site byte identity derive
    ``seed`` via :func:`sr_seed`."""
    arr = np.ascontiguousarray(np.asarray(arr).reshape(-1))
    dt = arr.dtype
    hdr = _HDR.pack(MAGIC, VERSION, cid,
                    dt.name.encode()[:8].ljust(8, b"\0"), arr.size)
    if cid == CODEC_NONE:
        return hdr + arr.tobytes()
    x = arr.astype(np.float32, copy=False)
    if cid == CODEC_FP16:
        return hdr + x.astype(np.float16).tobytes()
    if cid == CODEC_INT8:
        scale = amax_scale(x, 127.0)
        # rint = round-half-even, matching jnp.round → the Pallas
        # int8 kernel pair produces byte-identical q for the same scale
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        return hdr + struct.pack("<f", scale) + q.tobytes()
    if cid in FP8_CODECS:
        from ..ops.compression import fp8sr
        kind = _fp8_kind(cid)
        scale = amax_scale(x, fp8sr.fmt_max(kind))
        q = fp8sr.sr_quantize_bits(x, scale, kind, seed)
        return hdr + struct.pack("<f", scale) + q.tobytes()
    if cid == CODEC_TOPK:
        k = topk_k(x.size, div)
        # ties to the lower index (stable argsort of -|x|), matching
        # the legacy HostTopk selection rule
        idx = np.argsort(-np.abs(x), kind="stable")[:k].astype(np.int32)
        return (hdr + struct.pack("<I", k) + idx.tobytes()
                + x[idx].astype(np.float32).tobytes())
    raise ValueError(f"unknown fused codec id {cid}")


def decode_for_store(payload, meta) -> np.ndarray:
    """The one decode recipe the server-side push paths share
    (``HostPSBackend.push_fused``, ``FusedFront.push_fused`` behind the
    transport's OP_PUSH_F): validate the payload against the key's store
    meta, ``(nbytes, dtype, ...)`` or None for an undeclared key, and
    return the dense array in the store's dtype, ready for the engine."""
    if meta is None:
        return decode(payload)
    nbytes, dtype = meta[0], meta[1]
    return decode(payload,
                  expect_elems=int(nbytes) // np.dtype(dtype).itemsize,
                  expect_dtype=dtype)


def peek(payload) -> tuple:
    """(codec_id, dtype_name, elems) of a payload's header, validated.
    Raises :class:`CodecError` on anything that is not a well-formed
    fused payload of THIS version."""
    buf = bytes(payload[:_HDR.size]) if len(payload) >= _HDR.size else \
        bytes(payload)
    if len(buf) < _HDR.size:
        raise CodecError(
            f"fused payload truncated: {len(payload)} bytes is shorter "
            f"than the {_HDR.size}-byte codec header")
    magic, ver, cid, dt, elems = _HDR.unpack(buf)
    if magic != MAGIC:
        raise CodecError(
            f"bad codec magic 0x{magic:04x} (expected 0x{MAGIC:04x}) — "
            f"not a fused compression payload; refusing a torn decode")
    if ver != VERSION:
        raise CodecError(
            f"codec-version mismatch: payload v{ver}, this build speaks "
            f"v{VERSION} — refusing to decode across codec versions")
    if cid >= len(LEVELS):
        raise CodecError(f"unknown codec id {cid} in payload header")
    return cid, dt.rstrip(b"\0").decode(), int(elems)


def validate(payload, expect_elems: int) -> int:
    """STRUCTURAL validation without materializing the dense array —
    every check :func:`decode` would fail on (header, element count,
    body length, topk k/index bounds), so a payload that passes here
    cannot make a later decode raise. The homogeneous sum store runs
    this at INGEST: a torn payload must refuse before it can count as
    a round arrival (refusing inside the merge would discard the other
    workers' buffered arrivals and poison the round). Returns the
    codec id."""
    payload = bytes(payload)
    cid, dt_name, elems = peek(payload)
    if elems != int(expect_elems):
        raise CodecError(
            f"fused payload declares {elems} elements, bucket plan "
            f"expects {expect_elems} — key/plan mismatch")
    body = len(payload) - _HDR.size
    dt = np.dtype(dt_name)
    if cid == CODEC_NONE:
        want = elems * dt.itemsize
    elif cid == CODEC_FP16:
        want = elems * 2
    elif cid in (CODEC_INT8, CODEC_FP8_E4M3, CODEC_FP8_E5M2):
        want = 4 + elems
    else:                                   # CODEC_TOPK
        if body < 4:
            raise CodecError("topk body missing its k prefix")
        (k,) = struct.unpack("<I", payload[_HDR.size:_HDR.size + 4])
        want = 4 + k * 8
        if body == want and k:
            idx = np.frombuffer(payload, np.int32,
                                count=k, offset=_HDR.size + 4)
            if idx.min() < 0 or idx.max() >= elems:
                raise CodecError(
                    f"topk index out of range 0..{elems} — torn payload")
    if body != want:
        raise CodecError(
            f"{codec_name(cid)} body is {body} bytes for {elems} "
            f"elements (expected {want})")
    return cid


def decode(payload, expect_elems: Optional[int] = None,
           expect_dtype=None) -> np.ndarray:
    """Decompress a payload to its dense flat array (header dtype, or
    ``expect_dtype`` when given). Every structural inconsistency —
    element-count mismatch with the caller's bucket plan, body length
    disagreeing with the header — is a :class:`CodecError`."""
    payload = bytes(payload)
    cid, dt_name, elems = peek(payload)
    if expect_elems is not None and elems != expect_elems:
        raise CodecError(
            f"fused payload declares {elems} elements, bucket plan "
            f"expects {expect_elems} — key/plan mismatch")
    dt = np.dtype(dt_name)
    body = payload[_HDR.size:]
    if cid == CODEC_NONE:
        if len(body) != elems * dt.itemsize:
            raise CodecError(
                f"dense body is {len(body)} bytes, header says "
                f"{elems}x{dt.itemsize}")
        out = np.frombuffer(body, dt).copy()
    elif cid == CODEC_FP16:
        if len(body) != elems * 2:
            raise CodecError(
                f"fp16 body is {len(body)} bytes for {elems} elements")
        out = np.frombuffer(body, np.float16).astype(np.float32)
    elif cid == CODEC_INT8:
        if len(body) != 4 + elems:
            raise CodecError(
                f"int8 body is {len(body)} bytes for {elems} elements")
        (scale,) = struct.unpack("<f", body[:4])
        out = np.frombuffer(body[4:], np.int8).astype(np.float32) * scale
    elif cid in FP8_CODECS:
        if len(body) != 4 + elems:
            raise CodecError(
                f"fp8 body is {len(body)} bytes for {elems} elements")
        (scale,) = struct.unpack("<f", body[:4])
        from ..ops.compression import fp8sr
        out = fp8sr.decode_bits(np.frombuffer(body[4:], np.uint8),
                                _fp8_kind(cid)) * np.float32(scale)
    elif cid == CODEC_TOPK:
        if len(body) < 4:
            raise CodecError("topk body missing its k prefix")
        (k,) = struct.unpack("<I", body[:4])
        if len(body) != 4 + k * 8:
            raise CodecError(
                f"topk body is {len(body)} bytes for k={k}")
        idx = np.frombuffer(body[4:4 + k * 4], np.int32)
        vals = np.frombuffer(body[4 + k * 4:], np.float32)
        if k and (idx.min() < 0 or idx.max() >= elems):
            raise CodecError(
                f"topk index out of range 0..{elems} — torn payload")
        out = np.zeros(elems, np.float32)
        out[idx] = vals
    else:  # pragma: no cover — peek() already refused
        raise CodecError(f"unknown codec id {cid}")
    want = np.dtype(expect_dtype) if expect_dtype is not None else dt
    return out.astype(want, copy=False)


# how many re-encoded rounds each key keeps: every worker pulls round r
# before it pushes r+1 (the admission gate), so r+2 cannot complete while
# r is still wanted; 4 is well past the rounds in flight
_CACHE_ROUNDS = 4


class FusedPullCache:
    """A backend's cache of encoded merged rounds for the engine-side fused
    pull. Only a throughput cache: every codec is deterministic, so a miss
    re-encodes the same bytes; a hit skips the dense copy out of the engine
    and the encode for every puller after the first."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> {(round, codec, div): payload}, evicted in insertion order
        self._cache: Dict[int, Dict[tuple, bytes]] = {}

    def get(self, key: int, rnd: int, cid: int,
            div: int = TOPK_DIV) -> Optional[bytes]:
        if rnd == 0:
            return None          # round 0 is "the latest": never cached
        with self._lock:
            return self._cache.get(key, {}).get((rnd, cid, div))

    def put(self, key: int, rnd: int, cid: int, payload: bytes,
            div: int = TOPK_DIV) -> None:
        if rnd == 0:
            return
        with self._lock:
            rounds = self._cache.setdefault(key, {})
            rounds.setdefault((rnd, cid, div), payload)
            while len(rounds) > _CACHE_ROUNDS:
                rounds.pop(next(iter(rounds)))

    def drop(self, key: int) -> None:
        """Forget a key's cached rounds. Called at every (re-)init: a
        re-initialized store may restart its rounds, and the cache would
        then serve the previous tenancy's payloads for the recurring round
        numbers."""
        with self._lock:
            self._cache.pop(key, None)


def pull_encoded(backend, cache: Optional[FusedPullCache], key: int,
                 nbytes: int, dtype: str, cid: int, rnd: int,
                 timeout_ms: int = 30000, div: int = TOPK_DIV) -> bytes:
    """The one engine-side fused-pull recipe (``HostPSBackend``,
    ``FusedFront``): a cache hit, else the round-blocked dense pull out of
    the engine, ``encode`` at the requested codec, cached. ``div`` is the
    puller's topk divisor and part of the cache key."""
    if cache is not None:
        hit = cache.get(key, rnd, cid, div)
        if hit is not None:
            return hit
    dense = np.empty(int(nbytes) // np.dtype(dtype).itemsize,
                     dtype=np.dtype(dtype))
    backend.pull(key, dense, round=rnd, timeout_ms=timeout_ms)
    # the fp8 SR seed pinned to (key, round) at every serve site, so this
    # re-encode and the homogeneous store's serve the same bytes
    payload = encode(cid, dense, div=div, seed=sr_seed(key, rnd))
    if cache is not None:
        cache.put(key, rnd, cid, payload, div)
    return payload
