"""Compressed keys of the in-process server (the port's copy of
``byteps_tpu/server/compressed.py``).

The reference server registers a compressor per key from the kwargs the
worker serializes at init (server.cc:222-252), decompresses every push
before handing it to the summation engine, and re-compresses the merged
buffer once per round, so pulls ship compressed bytes back
(server.cc:86-113). ``CompressedKeyStore`` is that logic, wrapped around a
server shard (``server/engine.py::PSServer``).

With ``BPS_NATIVE_CODEC`` on (the default), a bare onebit or topk chain on
an fp32 key runs fused in the engine (``bps_server_push_onebit`` /
``pull_onebit``, ``push_topk`` / ``pull_topk``: decompress into the
summation and pull plus recompress in one call each); a bare randomk key
pushes through the topk entry (the same wire layout and scatter) and keeps
its recompress here, where its generator's state lives. Every other chain
(error feedback, dithering, non-fp32 keys) runs in Python, its O(n) loops
in the native primitives of ``ops/compression/host.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.compression.host import (HostCodec, HostErrorFeedback,
                                    HostOnebit, HostRandomk, HostTopk,
                                    create_server_chain)

# recompressed rounds kept a key: every worker pulls round r before r + 2
# can complete (it must push r + 1 first), so 4 is safe for the stochastic
# codecs, where a second compress would give other bytes
_CACHE_ROUNDS = 4


class CompressedKeyStore:
    """Per-key server chains and the once-per-round recompression cache."""

    def __init__(self) -> None:
        self._codecs: Dict[int, HostCodec] = {}
        self._kwargs: Dict[int, Tuple] = {}
        self._lock = threading.Lock()
        # key -> {round: payload}, in insertion order for eviction
        self._cache: Dict[int, Dict[int, bytes]] = {}

    def register(self, key: int, kwargs: Dict[str, str], size: int,
                 dtype: str) -> Optional[HostCodec]:
        """Idempotent per key (every worker's init arrives). Another
        worker's different kwargs would make its payloads misparse:
        raise."""
        ident = (tuple(sorted(kwargs.items())), int(size), str(dtype))
        with self._lock:
            codec = self._codecs.get(key)
            if codec is not None:
                if self._kwargs[key] != ident:
                    raise ValueError(
                        f"key {key} already registered with "
                        f"{self._kwargs[key]}, re-register with {ident} "
                        f"— workers disagree on compression config")
                return codec
            codec = create_server_chain(kwargs, size, dtype)
            if codec is not None:
                self._codecs[key] = codec
                self._kwargs[key] = ident
                self._cache[key] = {}
            return codec

    def cached(self, key: int, rnd: int) -> Optional[bytes]:
        """The recompressed payload of a completed round, if still kept."""
        if rnd == 0:
            return None
        with self._lock:
            return self._cache.get(key, {}).get(rnd)

    def has(self, key: int) -> bool:
        return key in self._codecs

    def codec(self, key: int) -> HostCodec:
        return self._codecs[key]

    def payload_nbytes(self, key: int) -> int:
        return self._codecs[key].payload_nbytes()

    def decompress(self, key: int, payload) -> np.ndarray:
        return self._codecs[key].decompress(payload)

    def recompress(self, key: int, dense: np.ndarray, rnd: int) -> bytes:
        """Compress the merged buffer of ``rnd``, cached so every worker
        pulling the round gets the same bytes, stochastic codecs too.
        Round 0 (the latest) is never cached and bypasses the error
        feedback's state: its round-over-round compensation belongs to the
        once-per-round sync path."""
        if rnd == 0:
            codec = self._codecs[key]
            if isinstance(codec, HostErrorFeedback):
                codec = codec.inner
            return codec.compress(dense)
        with self._lock:
            rounds = self._cache[key]
            buf = rounds.get(rnd)
            if buf is None:
                buf = self._codecs[key].compress(dense)
                rounds[rnd] = buf
                while len(rounds) > _CACHE_ROUNDS:
                    rounds.pop(next(iter(rounds)))
            return buf

    def put_cached(self, key: int, rnd: int, buf: bytes) -> None:
        """Keep a natively recompressed payload of a completed round, with
        ``recompress``'s eviction."""
        if rnd == 0:
            return
        with self._lock:
            rounds = self._cache[key]
            rounds.setdefault(rnd, buf)
            while len(rounds) > _CACHE_ROUNDS:
                rounds.pop(next(iter(rounds)))

    def reset(self) -> None:
        with self._lock:
            self._codecs.clear()
            self._cache.clear()


def native_route(store: CompressedKeyStore, key: int):
    """``(kind, codec)`` when the key's chain runs fused in the engine:
    bare onebit or topk on fp32 both ways (``"onebit"``, ``"topk"``), bare
    randomk on its push (``"randomk_push"``); else ``(None, None)``."""
    if os.environ.get("BPS_NATIVE_CODEC", "1") in ("0", "false"):
        return None, None
    codec = store._codecs.get(key)
    if codec is None or codec.dtype != np.float32:
        return None, None
    if isinstance(codec, HostOnebit):
        return "onebit", codec
    if type(codec) is HostTopk:
        return "topk", codec
    if type(codec) is HostRandomk:
        return "randomk_push", codec
    return None, None


def compressed_push(store: CompressedKeyStore, shard, key: int,
                    payload) -> None:
    """Decompress into the shard's summation (reference: decompress before
    SUM_RECV, server.cc:86-113)."""
    kind, codec = native_route(store, key)
    if kind is not None and len(payload) != codec.payload_nbytes():
        # the Python decompress raises on a mis-sized frame; the native
        # scatter must not split one into garbage indices and values
        raise ValueError(
            f"key {key}: compressed payload is {len(payload)} "
            f"bytes, codec expects {codec.payload_nbytes()}")
    if kind == "onebit":
        shard.push_onebit(key, payload)
        return
    if kind in ("topk", "randomk_push"):
        shard.push_topk(key, payload)
        return
    shard.push(key, store.decompress(key, payload))


def compressed_pull(store: CompressedKeyStore, shard, key: int,
                    rnd: int, timeout_ms: int = 30000) -> bytes:
    """The merged round, recompressed once and cached: later pullers of
    the round skip the dense copy out of the engine."""
    buf = store.cached(key, rnd)
    if buf is not None:
        return buf
    kind, codec = native_route(store, key)
    if kind == "onebit":
        buf = shard.pull_onebit(key, codec.payload_nbytes(), round=rnd,
                                timeout_ms=timeout_ms,
                                use_scale=codec.use_scale)
    elif kind == "topk":
        buf = shard.pull_topk(key, codec.payload_nbytes(), round=rnd,
                              timeout_ms=timeout_ms)
    else:
        codec = store.codec(key)
        dense = np.empty(codec.size, codec.dtype)
        shard.pull(key, dense, round=rnd, timeout_ms=timeout_ms)
        return store.recompress(key, dense, rnd)
    store.put_cached(key, rnd, buf)
    return buf
