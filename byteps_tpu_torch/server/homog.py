"""Codec-homogeneous server summation for the fused compression plane (the
port's copy of ``byteps_tpu/server/homog.py``). ``FusedSumStore`` serves
``HostPSBackend``; ``FusedFront`` gives a raw ``PSServer`` behind the
transport server (``server/transport.py``) the same store.

The store takes over the ROUND of every fused-managed key:

  - pushes (fused payloads AND dense rounds of managed keys) are buffered
    per key; the ``num_workers``-th arrival completes the round, the
    engine's publication rule;
  - a round whose arrivals all carry the SAME lossy codec (int8/fp8/fp16,
    scalar-widenable) is merged in one widen->add pass per payload
    straight into the f32 accumulator, with no dense decode through the
    engine (``server/fused_rounds_homog`` vs ``server/fused_dense_decodes``);
  - heterogeneous arrivals (topk, mixed dense/fused rounds) fall back to
    the dense sum, counted in ``server/fused_rounds_fallback`` and bit-
    identical to the engine path;
  - BITWISE PARITY: the accumulator applies the exact float ops the dense
    path applies (per-payload ``widen * scale``, then arrival-order adds;
    the first arrival copies), and the merged payload is produced by
    ``wire.encode`` under the same ``sr_seed(key, round)`` the dense pull
    re-encode uses.

Round numbering is shard-local starting at 0, matching the engine
(``init_key`` on an existing key = a new tenancy = reset).

``BPS_FUSED_HOMOG`` (``homog_enabled``, read from ``os.environ`` at each
fused declaration, as ``byteps_tpu/server/homog.py:63-65`` reads it; off is
``0``, ``off``, ``false`` or ``no``) selects who owns a key declared
``fused=True``: this store (the default), or, at off, the summation engine.
A fused push to a key the store does not own takes the engine-side route
(``byteps_tpu/server/homog.py:325-395``): ``wire.decode_for_store`` decodes
it into the engine, counted in ``server/fused_dense_decodes`` when its
codec is lossy, and a fused pull is the engine's merged round re-encoded by
``wire.pull_encoded`` through a ``wire.FusedPullCache``. Both routes give
the same bytes: the store's first arrival copies and the rest add in
arrival order, as the engine sums.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..common.logging import get_logger
from ..compress import wire
from ..obs.metrics import get_registry

log = get_logger()

#: codecs whose payloads widen into the f32 accumulator in one pass
#: (scalar scale or none): topk stays on the dense fallback — a sparse
#: union-sum is not a widen, and re-selection needs the dense merge
DIRECT_CODECS = (wire.CODEC_FP16, wire.CODEC_INT8, wire.CODEC_FP8_E4M3,
                 wire.CODEC_FP8_E5M2)


def homog_enabled() -> bool:
    """Whether the homogeneous store owns the keys declared fused
    (``BPS_FUSED_HOMOG``, default on)."""
    return (os.environ.get("BPS_FUSED_HOMOG", "1") or "1") \
        .strip().lower() not in ("0", "off", "false", "no")


class _Merged:
    __slots__ = ("dense", "payloads")

    def __init__(self, dense: np.ndarray) -> None:
        self.dense = dense          # merged f32/store-dtype round
        self.payloads: Dict[tuple, bytes] = {}   # (cid, div) -> encoded
        #   lazily wire.encode'd on first pull at that codec — the
        #   merged SUM always needs a renormalizing re-encode, so there
        #   is no stored-arrival payload to serve directly


class _KeyState:
    __slots__ = ("nbytes", "dtype", "elems", "init", "completed",
                 "arrivals", "rounds", "cv", "warned")

    def __init__(self, nbytes: int, dtype: str,
                 init: Optional[np.ndarray]) -> None:
        self.nbytes = int(nbytes)
        self.dtype = np.dtype(dtype)
        self.elems = self.nbytes // self.dtype.itemsize
        self.init = None if init is None else \
            np.array(init, dtype=self.dtype).reshape(-1)
        self.completed = 0
        self.arrivals: list = []    # ("p", bytes) | ("d", ndarray)
        self.rounds: Dict[int, _Merged] = {}
        self.cv = threading.Condition()
        self.warned = False


class FusedSumStore:
    """Per-server round store for fused-managed keys (see module doc),
    embedded by ``HostPSBackend``."""

    def __init__(self, num_workers: int, retain: int = 4) -> None:
        self.num_workers = max(1, int(num_workers))
        self.retain = max(2, int(retain))
        self._lock = threading.Lock()
        self._keys: Dict[int, _KeyState] = {}
        reg = get_registry()
        self.m_homog = reg.counter("server/fused_rounds_homog")
        self.m_fallback = reg.counter("server/fused_rounds_fallback")
        self.m_decodes = reg.counter("server/fused_dense_decodes")
        self.m_merge_cpu = reg.counter("server/fused_merge_cpu_s")
        self.m_pull_hits = reg.counter("server/fused_pull_hits")
        self.m_pull_encodes = reg.counter("server/fused_pull_encodes")

    # ------------------------------------------------------- lifecycle

    def init_key(self, key: int, nbytes: int, dtype: str = "float32",
                 init: Optional[np.ndarray] = None) -> None:
        """Register (or RESET: a re-init is a new tenancy of the key) a
        managed key."""
        with self._lock:
            self._keys[int(key)] = _KeyState(nbytes, dtype, init)

    def managed(self, key: int) -> bool:
        return int(key) in self._keys

    def drop(self, key: int) -> None:
        with self._lock:
            self._keys.pop(int(key), None)

    def _st(self, key: int) -> _KeyState:
        st = self._keys.get(int(key))
        if st is None:
            raise KeyError(f"key {key} is not fused-managed")
        return st

    # ------------------------------------------------------ push side

    def ingest(self, key: int, payload) -> None:
        """One worker's fused payload for the key's pending round.
        STRUCTURALLY validated (``wire.validate`` — header, element
        count, body length, topk index bounds) BEFORE it can count as
        an arrival: a torn payload that refused only inside the merge
        would discard the other workers' buffered arrivals and poison
        the round; validated here, the merge cannot raise for payload
        reasons and the torn pusher's retry completes the round."""
        st = self._st(key)
        try:
            wire.validate(payload, st.elems)
        except wire.CodecError as e:
            raise wire.CodecError(f"key {key}: {e}") from None
        self._arrive(key, st, ("p", bytes(payload)))

    def ingest_dense(self, key: int, arr: np.ndarray) -> None:
        """A dense push of a managed key (a level-``none`` round, or a
        divergent worker's dense arrival). Copies — the caller reuses
        its buffer."""
        st = self._st(key)
        a = np.asarray(arr).reshape(-1)
        if a.nbytes != st.nbytes:
            # wire transcode mirror: narrow pushes land in store dtype
            a = a.astype(st.dtype)
            if a.nbytes != st.nbytes:
                raise ValueError(
                    f"dense push of {arr.nbytes}B for key {key}, store "
                    f"holds {st.nbytes}B")
        if a.dtype != st.dtype:
            a = a.astype(st.dtype)
        self._arrive(key, st, ("d", np.array(a, copy=True)))

    def _arrive(self, key: int, st: _KeyState, item: tuple) -> None:
        with st.cv:
            st.arrivals.append(item)
            if len(st.arrivals) < self.num_workers:
                return
            arrivals, st.arrivals = st.arrivals, []
            t0 = time.thread_time()
            merged = self._merge(key, st, arrivals)
            self.m_merge_cpu.inc(time.thread_time() - t0)
            st.completed += 1
            st.rounds[st.completed] = merged
            old = st.completed - self.retain
            if old in st.rounds:
                del st.rounds[old]
            st.cv.notify_all()

    def _widen_into(self, acc: Optional[np.ndarray],
                    payload: bytes, st: _KeyState) -> np.ndarray:
        """One fused widen->scale(->add) pass — float-op-identical to
        ``wire.decode`` followed by the engine's arrival-order sum
        (first arrival copies, the rest add in place)."""
        dec = wire.decode(payload, st.elems, st.dtype)
        if acc is None:
            return dec
        np.add(acc, dec, out=acc)
        return acc

    def _merge(self, key: int, st: _KeyState, arrivals: list) -> _Merged:
        cids = [wire.peek(p)[0] if k == "p" else None
                for k, p in arrivals]
        homog = (cids[0] in DIRECT_CODECS
                 and all(c == cids[0] for c in cids))
        acc: Optional[np.ndarray] = None
        if homog:
            for _, p in arrivals:
                acc = self._widen_into(acc, p, st)
            self.m_homog.inc()
            return _Merged(acc)
        # dense / heterogeneous fallback — bit-identical to the engine
        # path (decode each arrival, arrival-order sum). Loud only when
        # a LOSSY payload had to dense-decode: an all-dense round is
        # just a level-none round doing its job.
        lossy = [c for c in cids if c not in (None, wire.CODEC_NONE)]
        for kind, p in arrivals:
            if kind == "d":
                dec = p
            else:
                dec = wire.decode(p, st.elems, st.dtype)
                if wire.lossy(wire.peek(p)[0]):
                    self.m_decodes.inc()
            if acc is None:
                # both kinds are store-private: ingest_dense copied the
                # dense arrival, decode allocated the payload's —
                # accumulate in place, no extra full-bucket memcpy
                acc = dec
            else:
                np.add(acc, dec, out=acc)
        if lossy:
            self.m_fallback.inc()
            if not st.warned:
                st.warned = True
                log.warning(
                    "fused key %d round %d fell back to the dense merge "
                    "(arrival codecs %s) — divergent per-worker decision"
                    " traces or a non-widenable codec; the homogeneous "
                    "decode-free sum needs every worker at one codec",
                    key, st.completed + 1,
                    [wire.codec_name(c) if c is not None else "dense"
                     for c in cids])
        return _Merged(acc)

    # ------------------------------------------------------ pull side

    def _wait_round(self, key: int, st: _KeyState, rnd: int,
                    timeout_ms: int) -> _Merged:
        deadline = time.monotonic() + timeout_ms / 1e3
        with st.cv:
            while st.completed < rnd:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"pull({key}) round={rnd} timed out after "
                        f"{timeout_ms}ms (fused store at round "
                        f"{st.completed})")
                st.cv.wait(min(left, 0.5))
            if rnd not in st.rounds:
                raise ValueError(
                    f"pull({key}) round={rnd}: round evicted from the "
                    f"fused store (retains {self.retain}, completed "
                    f"{st.completed}) — puller fell outside the "
                    f"in-flight window")
            return st.rounds[rnd]

    def pull_dense(self, key: int, out: np.ndarray, round: int = 0,
                   timeout_ms: int = 30000) -> None:
        st = self._st(key)
        if round == 0:
            with st.cv:
                if st.completed == 0:
                    src = st.init if st.init is not None else \
                        np.zeros(st.elems, st.dtype)
                else:
                    src = st.rounds[st.completed].dense
        else:
            src = self._wait_round(key, st, int(round), timeout_ms).dense
        if out.dtype == src.dtype:
            np.copyto(out.reshape(-1), src)
        else:
            np.copyto(out.reshape(-1), src.astype(out.dtype))

    def pull_payload(self, key: int, cid: int, round: int,
                     timeout_ms: int = 30000,
                     div: int = wire.TOPK_DIV) -> bytes:
        """The merged round at the requested codec: the stored merge's
        bytes when already encoded, else ONE ``wire.encode`` under the
        shared ``sr_seed(key, round)`` (byte-identical to the dense
        path's pull re-encode), cached per (codec, div)."""
        st = self._st(key)
        rnd = int(round)
        if rnd == 0:
            with st.cv:
                rnd = st.completed
            if rnd == 0:
                raise ValueError(
                    f"pull_fused({key}) round=0 with no completed round")
        m = self._wait_round(key, st, rnd, timeout_ms)
        with st.cv:
            hit = m.payloads.get((cid, div))
        if hit is not None:
            self.m_pull_hits.inc()
            return hit
        payload = wire.encode(cid, m.dense, div=div,
                              seed=wire.sr_seed(key, rnd))
        self.m_pull_encodes.inc()
        with st.cv:
            m.payloads.setdefault((cid, div), payload)
        return payload

    # -------------------------------------------------- observability

    def round(self, key: int) -> int:
        st = self._st(key)
        with st.cv:
            return st.completed

    def pending(self) -> int:
        """Buffered-but-unmerged arrivals across keys, folded into the
        server's backlog gauge."""
        with self._lock:
            keys = list(self._keys.values())
        return sum(len(st.arrivals) for st in keys)


class FusedFront:
    """Fused and dense front for a raw dense backend (the native
    ``PSServer`` behind a transport server): managed keys go to a
    ``FusedSumStore``, every other key straight through, the split
    ``HostPSBackend`` makes internally (``byteps_tpu/server/homog.py:325``).
    A fused push or pull of a key the store does not own (every fused key
    at ``BPS_FUSED_HOMOG=0``) takes the engine-side route of the module
    docstring, with this front's ``FusedPullCache``, which every
    ``init_key`` of the key clears.

    A fused re-declaration with the key's size and dtype keeps its rounds
    and buffered arrivals, as the engine keeps a dense key's: every worker
    of a standalone server declares every key, and a client replays its
    declarations after a reconnect, so a reset there would drop the
    arrivals of workers that pushed first and wedge the round. The JAX
    package's front resets the key on every fused init (a new tenancy,
    its key-migration rule; ROADMAP.md queue 3). Another size or dtype is
    a new tenancy here too."""

    def __init__(self, backend, num_workers: int) -> None:
        self.backend = backend
        self.store = FusedSumStore(num_workers)
        self._cache = wire.FusedPullCache()
        self._meta: Dict[int, tuple] = {}   # key -> (nbytes, dtype)

    def init_key(self, key: int, nbytes: int, dtype: str = "float32",
                 init: Optional[np.ndarray] = None,
                 fused: bool = False) -> None:
        if fused and homog_enabled():
            st = self.store._keys.get(int(key))
            if (st is None or st.nbytes != int(nbytes)
                    or st.dtype != np.dtype(dtype)):
                self.store.init_key(key, nbytes, dtype, init)
        elif self.store.managed(key):
            self.store.drop(key)    # re-declared non-fused: hand back
        self._meta[int(key)] = (int(nbytes), dtype)
        self._cache.drop(key)
        self.backend.init_key(key, nbytes, dtype, init)

    def push(self, key: int, data: np.ndarray) -> None:
        if self.store.managed(key):
            self.store.ingest_dense(key, data)
        else:
            self.backend.push(key, data)

    def pull(self, key: int, out: np.ndarray, round: int = 0,
             timeout_ms: int = 30000) -> None:
        if self.store.managed(key):
            self.store.pull_dense(key, out, round, timeout_ms)
        else:
            self.backend.pull(key, out, round=round, timeout_ms=timeout_ms)

    def push_fused(self, key: int, payload) -> None:
        if self.store.managed(key):
            self.store.ingest(key, payload)
            return
        # the engine-side route: decoded into the engine, a lossy decode
        # counted (a `none` frame is a view of the bytes, not a decode)
        dense = wire.decode_for_store(payload, self._meta.get(int(key)))
        if wire.lossy(wire.peek(payload)[0]):
            self.store.m_decodes.inc()
        self.backend.push(key, dense)

    def pull_fused(self, key: int, nbytes: int, dtype: str, codec: int,
                   round: int = 0, timeout_ms: int = 30000,
                   div: Optional[int] = None) -> bytes:
        if self.store.managed(key):
            return self.store.pull_payload(
                key, codec, round, timeout_ms, div=div or wire.TOPK_DIV)
        return wire.pull_encoded(self.backend, self._cache, key, nbytes,
                                 dtype, codec, round, timeout_ms=timeout_ms,
                                 div=div or wire.TOPK_DIV)

    def round(self, key: int) -> int:
        if self.store.managed(key):
            return self.store.round(key)
        return int(self.backend.round(key))
