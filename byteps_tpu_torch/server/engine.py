"""Python bindings of the port's native host reduction service (the port's
copy of the in-process half of ``byteps_tpu/server/engine.py``).

The reference loads its server as a ctypes CDLL (reference:
server/__init__.py:21-27); the port does the same for its own copy of the
summation engine, ``csrc/host/bps_server.cc``, built at first use by
``ops/_build_host.py``. ``PSServer`` is one server shard; ``HostPSBackend``
drives a set of shards from the worker side, giving the sync exchange its
PS route: host numpy → key stores placed by hash (``common.naming.place_key``)
→ summation engine → pull. Keys declared ``fused=True`` have their rounds
owned by the homogeneous fused store (``server/homog.py``) unless
``BPS_FUSED_HOMOG`` is off; a fused push to any other key is decoded into
the engine (``wire.decode_for_store``, counted in
``server/fused_dense_decodes``) and its fused pull is the engine's merged
round re-encoded (``wire.pull_encoded``, through a ``FusedPullCache`` that
every ``init_key`` of the key clears), as
``byteps_tpu/server/engine.py:499-530, 782-818`` does. Keys declared with
``compression=`` kwargs (the legacy chains, which never take fused
payloads) register a server chain in ``server/compressed.py``: their
pushes arrive compressed and are decompressed into the summation, their
pulls are the merged round recompressed once (reference:
server.cc:86-113, 222-252).

A ``PSServer`` also serves other processes: ``server/transport.py``'s
``PSTransportServer`` fronts it over TCP (``python -m
byteps_tpu_torch.launcher.launch --server``), and the workers'
``RemotePSBackend`` stands in for ``HostPSBackend``.

Both take ``async_mode`` (``BPS_ENABLE_ASYNC``, the async PS path of
``server/ps_mode.py::AsyncPSWorker``): the engine then sums every push
straight into the served store and bumps the key's round, and a pull
copies the store without waiting (``csrc/host/bps_server.cc``).
``PSServer`` records each key's store dtype at ``init_key``: a push of
another dtype is cast to it, and a pull into another dtype goes through a
buffer of the store's dtype, as ``byteps_tpu/server/engine.py:224-255``
does in process (bfloat16 through ``common/bf16.py``): a bf16 weight
delta lands in an fp32 store.

``HostPSBackend`` also holds the sharded weight update's param mailbox
(``param_put`` / ``param_get`` / ``param_latest``, a
``sharded_update.ParamStore`` made at first use), and the bounded-staleness
round store (``declare_lag`` / ``push_lag`` / ``pull_lag``, a
``server/admission.py::StaleStore`` made at the first declaration, so a
K=1 deployment never allocates it; ``round`` answers from it for a
managed key).

``push_rowsparse`` is the row-sparse push (``server/rowsparse.py``): the
touched rows scattered into a dense table, which the engine sums like any
push, the table's cols pinned per key at its first push
(``server/rowsparse_pushes`` counts them).

Not ported yet (ROADMAP.md): key migration.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..common import bf16
from ..common.naming import log_key_placement, place_key
from ..obs.metrics import get_registry, metrics_enabled

_DTYPES = {"float32": 0, "float64": 1, "int32": 2, "int64": 3,
           "float16": 4, "bfloat16": 5, "uint8": 6}


def _lib() -> ctypes.CDLL:
    from ..ops._build_host import load
    return load()


def _addr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_segments(srcs, dst_offs, lens, dst: np.ndarray) -> None:
    """Gather ``len(srcs)`` byte ranges into ``dst`` natively (GIL
    released, OpenMP across segments). ``srcs``: raw source addresses;
    offsets and lengths in bytes."""
    n = len(srcs)
    _lib().bps_pack_segments(
        (ctypes.c_void_p * n)(*srcs), (ctypes.c_uint64 * n)(*dst_offs),
        (ctypes.c_uint64 * n)(*lens), n, _addr(dst))


def unpack_segments(src: np.ndarray, src_offs, dsts, lens) -> None:
    """Scatter byte ranges of ``src`` to raw destination addresses."""
    n = len(dsts)
    _lib().bps_unpack_segments(
        _addr(src), (ctypes.c_uint64 * n)(*src_offs),
        (ctypes.c_void_p * n)(*dsts), (ctypes.c_uint64 * n)(*lens), n)


def reduce_sum_inplace(dst: np.ndarray, src: np.ndarray) -> None:
    """dst += src via the native typed reducer (reference: CpuReducer::sum)."""
    if dst.dtype != src.dtype or dst.nbytes != src.nbytes:
        raise ValueError(f"reduce_sum_inplace: {dst.dtype}[{dst.size}] += "
                         f"{src.dtype}[{src.size}]")
    _lib().bps_reduce_sum(_addr(dst), _addr(src), dst.nbytes,
                          _DTYPES[str(dst.dtype)])


class ServerClosed(RuntimeError):
    """The server is shutting down."""


class PSServer:
    """One native server shard (reference: byteps_server(), server.cc:441-514)."""

    def __init__(self, num_workers: int, engine_threads: int = 4,
                 enable_schedule: bool = False,
                 async_mode: bool = False) -> None:
        self._lib = _lib()
        self._h = self._lib.bps_server_create(
            num_workers, engine_threads, int(enable_schedule),
            int(async_mode))
        if not self._h:
            raise RuntimeError("bps_server_create failed")
        self.num_workers = num_workers
        self.engine_threads = engine_threads
        self.async_mode = async_mode
        self._key_dtypes: Dict[int, str] = {}   # key -> its store's dtype
        # close() may race callers blocked in pull: an in-flight count plus
        # the native two-phase shutdown (begin_shutdown wakes and refuses,
        # destroy frees only after the drain)
        self._cv = threading.Condition()
        self._inflight = 0
        self._closed = False

    def _enter(self) -> None:
        with self._cv:
            if self._closed:
                raise ServerClosed("server closed")
            self._inflight += 1

    def _exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    def _call(self, fn, *args):
        self._enter()
        try:
            return fn(self._h, *args)
        finally:
            self._exit()

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            h = self._h
        if h:
            # wake blocked pulls (they return rc=-5), then wait for every
            # in-flight call to leave before freeing the handle
            self._lib.bps_server_begin_shutdown(h)
            with self._cv:
                while self._inflight:
                    self._cv.wait(timeout=1.0)
            self._lib.bps_server_destroy(h)
            self._h = None

    def init_key(self, key: int, nbytes: int, dtype: str = "float32",
                 init: Optional[np.ndarray] = None) -> None:
        ptr = None if init is None else _addr(np.ascontiguousarray(init))
        rc = self._call(self._lib.bps_server_init_key, key, nbytes,
                        _DTYPES[dtype], ptr)
        if rc == -5:
            raise ServerClosed(f"init_key({key}): server shutting down")
        if rc != 0:
            raise RuntimeError(f"init_key({key}) failed rc={rc}")
        self._key_dtypes[key] = dtype

    def push(self, key: int, data: np.ndarray) -> None:
        store = self._key_dtypes.get(key)
        if store is not None and bf16.dtype_name(data) != store:
            data = bf16.cast(data, store)   # a narrow delta, a wide store
        data = np.ascontiguousarray(data)
        rc = self._call(self._lib.bps_server_push, key, _addr(data),
                        data.nbytes)
        if rc == -5:
            raise ServerClosed(f"push({key}): server shutting down")
        if rc != 0:
            raise RuntimeError(f"push({key}) failed rc={rc} (length "
                               f"mismatch or key not initialised)")

    def pull(self, key: int, out: np.ndarray, round: int = 0,
             timeout_ms: int = 30000) -> None:
        """Pull round ``round`` (1-based; 0 = latest published) into the
        contiguous array ``out``; an ``out`` of another dtype than the
        store's gets the store cast to it."""
        store = self._key_dtypes.get(key)
        if store is not None and bf16.dtype_name(out) != store:
            tmp = np.empty(out.size, bf16.np_dtype(store))
            self.pull(key, tmp, round=round, timeout_ms=timeout_ms)
            np.copyto(out, bf16.cast(tmp, bf16.dtype_name(out))
                      .reshape(out.shape))
            return
        rc = self._call(self._lib.bps_server_pull, key, _addr(out),
                        out.nbytes, round, timeout_ms)
        if rc == -2:
            raise TimeoutError(f"pull({key}) round={round} timed out "
                               f"after {timeout_ms}ms")
        if rc == -5:
            raise ServerClosed(f"pull({key}): server shutting down")
        if rc != 0:
            raise RuntimeError(f"pull({key}) failed rc={rc}")

    def round(self, key: int) -> int:
        return int(self._call(self._lib.bps_server_round, key))

    def _check(self, what: str, key: int, rc: int, round: int = 0,
               timeout_ms: int = 0) -> None:
        if rc == -2:
            raise TimeoutError(f"{what}({key}) round={round} timed out "
                               f"after {timeout_ms}ms")
        if rc == -5:
            raise ServerClosed(f"{what}({key}): server shutting down")
        if rc != 0:
            raise RuntimeError(f"{what}({key}) failed rc={rc} (bad payload "
                               f"length or a key that is not fp32)")

    def push_onebit(self, key: int, payload) -> None:
        """Decompress a onebit payload into the key's summation, in the
        engine (fp32 keys)."""
        buf = np.frombuffer(bytes(payload), np.uint8)
        self._check("push_onebit", key, self._call(
            self._lib.bps_server_push_onebit, key, _addr(buf), buf.nbytes))

    def pull_onebit(self, key: int, payload_nbytes: int, round: int = 0,
                    timeout_ms: int = 30000,
                    use_scale: bool = False) -> bytes:
        """The merged round's pull and its onebit recompress in one call."""
        out = np.empty(payload_nbytes, np.uint8)
        self._check("pull_onebit", key, self._call(
            self._lib.bps_server_pull_onebit, key, _addr(out), out.nbytes,
            round, timeout_ms, int(use_scale)), round, timeout_ms)
        return out.tobytes()

    def push_topk(self, key: int, payload) -> None:
        """Scatter a (k int32 indices | k fp32 values) payload into the
        key's summation; a repeated index keeps its last value."""
        buf = np.frombuffer(bytes(payload), np.uint8)
        self._check("push_topk", key, self._call(
            self._lib.bps_server_push_topk, key, _addr(buf), buf.nbytes))

    def pull_topk(self, key: int, payload_nbytes: int, round: int = 0,
                  timeout_ms: int = 30000) -> bytes:
        """The merged round's pull and its top-k reselection (largest |x|,
        ties to the lower index: ``HostTopk``'s)."""
        out = np.empty(payload_nbytes, np.uint8)
        self._check("pull_topk", key, self._call(
            self._lib.bps_server_pull_topk, key, _addr(out), out.nbytes,
            round, timeout_ms), round, timeout_ms)
        return out.tobytes()

    def engine_load(self, tid: int) -> int:
        """The bytes of the keys assigned to engine thread ``tid`` (the
        reference's engine_load, which balances keys over threads)."""
        return int(self._call(self._lib.bps_server_engine_load, tid))

    def queue_depth(self) -> int:
        """Enqueued-but-unsummed pushes across the engine's threads: the
        shard's backlog. The JAX package sums ``engine_load`` here, the
        assigned bytes, which never fall back once a key is declared; a
        backlog gauge that never reads 0 would hold the auto controller
        wire-bound for good."""
        return sum(int(self._call(self._lib.bps_server_engine_backlog, t))
                   for t in range(self.engine_threads))


class HostPSBackend:
    """Worker-side driver over in-process ``PSServer`` shards.

    Keys are placed on shards by hash (reference: global.cc:628-677). The
    in-process shards model the colocated-server deployment (reference:
    BYTEPS_ENABLE_IPC); at world 1 it is the whole server side, and more
    workers share standalone servers instead (``server/transport.py``).
    """

    def __init__(self, num_servers: int = 1, num_workers: int = 1,
                 engine_threads: int = 4, enable_schedule: bool = False,
                 async_mode: bool = False) -> None:
        self.servers = [PSServer(num_workers, engine_threads, enable_schedule,
                                 async_mode)
                        for _ in range(num_servers)]
        self.num_workers = num_workers
        self.async_mode = async_mode
        self._rounds: Dict[int, int] = {}   # push_pull's rounds, per key
        # homogeneous fused summation (server/homog.py): keys declared
        # fused=True at init have their rounds owned by this store; lazy,
        # so plain deployments never allocate it
        self._homog = None
        # the engine-side fused pulls' cache, made at the first such pull
        self._fused_cache = None
        self._rs_cols: Dict[int, int] = {}   # row-sparse: pinned cols a key
        from .compressed import CompressedKeyStore
        self.compressed = CompressedKeyStore()
        self._declared: set = set()
        self._shard_bytes: Dict[int, int] = {}
        # key -> (nbytes, dtype) of its first declaration: the lag store
        # sizes a key from it
        self._key_meta: Dict[int, tuple] = {}
        # the bounded-staleness round store (server/admission.StaleStore),
        # made at the first declare_lag: K=1 never allocates it
        self._stale = None
        reg = get_registry()
        self._m_pull_wait = reg.histogram("server/pull_wait_s")
        self._m_dense_decodes = reg.counter("server/fused_dense_decodes")
        self._m_rowsparse = reg.counter("server/rowsparse_pushes")
        # the server's backlog, which the auto controller reads
        self._m_queue_depth = reg.gauge("server/engine_queue_depth")
        self._qd_next_sample = 0.0
        # the sharded update's param mailbox, made at first use
        self._param_store = None
        self._param_lock = threading.Lock()

    def close(self) -> None:
        for s in self.servers:
            s.close()

    def _shard_index(self, key: int) -> int:
        return place_key(key, len(self.servers))

    def _shard(self, key: int) -> PSServer:
        return self.servers[self._shard_index(key)]

    def _homog_managed(self, key: int) -> bool:
        return self._homog is not None and self._homog.managed(key)

    def init_key(self, key: int, nbytes: int, dtype: str = "float32",
                 init: Optional[np.ndarray] = None,
                 compression: Optional[Dict[str, str]] = None,
                 fused: bool = False) -> None:
        """Declare ``key``'s dense store. ``compression`` kwargs register
        the key's server chain (reference: server.cc:222-252): its pushes
        arrive compressed and are decompressed into that store.
        ``fused=True`` (the exchange's plan-time declaration for
        compression-plane-managed keys) hands the key's rounds to the
        homogeneous fused store when ``homog_enabled()``; a re-init resets
        it (a new tenancy) and, either way, drops the key's cached fused
        pulls. A key is one or the other: the two codecs' payloads
        differ."""
        from .homog import FusedSumStore, homog_enabled
        if compression and fused:
            raise ValueError(
                f"key {key}: declared both with compression kwargs (a legacy "
                f"chain) and fused=True (the fused plane)")
        if compression:
            self.compressed.register(
                key, compression, nbytes // np.dtype(dtype).itemsize, dtype)
        if fused and homog_enabled():
            if self._homog is None:
                self._homog = FusedSumStore(self.num_workers)
            self._homog.init_key(key, nbytes, dtype, init)
        elif self._homog_managed(key):
            self._homog.drop(key)           # re-declared non-fused
        # a re-init may restart the key's rounds: cached pulls of the
        # previous tenancy would alias the recurring round numbers
        if self._fused_cache is not None:
            self._fused_cache.drop(key)
        self._shard(key).init_key(key, nbytes, dtype, init)
        self._key_meta.setdefault(key, (int(nbytes), dtype))
        if key not in self._declared:       # re-inits are no-ops server-side
            self._declared.add(key)
            log_key_placement(key, nbytes, self._shard_index(key),
                              self._shard_bytes)

    def push(self, key: int, data: np.ndarray) -> None:
        if self._homog_managed(key):
            # a dense round of a fused-managed key: the homog store owns
            # the key's rounds either way
            self._homog.ingest_dense(key, data)
        else:
            self._shard(key).push(key, data)
        self._sample_queue_depth()

    def _sample_queue_depth(self) -> None:
        """Set ``server/engine_queue_depth`` from a dense push, at most
        once in 0.05 s: a sample is a locked call per engine thread and
        shard, too dear for every push
        (``byteps_tpu/server/engine.py:560-572``)."""
        if not metrics_enabled():
            return
        now = time.time()
        if now < self._qd_next_sample:
            return
        self._qd_next_sample = now + 0.05
        try:
            self._m_queue_depth.set(self.queue_depth())
        except ServerClosed:    # the push landed; a sample racing close()
            pass                # must not fail it

    def queue_depth(self) -> int:
        """Enqueued-but-unsummed pushes across every shard's engine, plus
        the fused store's buffered arrivals: the backlog signal must keep
        seeing fused-managed keys, whose rounds never reach the engine."""
        n = sum(s.queue_depth() for s in self.servers)
        if self._homog is not None:
            n += self._homog.pending()
        return n

    def pull(self, key: int, out: np.ndarray, round: int = 0,
             timeout_ms: int = 30000) -> None:
        t0 = time.time()
        if self._homog_managed(key):
            self._homog.pull_dense(key, out, round, timeout_ms)
        else:
            self._shard(key).pull(key, out, round, timeout_ms)
        # the merge's publish time from this worker's view: server sum
        # time plus the wait for the other workers' pushes
        self._m_pull_wait.observe(time.time() - t0)

    def push_pull(self, key: int, data: np.ndarray,
                  timeout_ms: int = 30000) -> np.ndarray:
        """One round from this worker's view: push, then pull the round
        this push completes (a per-key round counter), or in async mode
        the store as it is (round 0; reference ``:868-876``)."""
        self.push(key, data)
        rnd = self._rounds.get(key, 0) + 1
        self._rounds[key] = rnd
        out = np.empty_like(data)
        self.pull(key, out, 0 if self.async_mode else rnd, timeout_ms)
        return out

    def round(self, key: int) -> int:
        """Latest completed sync round for ``key`` (0 = none yet); a
        lag-managed key's last published round; in async mode the pushes
        folded so far."""
        if self._stale is not None and self._stale.managed(key):
            return self._stale.round(key)
        if self._homog_managed(key):
            return self._homog.round(key)
        return self._shard(key).round(key)

    def declare_lag(self, key: int, max_lag: int) -> None:
        """Hand ``key``'s rounds to the bounded-staleness store with bound
        ``max_lag`` (idempotent; a conflicting K raises). The key must be
        declared first: the store takes its size and dtype from that."""
        meta = self._key_meta.get(key)
        if meta is None:
            raise KeyError(f"declare_lag({key}) before init_key")
        nbytes, dtype = meta
        if self._stale is None:
            with self._param_lock:
                if self._stale is None:
                    from .admission import StaleStore
                    self._stale = StaleStore(self.num_workers)
        self._stale.declare(key, nbytes // np.dtype(dtype).itemsize, dtype,
                            max_lag)

    def push_lag(self, key: int, worker: int, rnd: int,
                 data: np.ndarray) -> None:
        """A versioned push: ``worker``'s round-``rnd`` gradient folds into
        that round, or into the open round when ``rnd`` was sealed."""
        self._stale.push(key, worker, rnd, data)

    def pull_lag(self, key: int, worker: int, rnd: int, out: np.ndarray,
                 timeout_ms: int = 30000) -> int:
        """A versioned pull; returns the verdict flags
        (``admission.LAG_COMPLETE`` / ``LAG_STALE`` / ``LAG_BARRIER``)."""
        t0 = time.time()
        flags = self._stale.pull(key, worker, rnd, out, timeout_ms)
        self._m_pull_wait.observe(time.time() - t0)
        return flags

    def push_bytes(self, key: int, payload) -> None:
        """A legacy chain's push: decompressed into the key's summation
        (reference: decompress before SUM_RECV, server.cc:86-113)."""
        from .compressed import compressed_push
        compressed_push(self.compressed, self._shard(key), key, payload)

    def param_store(self):
        if self._param_store is None:
            with self._param_lock:
                if self._param_store is None:
                    from ..sharded_update import ParamStore
                    self._param_store = ParamStore()
        return self._param_store

    def param_put(self, key: int, seq: int, payload) -> None:
        """Publish a sharded-update param frame (last-wins per (key,
        seq))."""
        self.param_store().put(key, seq, payload)

    def param_get(self, key: int, seq: int,
                  timeout_ms: int = 30000) -> bytes:
        """The (key, seq) param frame, waiting for it; not consumed."""
        return self.param_store().get(key, seq, timeout_ms=timeout_ms)

    def param_latest(self, key: int) -> int:
        """The newest retained param seq of ``key`` (0: none)."""
        return self.param_store().latest(key)

    def pull_bytes(self, key: int, round: int = 0,
                   timeout_ms: int = 30000) -> bytes:
        """A legacy chain's pull: the merged round recompressed once, the
        same bytes to every worker."""
        from .compressed import compressed_pull
        t0 = time.time()
        out = compressed_pull(self.compressed, self._shard(key), key, round,
                              timeout_ms)
        self._m_pull_wait.observe(time.time() - t0)
        return out

    def _no_chain(self, key: int) -> None:
        if self.compressed.has(key):
            raise KeyError(f"key {key} carries a legacy compression chain: "
                           f"its payloads go through push_bytes/pull_bytes, "
                           f"never the fused plane")

    def push_fused(self, key: int, payload) -> None:
        """Fused-plane push: the payload is self-describing (codec header).
        A key the homogeneous store owns buffers it there; any other is
        decoded into the engine's dense sum (the lossy decodes counted). A
        torn or mismatched payload raises ``wire.CodecError`` before any
        byte reaches either store."""
        from ..compress import wire
        self._no_chain(key)
        if self._homog_managed(key):
            self._homog.ingest(key, payload)
            return
        dense = wire.decode_for_store(payload, self._key_meta.get(key))
        if wire.lossy(wire.peek(payload)[0]):   # a `none` frame is a view
            self._m_dense_decodes.inc()         # of its bytes, not a decode
        self.push(key, dense)

    def pull_fused(self, key: int, nbytes: int, dtype: str, codec: int,
                   round: int = 0, timeout_ms: int = 30000,
                   div: Optional[int] = None) -> bytes:
        """Fused-plane pull: the merged round encoded at the codec the
        caller's decision trace pinned for it. Every codec is deterministic,
        so every puller of (round, codec, div) gets the same bytes, from the
        homogeneous store's merged round or the engine's."""
        from ..compress import wire
        self._no_chain(key)
        if self._homog_managed(key):
            return self._homog.pull_payload(
                key, codec, round, timeout_ms, div=div or wire.TOPK_DIV)
        if self._fused_cache is None:
            self._fused_cache = wire.FusedPullCache()
        return wire.pull_encoded(self, self._fused_cache, key, nbytes, dtype,
                                 codec, round, timeout_ms=timeout_ms,
                                 div=div or wire.TOPK_DIV)

    def push_rowsparse(self, key: int, idx, rows, dense_nbytes: int,
                       dtype=None) -> None:
        """Row-sparse push: the touched rows scattered into a dense table on
        the key's shard, which the engine sums (``server/rowsparse.py``).
        ``dtype`` defaults to the rows' own."""
        from .rowsparse import rowsparse_push
        rowsparse_push(self._shard(key), key, idx, rows, dense_nbytes,
                       dtype, meta=self._rs_cols)
        self._m_rowsparse.inc()
