"""Sync PS data path: gradients on the GPU ↔ the host reduction service (the
port's copy of ``PSGradientExchange`` in ``byteps_tpu/server/ps_mode.py``,
its ``exchange()``).

Each worker's gradients are cut into buckets (``plan_buckets``, last-
declared leaves first), each bucket a PS key ``declared_key << 16 |
bucket``. A bucket is packed and pushed, summed by the server across
workers, and pulled back: the reference's push/pull pipeline
(core_loops.cc:538-618). With the fused compression plane on
(``BPS_COMPRESS=int8`` or ``fp8_e4m3``, ...), a bucket is encoded before
the push, on the card where its gradients live (``compress/device.py``:
only the encoded payload is copied to the host), or by the numpy codec on
the host; the server merges same-codec payloads and serves the merged
round re-encoded, which the worker decodes on the host.

A declaration with legacy ``compression=`` kwargs (``compressor_type``
onebit, topk, randomk or dithering, with ``ef_type`` / ``momentum_type``)
gives each of its buckets at or above ``min_compress_bytes`` a worker chain
(``ops/compression/host.py``: momentum → ef → compressor): the bucket is
copied to the host dense, compressed there and pushed; the server
decompresses every push, sums, and recompresses the merged round once
(``server/compressed.py``); the pull is decompressed on the host. That is
the reference's design, its compressor running on the worker's CPU staging
buffer (core_loops.cc:498-536, server.cc:86-113), and the JAX package's: a
host path by definition, not a fallback from a kernel. Such buckets stay
out of the fused plane, which keeps the legacy keys' precedence.

The exchange is PIPELINED per bucket (``BPS_PS_PIPELINE`` threads, default
4; ≤ 1 = serial): bucket k+1's encode and push run while bucket k's pull
waits for the server's merge, and landed buckets are pulled by next-step
first-use priority. A per-key admission gate keeps one round per key in
flight (K rounds under bounded staleness).

Bounded staleness (``BPS_MAX_LAG=K`` > 1,
``byteps_tpu/server/ps_mode.py:704-713, 910-917, 1060-1076``): the backend
must have ``declare_lag`` / ``push_lag`` / ``pull_lag`` (checked at
construction). At plan time every dense key is declared with bound K; a
key with a legacy chain or an active compression-plane key stays at K=1,
because its codec assumes complete sums. The lag keys' pushes and pulls
carry (worker id, round) on every route (the one-shot exchange, the
ingest rounds of the staged head, the streamed tail); a pull's verdict is
counted (``ps/lag_complete``, ``ps/lag_stale``, ``ps/lag_barrier``) and a
stale or barrier verdict is a ``lag_admit`` flight event of this worker.

Every wire push and pull is a flight-recorder event (``obs/flight.py``),
and a failed pull dumps its key's events. ``BPS_WATCHDOG_SEC`` > 0 starts a
``StallWatchdog`` (``obs/watchdog.py``) with the first exchange: when
buckets are in flight and none has completed for that long, it logs which
key wedged, from ``debug_state()``, with the flight events of the keys it
implicates.

Besides the all-at-once ``exchange``, two round forms serve the trainer's
default PS step (``byteps_tpu/server/ps_mode.py:54-158``):
``exchange_stream`` yields each leaf the moment its last covering bucket's
pull unpacks (``ready()``), so the trainer's H2D copies and per-group
optimizer applies run while later buckets are still on the wire; and
``exchange_ingest`` takes its leaves as the backward produces them
(``feed``), pushing each bucket the moment its last leaf arrives. A fed
leaf carries the CUDA event recorded where autograd produced it: the
bucket's device encode or D2H copy then runs on the push thread's own
side stream, which waits on those events, and the round holds the fed
tensors until that stream was synchronized, so neither a half-written
gradient nor a reused block is ever read. ``leaf_groups`` partitions the
leaves by the bucket whose pull completes them: the granularity of the
chunked apply.

Both round forms take ``sharded=``, a round view of the sharded weight
update (``sharded_update.py``): every bucket is still pushed, but only
the buckets covering this replica's owned groups are pulled, and only the
owned leaves stream. A bucket that is not pulled goes ``pending ->
await_param -> param_done``: its admission key stays held until the
owners' param frames for every group it covers have landed
(``release_skipped``), which also commits its error-feedback residual, as
a pull would.

``AsyncPSWorker`` is the async PS path (``BPS_ENABLE_ASYNC``): no
gradient exchange, but each worker's weight delta folded into an async
store, whose weights it pulls back.

``RowSparseExchange`` is the sync row-sparse exchange behind
``bps.push_pull_rowsparse`` (``byteps_tpu/server/ps_mode.py:1509-1552``):
each worker pushes the touched (index, row) pairs of a table, a key a
table, and pulls the dense merged table of its round.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import bf16
from ..common.logging import get_logger
from ..common.naming import NameRegistry
from ..common.partition import LeafSpec, plan_buckets
from ..obs import flight
from ..obs.metrics import get_registry, observe_stage
from .admission import LAG_BARRIER, LAG_STALE, AdmissionPlane
from .engine import pack_segments, unpack_segments

def _dtype_name(t) -> str:
    return (str(t.dtype).removeprefix("torch.") if torch.is_tensor(t)
            else str(np.dtype(t.dtype)))


def _host_flat(src) -> np.ndarray:
    """A leaf as a flat contiguous host array: a CUDA tensor is copied to
    the host, a CPU tensor or numpy array is viewed."""
    if torch.is_tensor(src):
        return src.detach().contiguous().reshape(-1).cpu().numpy()
    return np.ascontiguousarray(src).reshape(-1)


class _PendingExchange:
    """Handle returned by ``PSGradientExchange.exchange_async``: the
    pushes are already in flight; ``result()`` drains the pulls."""

    __slots__ = ("_drain",)

    def __init__(self, drain) -> None:
        self._drain = drain

    def result(self) -> List[np.ndarray]:
        return self._drain()


class _StreamingExchange:
    """Handle returned by ``PSGradientExchange.exchange_stream``: the
    pushes are in flight and ``ready()`` yields ``(leaf_index, flat host
    array)`` in COMPLETION order, each the moment its last covering
    bucket's pull unpacked. A failed push or pull surfaces as an
    exception from the iterator (and from ``result()``)."""

    __slots__ = ("_r",)

    def __init__(self, round_: "_Round") -> None:
        self._r = round_

    @property
    def round_state(self) -> "_Round":
        return self._r

    def ready(self, timeout: Optional[float] = None):
        """Iterate (leaf_index, flat host array) as leaves complete;
        ``timeout`` bounds each wait (TimeoutError)."""
        return self._r.ready_iter(timeout)

    def result(self) -> List[np.ndarray]:
        """Drain every pull and return the summed leaves."""
        return self._r.drain()


class _IngestExchange(_StreamingExchange):
    """Handle returned by ``PSGradientExchange.exchange_ingest``: the
    ingress mirror of ``exchange_stream``. The caller ``feed``s leaves as
    they materialize; every bucket's encode or D2H and push is submitted
    the moment its last covering leaf arrives. ``ready()`` / ``result()``
    stream as for ``exchange_stream``. ``finish()`` asserts every leaf was
    fed; ``abort(exc)`` wakes a consumer when the producer died."""

    __slots__ = ()

    def feed(self, leaf_ids, values, events=None) -> None:
        """Hand over tensors (or host arrays) for ``leaf_ids`` (flat
        indices); ``events``: the CUDA event recorded where each was
        produced, or None. Thread-safe (autograd's device thread feeds)."""
        self._r.feed(leaf_ids, values, events)

    def finish(self) -> None:
        """Declare feeding complete; raises if any leaf is missing."""
        self._r.finish_feed()

    def abort(self, exc: BaseException) -> None:
        """Producer-side failure: wake ``ready()``/``result()`` with
        ``exc``."""
        self._r.abort(exc)


class _Round:
    """One sync exchange round: host leaves materialized lazily under
    per-leaf locks, bucket pack/encode + push, pull + decode + unpack;
    with ``stream`` the leaf-completion queue, with ``ingest`` leaves fed
    as they materialize (``byteps_tpu/server/ps_mode.py:134-611``)."""

    def __init__(self, ex: "PSGradientExchange",
                 tree: Sequence[Tuple[str, object]],
                 name: Optional[str], stream: bool = False,
                 ingest: bool = False, step: Optional[int] = None,
                 host_alloc=None, sharded=None) -> None:
        self.ex = ex
        # a sharded round pulls only the owned groups' buckets; the rest
        # wait in "await_param" for the owners' frames (None: every
        # bucket is pulled)
        self.sharded = sharded
        self.step_tag = step
        self.decl_name, self.keyed = ex._plan(tree, name)
        sources = [t for _, t in tree]
        # the decision trace, PINNED per round: the push and the pull of
        # every bucket in this round use this snapshot (two rounds in
        # flight under the cross-step driver each carry their own)
        self.clevels = None
        if ex._cplane is not None:
            ex._cplane.on_round()
            self.clevels = [ex._cplane.level_of(pskey)
                            for pskey, _ in self.keyed]
        # device encode: buckets whose pinned level has a device codec
        # encode where their gradients live and copy only the payload to
        # the host; leaves that some host bucket covers are copied dense
        self.dev_bucket = None
        self.host_leaves = None
        if self.clevels is not None and ex._device_encode_on(sources):
            from ..compress.device import DEVICE_CODECS
            dev = [lvl in DEVICE_CODECS and ex._cplane.active(pskey)
                   and pskey not in ex._chains
                   for (pskey, _), lvl in zip(self.keyed, self.clevels)]
            if any(dev):
                self.dev_bucket = dev
                self.host_leaves = {s.leaf_index
                                    for d, (_, b) in zip(dev, self.keyed)
                                    if not d for s in b.segments}
                sources = [torch.from_numpy(np.ascontiguousarray(s))
                           if isinstance(s, np.ndarray) else s
                           for s in sources]
        self.shapes = [tuple(s.shape) for s in sources]
        self.dtypes = [_dtype_name(s) for s in sources]
        self.device = next((s.device for s in sources if torch.is_tensor(s)),
                           torch.device("cpu"))
        # ingest rounds get their sources fed later: the template (the
        # parameters) supplies only shapes and dtypes
        self.sources: List = [None] * len(sources) if ingest else sources
        # per leaf: the CUDA event its producer recorded (fed leaves)
        self.events: List = [None] * len(sources)
        self.flat: List[Optional[np.ndarray]] = [None] * len(sources)
        self.flat_locks = [threading.Lock() for _ in sources]
        alloc = host_alloc or (lambda n, dt: np.empty(n, dt))
        # a sharded round's leaves that never stream get a plain buffer:
        # no tail copies them, so none would go back to a staging pool
        self.out = [(alloc if sharded is None or li in sharded.stream_leaves
                     else np.empty)(int(np.prod(shp)), np.dtype(dt))
                    for li, (shp, dt) in enumerate(zip(self.shapes,
                                                       self.dtypes))]
        self.rounds: List[Optional[int]] = [None] * len(self.keyed)
        # pull order: among landed buckets, the one holding the
        # earliest-declared (input-side) leaves first
        self.pull_prio = [min((s.leaf_index for s in b.segments), default=0)
                          for _, b in self.keyed]
        self.round_seq = ex.plane.pulls.next_round_seq()
        self.skip_buckets = frozenset(
            () if sharded is None else
            (i for i in range(len(self.keyed))
             if i not in sharded.pull_buckets))
        self._pulls_left = len(self.keyed) - len(self.skip_buckets)
        self._skips_left = len(self.skip_buckets)
        self._skip_lock = threading.Lock()
        # skipped buckets whose release came before their own push's
        # bookkeeping finished (an owner may publish as soon as every
        # worker's push reached the server)
        self._skip_release_pending: set = set()
        self._pull_lock = threading.Lock()
        self._pull_err: Optional[BaseException] = None
        self._pull_done = threading.Event()
        self.aborted: Optional[BaseException] = None
        # each bucket's life for the watchdog's dump: pending -> pushed ->
        # pulled (or failed), and pending -> await_param -> param_done for
        # a sharded round's skipped buckets; "pushed" or "await_param"
        # forever is a wedge
        self.bucket_state = ["pending"] * len(self.keyed)
        self._finished = False
        if not self.keyed:
            self._pull_done.set()
        else:
            ex._register_round(self)
            if self._pulls_left <= 0:
                self._pull_done.set()
        self.readyq: Optional[queue.Queue] = None
        self._stream_n = len(sources)
        if stream or ingest:
            self.readyq = queue.Queue()
            self.seg_left = [0] * len(sources)
            for _, b in self.keyed:
                for s in b.segments:
                    self.seg_left[s.leaf_index] += 1
            if sharded is not None:
                # only the owned leaves stream; the others complete by
                # param fetch, and a boundary bucket's partial sums of
                # them must never reach the consumer as a finished leaf
                for li in range(len(sources)):
                    if li not in sharded.stream_leaves:
                        self.seg_left[li] = -1
                self._stream_n = sum(1 for n in self.seg_left if n >= 0)
            self.seg_lock = threading.Lock()
            for li, n in enumerate(self.seg_left):
                if n == 0:          # zero-size leaf: no covering bucket
                    self.readyq.put((li, self.out[li]))
        self.ingest = ingest
        if ingest:
            # bucket -> distinct covering leaves; a bucket is pushable
            # once all of them were fed
            bucket_leaves = [sorted({s.leaf_index for s in b.segments})
                             for _, b in self.keyed]
            self.bucket_need = [len(ls) for ls in bucket_leaves]
            self.leaf_buckets: Dict[int, List[int]] = {}
            for bi, ls in enumerate(bucket_leaves):
                for li in ls:
                    self.leaf_buckets.setdefault(li, []).append(bi)
            self.fed = [False] * len(sources)
            self.feed_lock = threading.Lock()
            self.feed_done = False

    # ------------------------------------------------------ host leaves

    def get_flat(self, i: int) -> np.ndarray:
        v = self.flat[i]         # double-checked: a ready leaf never waits
        if v is not None:
            return v
        with self.flat_locks[i]:
            if self.flat[i] is None:
                t0 = time.time()
                self.flat[i] = _host_flat(self.sources[i])
                observe_stage("PS_D2H", time.time() - t0)
            return self.flat[i]

    # ------------------------------------------------------ push / pull

    def push_one(self, idx: int) -> np.ndarray:
        _, b = self.keyed[idx]
        events = [self.events[s.leaf_index] for s in b.segments
                  if self.events[s.leaf_index] is not None]
        with self.ex._side_stream(events, self.device):
            return self._push_one(idx)

    def _push_one(self, idx: int) -> np.ndarray:
        ex = self.ex
        pskey, b = self.keyed[idx]
        self.rounds[idx] = ex._next_round(pskey)
        try:
            if self.dev_bucket is not None and self.dev_bucket[idx]:
                buf = ex._push_bucket_device(self, idx)
                self.bucket_state[idx] = "pushed"
                ex._mark_progress()
                return buf
            t0 = time.time()
            buf = np.empty(b.size, dtype=b.dtype)
            item = buf.itemsize
            pack_segments([self.get_flat(s.leaf_index).ctypes.data
                           + s.leaf_offset * item for s in b.segments],
                          [s.bucket_offset * item for s in b.segments],
                          [s.length * item for s in b.segments], buf)
            t0 = ex._record("PS_PACK", t0)
            # the bucket's segments crossed to the host dense
            ex._d2h_account(pskey, buf.nbytes)
            ex._push_bucket(pskey, buf, self, idx)
            ex._record("PS_PUSH", t0)
            self.bucket_state[idx] = "pushed"
            ex._mark_progress()
            return buf
        except Exception:
            # the round counter advanced but the push never landed: drop
            # the entry so a retried exchange re-seeds from the server's
            # round instead of pulling a round that never completes
            with ex._key_rounds_lock:
                ex._key_rounds.pop(pskey, None)
            raise

    def pull_one(self, idx: int, buf: np.ndarray) -> None:
        ex = self.ex
        pskey, b = self.keyed[idx]
        t0 = time.time()
        merged = np.ascontiguousarray(
            ex._pull_bucket(pskey, b, buf, self.rounds[idx], self, idx))
        t0 = ex._record("PS_PULL", t0)
        item = merged.itemsize
        unpack_segments(merged, [s.bucket_offset * item for s in b.segments],
                        [self.out[s.leaf_index].ctypes.data
                         + s.leaf_offset * item for s in b.segments],
                        [s.length * item for s in b.segments])
        ex._record("PS_UNPACK", t0)
        self.bucket_state[idx] = "pulled"
        ex._m_buckets.inc()
        ex._mark_progress()
        if self.readyq is not None:
            for s in b.segments:
                self._segment_done(s.leaf_index)

    def _segment_done(self, li: int) -> None:
        with self.seg_lock:
            if self.seg_left[li] < 0:    # sharded: a leaf that does not
                return                   # stream (its frame installs it)
            self.seg_left[li] -= 1
            done = self.seg_left[li] == 0
        if done:
            self.readyq.put((li, self.out[li]))

    def assemble(self) -> List[np.ndarray]:
        return [o.reshape(shp) for o, shp in zip(self.out, self.shapes)]

    # ------------------------------------------------------ pipelined

    def submit_bucket(self, idx: int) -> None:
        """Queue bucket ``idx``'s pack/encode + push once the admission
        gate frees its key; its pull is queued when the push lands."""
        ex = self.ex
        pskey, _ = self.keyed[idx]
        ex.plane.gate.admit(pskey, lambda: ex._push_ex.submit(
            self._push_task, idx))

    def _push_task(self, idx: int) -> None:
        pskey, _ = self.keyed[idx]
        skip = idx in self.skip_buckets
        try:
            buf = self.push_one(idx)
        except BaseException as e:   # noqa: BLE001 — relayed to drain()
            self.bucket_state[idx] = "failed"
            self.ex.plane.gate.release(pskey)
            if skip:
                self._skip_finished(e)
            else:
                self._pull_finished(e)
            return
        if not skip:
            self.ex._enqueue_pull(self, idx, buf)
            return
        # a sharded round's bucket that is not pulled: the admission key
        # stays held until the owners' frames of every group it covers
        # have landed; a release that came first completes here
        with self._skip_lock:
            self.bucket_state[idx] = "await_param"
            fire = idx in self._skip_release_pending
            self._skip_release_pending.discard(idx)
        if fire:
            self._finish_skip_release(idx)

    def release_skipped(self, idx: int) -> None:
        """The param frames of every group that bucket ``idx`` covers have
        landed (sharded update): release the bucket's admission key, so
        the next round's push may go, and commit the compression plane's
        pending residual: the frames prove the owner consumed this
        round's sum, the signal a pull gives an unsharded round."""
        if idx not in self.skip_buckets:
            raise ValueError(f"bucket {idx} is not a skipped bucket of "
                             f"this round")
        with self._skip_lock:
            if self.bucket_state[idx] == "param_done":
                return
            if self.bucket_state[idx] != "await_param":
                # the owner published before this worker's push
                # bookkeeping finished: the push task completes it
                self._skip_release_pending.add(idx)
                return
        self._finish_skip_release(idx)

    def _finish_skip_release(self, idx: int) -> None:
        ex = self.ex
        pskey, _ = self.keyed[idx]
        plane = ex._cplane
        if plane is not None and plane.active(pskey):
            plane.commit(pskey, self.rounds[idx])
        self.bucket_state[idx] = "param_done"
        ex._mark_progress()
        ex.plane.gate.release(pskey)
        self._skip_finished(None)

    def _skip_finished(self, exc: Optional[BaseException]) -> None:
        if exc is not None:
            if self._pull_err is None:
                self._pull_err = exc
            if self.readyq is not None:
                self.readyq.put(exc)
        with self._pull_lock:
            self._skips_left -= 1
            done = self._pulls_left <= 0 and self._skips_left <= 0
        if done:
            self._mark_finished()

    def _pull_finished(self, exc: Optional[BaseException]) -> None:
        if exc is not None:
            if self._pull_err is None:
                self._pull_err = exc
            if self.readyq is not None:
                self.readyq.put(exc)
        with self._pull_lock:
            self._pulls_left -= 1
            pulls_done = self._pulls_left <= 0
            done = pulls_done and self._skips_left <= 0
        if done:
            self._mark_finished()
        if pulls_done:
            self._pull_done.set()

    def _mark_finished(self) -> None:
        """Terminal accounting for ``ps/rounds_in_flight`` and the
        watchdog (idempotent)."""
        with self._pull_lock:
            if self._finished:
                return
            self._finished = True
        self.ex._m_rounds.dec()

    def drain(self) -> List[np.ndarray]:
        if self.aborted is not None:
            raise self.aborted
        if self.ingest:
            # an incompletely fed round never submits some buckets, so
            # waiting would hang: fail loudly instead
            with self.feed_lock:
                missing = sum(not f for f in self.fed)
            if missing:
                raise RuntimeError(
                    f"exchange_ingest result() with {missing} leaves never "
                    f"fed: call feed() for every leaf and finish() before "
                    f"draining")
        self._pull_done.wait()
        if self.aborted is not None:
            raise self.aborted
        if self._pull_err is not None:
            raise self._pull_err
        return self.assemble()

    def ready_iter(self, timeout: Optional[float] = None):
        for _ in range(self._stream_n):
            try:
                item = self.readyq.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no leaf of round {self.round_seq} completed within "
                    f"{timeout} s") from None
            if isinstance(item, BaseException):
                raise item
            yield item

    # ------------------------------------------------------ ingest

    def feed(self, leaf_ids, values, events=None) -> None:
        pairs = list(zip(leaf_ids, values,
                         events if events is not None
                         else [None] * len(leaf_ids)))
        for li, v, _ in pairs:
            # the bucket plan's offsets come from the template: a leaf of
            # another size would send the native pack out of bounds
            if (int(np.prod(tuple(v.shape))) != int(np.prod(self.shapes[li]))
                    or _dtype_name(v) != self.dtypes[li]):
                raise ValueError(
                    f"fed leaf {li} is {tuple(v.shape)}/{_dtype_name(v)}, "
                    f"the plan expects {self.shapes[li]}/{self.dtypes[li]}")
        self.ex._mark_progress()
        fire: List[int] = []
        with self.feed_lock:
            if self.feed_done:
                raise RuntimeError("feed() after finish()")
            for li, v, ev in pairs:
                if self.fed[li]:
                    raise ValueError(f"leaf {li} fed twice")
                self.fed[li] = True
                self.sources[li] = v
                self.events[li] = ev
                for bi in self.leaf_buckets.get(li, ()):
                    self.bucket_need[bi] -= 1
                    if self.bucket_need[bi] == 0:
                        fire.append(bi)
        for bi in fire:
            self.submit_bucket(bi)

    def finish_feed(self) -> None:
        with self.feed_lock:
            missing = [li for li, f in enumerate(self.fed) if not f]
            self.feed_done = True
        if missing:
            raise ValueError(
                f"exchange_ingest round finished with {len(missing)} leaves "
                f"never fed (first missing: {missing[:5]}): every flat leaf "
                f"must be handed over exactly once")

    def abort(self, exc: BaseException) -> None:
        self.aborted = exc
        if self.keyed:              # the in-flight gauge and the watchdog
            self._mark_finished()   # must not count a dead round forever
        self._pull_done.set()
        if self.readyq is not None:
            self.readyq.put(exc)


class PSGradientExchange:
    """Sync-mode bucketed gradient exchange through the host PS service.

    ``exchange(tree, name)`` takes the gradients as ``(path, tensor)``
    pairs in the JAX parameter tree's flatten order (so the buckets, keys,
    scales and fp8 noise are the JAX package's) and returns the summed
    leaves as host arrays in the same order and shapes.

    ``device``: where the gradients will live; when given (the trainer
    gives its own), the device encode is resolved and probed at
    construction rather than at the first exchange.
    """

    def __init__(self, backend, partition_bytes: int = 4 << 20,
                 registry: Optional[NameRegistry] = None,
                 min_compress_bytes: int = 65536,
                 pipeline_depth: Optional[int] = None,
                 watchdog_sec: Optional[float] = None,
                 compress: Optional[str] = None,
                 max_lag: Optional[int] = None,
                 worker_id: Optional[int] = None,
                 device=None) -> None:
        self.backend = backend
        self.partition_bytes = partition_bytes
        self.registry = registry or NameRegistry()
        self.min_compress_bytes = min_compress_bytes
        from ..compress.plane import CompressionPlane
        self._cplane = CompressionPlane.from_config(
            compress, min_bytes=min_compress_bytes)
        if self._cplane is not None and not hasattr(backend, "push_fused"):
            raise ValueError(
                f"BPS_COMPRESS={self._cplane.mode!r} needs a backend with "
                f"push_fused/pull_fused; {type(backend).__name__} has neither")
        self.pipeline_depth = (int(os.environ.get("BPS_PS_PIPELINE", "4"))
                               if pipeline_depth is None else pipeline_depth)
        # the push gate's depth is K; K > 1 routes the dense rounds
        # through the server's bounded-staleness store
        self.plane = AdmissionPlane(max_lag=max_lag, worker_id=worker_id)
        if self.plane.max_lag > 1 and not hasattr(backend, "push_lag"):
            # a backend without the versioned rounds would train at K=1
            # while the worker runs ahead
            raise ValueError(
                f"BPS_MAX_LAG={self.plane.max_lag} needs a backend with "
                f"declare_lag/push_lag/pull_lag; {type(backend).__name__} "
                f"has none")
        self._plans: Dict = {}
        self._plan_lock = threading.Lock()
        self._pull_layer: Dict[int, object] = {}
        self._d2h_layer: Dict[int, object] = {}
        self._key_rounds: Dict[int, int] = {}
        self._key_rounds_lock = threading.Lock()
        self._push_ex: Optional[ThreadPoolExecutor] = None
        self._pull_ex: Optional[ThreadPoolExecutor] = None
        self._ex_lock = threading.Lock()
        reg = get_registry()
        self._m_push_bytes = reg.counter("ps/push_bytes")
        self._m_pull_bytes = reg.counter("ps/pull_bytes")
        self._m_d2h_bytes = reg.counter("ps/d2h_bytes")
        self._m_buckets = reg.counter("ps/buckets_completed")
        self._m_rounds = reg.gauge("ps/rounds_in_flight")
        # the server's verdicts on this worker's lag pulls
        self._m_lag = {f: reg.counter(f"ps/lag_{n}") for f, n in
                       ((0, "complete"), (LAG_STALE, "stale"),
                        (LAG_BARRIER, "barrier"))}
        # per-PS-key worker chain (momentum → ef → compressor): it holds
        # the error feedback and momentum state, so it outlives the plan
        # (reference: the per-partition compressor_list, common.h:202)
        self._chains: Dict[int, object] = {}
        # the watchdog's clock, monotonic: a wall-clock step must neither
        # fake a stall nor hide one
        self._progress_t = time.monotonic()
        self._live_rounds: List = []      # weakrefs, pruned on register
        self._rounds_reg_lock = threading.Lock()
        self._watchdog = None
        # the explicit argument (Config.watchdog_sec, from bps.init and the
        # trainer) wins; the env covers exchanges built by hand
        self._watchdog_sec = (float(watchdog_sec) if watchdog_sec is not None
                              else float(os.environ.get("BPS_WATCHDOG_SEC",
                                                        "0") or 0))
        self._dev_enc: Optional[bool] = None
        if device is not None and self._cplane is not None:
            from ..compress.device import device_encode_enabled
            self._dev_enc = device_encode_enabled(device)
        # each push thread's own side stream (fed rounds, on the card)
        self._tls = threading.local()
        self._close_hooks: List = []

    def add_close_hook(self, fn) -> None:
        """``fn()`` runs first in ``close()``: a trainer joins the tails
        that still pull through this exchange (held weakly by the caller,
        so the exchange keeps no trainer alive)."""
        self._close_hooks.append(fn)

    def close(self) -> None:
        """Stop the pipeline's threads and the watchdog (idempotent)."""
        hooks, self._close_hooks = self._close_hooks, []
        for fn in hooks:
            fn()
        with self._rounds_reg_lock:
            wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()
        with self._ex_lock:
            for ex in (self._push_ex, self._pull_ex):
                if ex is not None:
                    ex.shutdown(wait=False)
            self._push_ex = self._pull_ex = None

    # ---------------------------------------------------- observability

    def _mark_progress(self) -> None:
        """A bucket advanced (push landed, pull completed): re-arm the
        watchdog's clock."""
        self._progress_t = time.monotonic()

    def _register_round(self, rnd: _Round) -> None:
        with self._rounds_reg_lock:
            alive = []
            for ref in self._live_rounds:
                r = ref()
                if r is not None and not r._finished:
                    alive.append(ref)
            alive.append(weakref.ref(rnd))
            self._live_rounds = alive
        self._m_rounds.inc()

    def _live(self) -> List[_Round]:
        with self._rounds_reg_lock:
            live = [ref() for ref in self._live_rounds]
        return [r for r in live if r is not None and not r._finished]

    def in_flight_buckets(self) -> int:
        """Buckets of live rounds whose pull has not completed, and those
        of a sharded round still waiting for their owners' frames (their
        admission keys are held: a dead owner's wedge is in flight)."""
        return sum(max(0, r._pulls_left) + max(0, r._skips_left)
                   for r in self._live())

    def progress_state(self):
        """(last progress on the monotonic clock, buckets in flight): the
        watchdog's poll."""
        return self._progress_t, self.in_flight_buckets()

    def debug_state(self) -> dict:
        """Every unfinished round's buckets (PS key, round, pending /
        pushed / pulled / failed, or await_param / param_done with the
        owner ranks whose frames a skipped bucket waits for) and the
        admission gate's holders and queued waiters: what the watchdog
        dumps."""
        rounds = []
        for r in self._live():
            buckets = []
            for i, (pskey, _) in enumerate(r.keyed):
                b = {"pskey": pskey, "round": r.rounds[i],
                     "state": r.bucket_state[i]}
                if r.sharded is not None and i in r.skip_buckets:
                    # every owner a frame must come from (a boundary
                    # bucket may wait on two), so a dead owner's wedge is
                    # attributable from the dump
                    owners = r.sharded.skip_owner.get(i, ())
                    b["owner"] = (owners[0] if len(owners) == 1
                                  else list(owners))
                buckets.append(b)
            rounds.append({"name": r.decl_name, "step": r.step_tag,
                           "seq": r.round_seq, "pulls_left": r._pulls_left,
                           "skips_left": r._skips_left,
                           "buckets": buckets})
        return {"in_flight": self.in_flight_buckets(), "rounds": rounds,
                "admission": self.plane.gate.state()}

    def _ensure_watchdog(self) -> None:
        if self._watchdog is not None or self._watchdog_sec <= 0:
            return
        from ..obs.watchdog import StallWatchdog
        # two first exchanges at once must not start two watchdogs
        with self._rounds_reg_lock:
            if self._watchdog is None:
                self._watchdog = StallWatchdog(self, self._watchdog_sec)

    def n_compressed(self) -> int:
        """How many buckets of the planned trees the plane compresses."""
        return 0 if self._cplane is None else self._cplane.n_active

    def n_chained(self) -> int:
        """How many buckets of the planned trees a legacy chain compresses."""
        return len(self._chains)

    # ------------------------------------------------------------ plan

    def _plan(self, tree, name: Optional[str]):
        sig = (name, tuple((p, tuple(t.shape), _dtype_name(t))
                           for p, t in tree))
        plan = self._plans.get(sig)
        if plan is not None:
            return plan
        with self._plan_lock:   # exchanges may start on several threads
            plan = self._plans.get(sig)
            if plan is None:
                plan = self._plans[sig] = self._new_plan(tree, name)
            return plan

    def _new_plan(self, tree, name: Optional[str]):
        # distinct trees land on distinct PS keys: anonymous trees get
        # position-stable names, keys follow declaration order
        decl_name = name or f"grads{len(self._plans)}"
        decl = self.registry.declare(decl_name)
        specs = [LeafSpec(name=p, size=int(np.prod(t.shape)),
                          dtype=_dtype_name(t)) for p, t in tree]
        buckets = plan_buckets(specs, self.partition_bytes,
                               reverse_order=True)
        # per-bucket PS keys: declared_key << 16 | bucket (reference:
        # operations.cc:301-317)
        keyed = [(decl.key_for_partition(b.index), b) for b in buckets]
        reg = get_registry()
        ckw = decl.compression_kwargs
        for pskey, b in keyed:
            nbytes = b.size * np.dtype(b.dtype).itemsize
            self._pull_layer.setdefault(pskey, reg.counter(
                f"ps/pull_bytes/{decl_name}.{b.index}"))
            self._d2h_layer.setdefault(pskey, reg.counter(
                f"ps/d2h_bytes/{decl_name}.{b.index}"))
            # legacy kwargs chains first, for buckets at or above the floor
            # (reference: BYTEPS_MIN_COMPRESS_BYTES, operations.cc:362-364);
            # they stay out of the fused plane
            if ckw.get("compressor_type") and nbytes >= self.min_compress_bytes:
                from ..ops.compression.host import create_host_chain
                if pskey not in self._chains:
                    self._chains[pskey] = create_host_chain(ckw, b.size,
                                                            b.dtype)
                self.backend.init_key(pskey, nbytes, b.dtype,
                                      compression=ckw)
                continue
            # fused-plane eligibility is decided before the server learns
            # the key: fused-managed keys' rounds go to the homog store
            fused = (self._cplane is not None
                     and self._cplane.register(
                         pskey, b.size, b.dtype,
                         layer=f"{decl_name}.{b.index}"))
            self.backend.init_key(pskey, nbytes, b.dtype, fused=fused)
        if self.plane.max_lag > 1:
            # dense keys only: chains and plane keys keep their one-round
            # stores (byteps_tpu/server/ps_mode.py:910-917)
            for pskey, _ in keyed:
                if self._lag_routes(pskey):
                    self.backend.declare_lag(pskey, self.plane.max_lag)
        if hasattr(self.backend, "set_send_priority"):
            # the wire credit's order (a remote backend): the bucket
            # holding the earliest-declared leaves sends first, the order
            # the pull queue drains in (byteps_tpu/server/ps_mode.py:918-929)
            for pskey, b in keyed:
                first = min((s.leaf_index for s in b.segments), default=0)
                self.backend.set_send_priority(pskey, len(tree) - first)
        return decl_name, keyed

    def _record(self, stage: str, t0: float) -> float:
        now = time.time()
        observe_stage(stage, now - t0)
        return now

    def _next_round(self, pskey: int) -> int:
        """This push's round for ``pskey``, per key; the first use of a
        key seeds from the server's completed round (``backend.round``, a
        round trip on a remote backend), so a worker that joins a live job
        resumes at the job's round."""
        with self._key_rounds_lock:
            cur = self._key_rounds.get(pskey)
        if cur is None:
            cur = int(self.backend.round(pskey))
        with self._key_rounds_lock:
            nxt = self._key_rounds.get(pskey, cur) + 1
            self._key_rounds[pskey] = nxt
        return nxt

    def _lag_routes(self, pskey: int) -> bool:
        """Does ``pskey`` ride the bounded-staleness store? Only at K > 1,
        and only a dense key."""
        return (self.plane.max_lag > 1
                and pskey not in self._chains
                and (self._cplane is None
                     or not self._cplane.active(pskey)))

    def _lag_verdict(self, pskey: int, rnd_num: int, flags: int) -> None:
        """This worker's note of the server's verdict on a lag pull (the
        server records the decision)."""
        if flags & LAG_BARRIER:
            self._m_lag[LAG_BARRIER].inc()
        self._m_lag[flags & LAG_STALE].inc()
        if flags and flight.get_recorder().enabled:
            verdict = "barrier" if flags & LAG_BARRIER else "stale"
            flight.record("lag_admit",
                          detail=f"verdict={verdict} key={pskey} "
                                 f"round={rnd_num} (served)")

    def _device_encode_on(self, sources) -> bool:
        """Resolve (once) whether the plane encodes on the gradients'
        device: ``BPS_COMPRESS_DEVICE`` and the bitwise probe, which
        raises on a mismatch."""
        if self._dev_enc is None:
            from ..compress.device import device_encode_enabled
            dev = next((s.device for s in sources if torch.is_tensor(s)),
                       torch.device("cpu"))
            self._dev_enc = device_encode_enabled(dev)
        return self._dev_enc

    @contextlib.contextmanager
    def _side_stream(self, events, device):
        """Run a bucket's encode or D2H on this push thread's own CUDA
        stream, after the ``events`` its fed leaves were produced under
        (no events: the thread's current stream, as ``exchange`` runs).
        The work ends with a host synchronization of that stream (the
        amax and payload copies, or ``.cpu()``), before the round lets go
        of the leaves."""
        if not events:
            yield
            return
        streams = getattr(self._tls, "streams", None)
        if streams is None:
            streams = self._tls.streams = {}
        side = streams.get(device)
        if side is None:
            side = streams[device] = torch.cuda.Stream(device=device)
        for ev in events:
            side.wait_event(ev)
        with torch.cuda.stream(side):
            yield

    def _d2h_account(self, pskey: int, nbytes: int) -> None:
        self._m_d2h_bytes.inc(nbytes)
        self._d2h_layer[pskey].inc(nbytes)

    # ------------------------------------------------------ push / pull

    def _push_bucket_device(self, rnd: _Round, idx: int) -> np.ndarray:
        """Gather + EF fold + quantize on the device, copy only the
        encoded payload to the host, push it fused. Returns the pull
        staging buffer."""
        pskey, b = rnd.keyed[idx]
        parts = [(rnd.sources[s.leaf_index], s.leaf_offset, s.length)
                 for s in b.segments]
        t0 = time.time()
        payload, d2h = self._cplane.encode_on_device(
            pskey, parts, rnd.clevels[idx], rnd.rounds[idx])
        self._record("PS_COMPRESS_DEV", t0)
        # a leaf shared with a host bucket crosses to the host dense
        # anyway: its segments here saved nothing
        if rnd.host_leaves:
            item = np.dtype(b.dtype).itemsize
            d2h += sum(s.length * item for s in b.segments
                       if s.leaf_index in rnd.host_leaves)
        self._d2h_account(pskey, d2h)
        self._m_push_bytes.inc(len(payload))
        try:
            self.backend.push_fused(pskey, payload)
        except BaseException as e:
            flight.record("push", key=pskey, round=rnd.rounds[idx],
                          nbytes=len(payload), stage="PS_COMPRESS_DEV",
                          outcome=f"error:{type(e).__name__}")
            raise
        flight.record("push", key=pskey, round=rnd.rounds[idx],
                      nbytes=len(payload), stage="PS_COMPRESS_DEV")
        return np.empty(b.size, dtype=b.dtype)

    def _push_bucket(self, pskey: int, buf: np.ndarray, rnd: _Round,
                     idx: int) -> None:
        """Push one host bucket (compressed by its chain or the plane, or
        dense), with one flight event for it."""
        try:
            self._push_bucket_impl(pskey, buf, rnd, idx)
        except BaseException as e:
            flight.record("push", key=pskey, round=rnd.rounds[idx],
                          nbytes=buf.nbytes,
                          outcome=f"error:{type(e).__name__}")
            raise
        flight.record("push", key=pskey, round=rnd.rounds[idx],
                      nbytes=buf.nbytes)

    def _push_bucket_impl(self, pskey: int, buf: np.ndarray, rnd: _Round,
                          idx: int) -> None:
        chain = self._chains.get(pskey)
        if chain is not None:
            # the legacy COMPRESS stage right before PUSH (reference:
            # core_loops.cc:498-536); the server decompresses, sums and
            # recompresses the merged round
            t0 = time.time()
            payload = chain.compress(buf)
            self._record("PS_COMPRESS", t0)
            self._m_push_bytes.inc(len(payload))
            self.backend.push_bytes(pskey, payload)
            return
        plane = self._cplane
        if plane is not None and plane.active(pskey):
            level = rnd.clevels[idx]
            if level:
                # the fused encode on the push thread, the EF residual
                # folded in and the new one staged for commit-on-pull
                t0 = time.time()
                payload = plane.encode(pskey, buf, level, rnd.rounds[idx])
                self._record("PS_COMPRESS", t0)
                self._m_push_bytes.inc(len(payload))
                self.backend.push_fused(pskey, payload)
                return
            # a dense round of a plane-managed key: per-layer accounting,
            # and a residual left from a compressed level flushed once
            plane.note_dense_push(pskey, buf.nbytes)
            buf = plane.fold_residual(pskey, buf, rnd.rounds[idx])
        self._m_push_bytes.inc(buf.nbytes)
        if self._lag_routes(pskey):
            # a versioned push: the server folds it into its round, or
            # into the open round if that one sealed without it
            self.backend.push_lag(pskey, self.plane.worker_id,
                                  rnd.rounds[idx], buf)
            return
        self.backend.push(pskey, buf)

    def _pull_bucket(self, pskey: int, b, buf: np.ndarray, rnd_num: int,
                     rnd: _Round, idx: int) -> np.ndarray:
        """Pull one bucket, with one flight event for it; a refused decode
        dumps the key's recent events beside the error."""
        try:
            out = self._pull_bucket_impl(pskey, b, buf, rnd_num, rnd, idx)
        except BaseException as e:
            flight.record("pull", key=pskey, round=rnd_num,
                          outcome=f"error:{type(e).__name__}")
            from ..compress.wire import CodecError
            if isinstance(e, CodecError):
                flight.dump(get_logger(), keys=[pskey],
                            reason=f"CodecError on pull key={pskey} "
                                   f"round={rnd_num}: {e}")
            raise
        flight.record("pull", key=pskey, round=rnd_num, nbytes=buf.nbytes)
        return out

    def _pull_bucket_impl(self, pskey: int, b, buf: np.ndarray, rnd_num: int,
                          rnd: _Round, idx: int) -> np.ndarray:
        chain = self._chains.get(pskey)
        if chain is not None:
            payload = self.backend.pull_bytes(pskey, round=rnd_num)
            self._m_pull_bytes.inc(len(payload))
            self._pull_layer[pskey].inc(len(payload))
            t0 = time.time()
            merged = chain.decompress(payload).astype(b.dtype, copy=False)
            self._record("PS_DECOMPRESS", t0)
            return merged
        plane = self._cplane
        if plane is not None and plane.active(pskey) and rnd.clevels[idx]:
            nbytes = b.size * np.dtype(b.dtype).itemsize
            payload = self.backend.pull_fused(
                pskey, nbytes, str(b.dtype), rnd.clevels[idx],
                round=rnd_num, div=plane.topk_div)
            self._m_pull_bytes.inc(len(payload))
            self._pull_layer[pskey].inc(len(payload))
            # decode on the host; commits the round's EF residual
            t0 = time.time()
            merged = plane.decode(pskey, payload, rnd_num)
            self._record("PS_DECOMPRESS", t0)
            return merged
        if rnd_num and self._lag_routes(pskey):
            flags = self.backend.pull_lag(pskey, self.plane.worker_id,
                                          rnd_num, buf)
            self._lag_verdict(pskey, rnd_num, flags)
            self._m_pull_bytes.inc(buf.nbytes)
            self._pull_layer[pskey].inc(buf.nbytes)
            return buf
        self.backend.pull(pskey, buf, round=rnd_num)
        self._m_pull_bytes.inc(buf.nbytes)
        self._pull_layer[pskey].inc(buf.nbytes)
        if plane is not None:
            # a residual flush pinned to this round clears on its pull
            plane.commit(pskey, rnd_num)
        return buf

    def _enqueue_pull(self, rnd: _Round, idx: int, buf) -> None:
        self.plane.pulls.put(rnd.round_seq, rnd.pull_prio[idx],
                             (rnd, idx, buf))
        self._pull_ex.submit(self._pull_next)

    def _pull_next(self) -> None:
        """One pull slot: drain the highest-priority landed bucket (not
        necessarily the one whose push scheduled this slot)."""
        rnd, idx, buf = self.plane.pulls.pop()
        pskey, _ = rnd.keyed[idx]
        exc: Optional[BaseException] = None
        try:
            rnd.pull_one(idx, buf)
        except BaseException as e:   # noqa: BLE001 — relayed to drain()
            exc = e
            rnd.bucket_state[idx] = "failed"
            # the error surfaces at the caller's next drain, maybe seconds
            # from now: dump the key's events while the ring holds them
            flight.dump(get_logger(), keys=[pskey],
                        reason=f"pull failure key={pskey} "
                               f"round={rnd.rounds[idx]}: "
                               f"{type(e).__name__}: {e}")
        finally:
            self.plane.gate.release(pskey)
            rnd._pull_finished(exc)

    def _ensure_executors(self) -> None:
        with self._ex_lock:
            if self._push_ex is None:
                width = max(2, self.pipeline_depth)
                self._push_ex = ThreadPoolExecutor(
                    width, thread_name_prefix="bps-ps-push")
                self._pull_ex = ThreadPoolExecutor(
                    width, thread_name_prefix="bps-ps-pull")

    # -------------------------------------------------------- exchange

    def plan_for(self, tree: Sequence[Tuple[str, object]],
                 name: Optional[str] = None) -> None:
        """Declare ``tree``'s keys now. A caller that defers its exchange
        (an async handle) calls this at dispatch, so the keys follow the
        dispatch order on every worker whatever order its exchanges
        later run in (``byteps_tpu/server/ps_mode.py:934-940``)."""
        self._plan(list(tree), name)

    def leaf_groups(self, tree: Sequence[Tuple[str, object]],
                    name: Optional[str] = None) -> List[List[int]]:
        """Partition ``tree``'s flat leaf indices by the LAST bucket that
        covers each leaf, the bucket whose pull completes it
        (``byteps_tpu/server/ps_mode.py:941-961``): groups in bucket
        order, empty ones dropped, together covering every leaf once
        (zero-size leaves join group 0)."""
        tree = list(tree)
        _, keyed = self._plan(tree, name)
        last: Dict[int, int] = {}
        for bi, (_, b) in enumerate(keyed):
            for s in b.segments:
                last[s.leaf_index] = bi
        groups: List[List[int]] = [[] for _ in keyed]
        for li in sorted(last):
            groups[last[li]].append(li)
        extras = [li for li in range(len(tree)) if li not in last]
        if extras:
            if not groups:
                groups = [[]]
            groups[0].extend(extras)
        return [g for g in groups if g]

    def exchange_stream(self, tree: Sequence[Tuple[str, object]],
                        name: Optional[str] = None,
                        host_alloc=None, sharded=None) -> _StreamingExchange:
        """A streaming round: every bucket is pushed now, and ``ready()``
        of the returned handle yields each leaf as its last covering
        bucket's pull unpacks. ``host_alloc(n, dtype)`` makes the
        round's flat host leaves (the trainer's pinned staging buffers);
        default ``np.empty``. ``sharded``: a sharded-update round view
        (push every bucket, pull only the owned ones, stream only the
        owned leaves)."""
        self._ensure_watchdog()
        self._ensure_executors()
        rnd = _Round(self, list(tree), name, stream=True,
                     host_alloc=host_alloc, sharded=sharded)
        for i in range(len(rnd.keyed)):
            rnd.submit_bucket(i)
        return _StreamingExchange(rnd)

    def exchange_ingest(self, template: Sequence[Tuple[str, object]],
                        name: Optional[str] = None,
                        step: Optional[int] = None,
                        host_alloc=None, sharded=None) -> _IngestExchange:
        """An ingest round: ``template`` (the parameters, as ``(path,
        tensor)`` pairs) gives the plan; the caller ``feed``s the
        gradients as the backward makes them, and each bucket is pushed
        once its last leaf arrived. ``step`` tags the round in the
        watchdog's dump; ``sharded`` as for ``exchange_stream``."""
        self._ensure_watchdog()
        self._ensure_executors()
        return _IngestExchange(_Round(self, list(template), name,
                                      ingest=True, step=step,
                                      host_alloc=host_alloc,
                                      sharded=sharded))

    def exchange(self, tree: Sequence[Tuple[str, object]],
                 name: Optional[str] = None) -> List[np.ndarray]:
        """One sync round: every bucket is packed (or encoded), pushed and
        pulled, pipelined per bucket. Returns the summed leaves."""
        return self.exchange_async(tree, name).result()

    def exchange_async(self, tree: Sequence[Tuple[str, object]],
                       name: Optional[str] = None) -> _PendingExchange:
        """Like ``exchange``, but returns once every bucket's push is
        submitted (a serial round: done); ``.result()`` drains the pulls
        and returns the summed leaves. This worker's pushes reach the
        server without waiting for any pull, so a caller that holds a
        thread through ``.result()`` cannot keep a peer's round from
        completing (``byteps_tpu/server/ps_mode.py:1342-1360``)."""
        self._ensure_watchdog()
        rnd = _Round(self, list(tree), name)
        if self.pipeline_depth <= 1 or len(rnd.keyed) <= 1:
            # serial: push everything (the server sums as they land),
            # then drain the pulls in the same order
            try:
                bufs = [rnd.push_one(i) for i in range(len(rnd.keyed))]
            except BaseException:
                rnd._mark_finished()
                raise

            def drain() -> List[np.ndarray]:
                try:
                    for i, buf in enumerate(bufs):
                        rnd.pull_one(i, buf)
                        rnd._pull_finished(None)
                finally:
                    rnd._mark_finished()
                return rnd.assemble()
            return _PendingExchange(drain)
        self._ensure_executors()
        for i in range(len(rnd.keyed)):
            rnd.submit_bucket(i)
        return _PendingExchange(rnd.drain)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an async wire or pull dtype name."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"async PS dtype {name!r}: expected one of "
                         f"{sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]


def async_wire_dtype() -> Optional[str]:
    """``BPS_ASYNC_WIRE_DTYPE``, the dtype an async weight delta crosses
    in (None: the parameters' own), read from ``os.environ`` where it
    acts, as the JAX package reads it; a typo raises."""
    wire = os.environ.get("BPS_ASYNC_WIRE_DTYPE") or None
    if wire is not None:
        bf16.np_dtype(wire)
    return wire


def host_leaf(src) -> np.ndarray:
    """``_host_flat`` for a leaf that may be bfloat16: a torch bfloat16
    tensor crosses as its bits, in a ``bf16.BF16`` array. A flat
    contiguous host tensor is viewed, not copied: a pull may write into
    the result."""
    if torch.is_tensor(src) and src.dtype == torch.bfloat16:
        return _host_flat(src.view(torch.int16)).view(bf16.BF16)
    return _host_flat(src)


class AsyncPSWorker:
    """The async-PS worker (the port of ``byteps_tpu/server/ps_mode.py:
    1434-1506``): a local optimizer step, a push of the weight delta, a
    pull of the store's weights, with no barrier between workers. The
    servers must be async (``async_mode=True``): each push folds into the
    store at once, and a pull copies the store as it is.

    It works on a list of leaves in the model's parameter order (tensors
    or host arrays), not on a pytree; key ``i`` serves leaf ``i``. With a
    ``registry`` the keys are the declaration's (``declare(name)
    .key_for_partition(i)``), so several workers' models and other
    declared tensors never share a key; without one they are the bare
    range ``0 .. n-1``, for single-model scripts.

    ``BPS_ASYNC_WIRE_DTYPE`` (e.g. ``bfloat16``) is the dtype a delta
    crosses in: half the bytes, and the server casts it into the
    full-precision store (``PSServer``, or the transport's transcode). A
    delta tolerates the rounding, one step's worth folded into an fp32
    store. The weights' pull stays at the store's dtype unless
    ``BPS_ASYNC_PULL_DTYPE`` says otherwise. Both are read from
    ``os.environ`` when the worker is built, as the JAX package reads
    them. The bytes pushed and pulled count in ``ps/push_bytes`` and
    ``ps/pull_bytes``, as the sync exchange's do."""

    def __init__(self, backend, params: Sequence, name: str = "model",
                 init_store: bool = True,
                 registry: Optional[NameRegistry] = None) -> None:
        self.backend = backend
        self.wire_dtype = async_wire_dtype()
        self.pull_dtype = os.environ.get("BPS_ASYNC_PULL_DTYPE") or None
        if self.pull_dtype is not None:
            bf16.np_dtype(self.pull_dtype)      # fail fast on a typo
        params = list(params)
        self.shapes = [tuple(p.shape) for p in params]
        self.dtypes = [_dtype_name(p) for p in params]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        if registry is not None:
            decl = registry.declare(name)   # idempotent per name
            self.keys = [decl.key_for_partition(i)
                         for i in range(len(params))]
        else:
            self.keys = list(range(len(params)))
        self._staging = None    # pinned host leaves of push_delta_tree
        reg = get_registry()
        self._m_push_bytes = reg.counter("ps/push_bytes")
        self._m_pull_bytes = reg.counter("ps/pull_bytes")
        if init_store:
            self.init_store(params)

    def init_store(self, params: Sequence) -> None:
        """Seed every key's store with ``params``. The server keeps the
        first values it was given and takes a later init as a no-op, so
        this is idempotent: every worker seeds with the same values and
        goes on, without meeting the others."""
        for k, p in zip(self.keys, params):
            arr = host_leaf(p)
            self.backend.init_key(k, arr.nbytes, bf16.dtype_name(arr),
                                  init=arr)

    def pull_into(self, bufs: Sequence[np.ndarray]) -> None:
        """Pull every key's store into ``bufs`` (flat host arrays, one a
        leaf, in the pull dtype): the store as it is, without waiting."""
        for k, b in zip(self.keys, bufs):
            self.backend.pull(k, b)
            self._m_pull_bytes.inc(b.nbytes)

    def pull_weights(self) -> List[np.ndarray]:
        """The store's weights, one host array a leaf in its shape and
        dtype (pulled in ``BPS_ASYNC_PULL_DTYPE`` if it is set)."""
        bufs = [np.empty(n, bf16.np_dtype(self.pull_dtype or dt))
                for n, dt in zip(self.sizes, self.dtypes)]
        self.pull_into(bufs)
        return [(bf16.cast(b, dt) if self.pull_dtype else b).reshape(shp)
                for b, dt, shp in zip(bufs, self.dtypes, self.shapes)]

    def _wire(self, arr: np.ndarray) -> np.ndarray:
        if self.wire_dtype and bf16.dtype_name(arr) != self.wire_dtype:
            arr = bf16.cast(arr, self.wire_dtype)
        return np.ascontiguousarray(arr)

    def push_delta(self, new_params: Sequence, old_params: Sequence) -> None:
        """Push ``new - old`` a leaf, computed on the host; the server
        folds it into the store's weights."""
        for k, nw, od in zip(self.keys, new_params, old_params):
            self._push(k, host_leaf(nw) - host_leaf(od))

    def _push(self, key: int, arr: np.ndarray) -> None:
        arr = self._wire(arr)
        self.backend.push(key, arr)
        self._m_push_bytes.inc(arr.nbytes)

    def push_delta_tree(self, deltas: Sequence) -> None:
        """Push deltas computed elsewhere, e.g. on the card in the wire
        dtype (``DistributedTrainer``'s async step): one narrow tensor a
        leaf crosses to the host, a CUDA leaf into a pinned buffer kept
        for the next step, every copy started before the first push."""
        cuda = [torch.is_tensor(d) and d.is_cuda for d in deltas]
        if any(cuda):
            if self._staging is None:
                self._staging = [None] * len(deltas)
            for i, (d, c) in enumerate(zip(deltas, cuda)):
                if not c:
                    continue
                buf = self._staging[i]
                if buf is None or buf.dtype != d.dtype:
                    buf = self._staging[i] = torch.empty(
                        d.numel(), dtype=d.dtype, pin_memory=True)
                buf.copy_(d.detach().reshape(-1), non_blocking=True)
            for dev in {d.device for d, c in zip(deltas, cuda) if c}:
                torch.cuda.current_stream(dev).synchronize()
        for i, (k, d) in enumerate(zip(self.keys, deltas)):
            self._push(k, host_leaf(self._staging[i] if cuda[i] else d))


class RowSparseExchange:
    """Sync row-sparse exchange: push the touched (idx, rows) of a
    ``[num_rows, cols]`` table, pull the dense table summed over the
    workers (``server/rowsparse.py``; the reference reserved the request
    type, common.h:267-271, without a handler). One PS key a table name.
    Counts its wire bytes in ``ps/push_bytes`` (the frame's payload) and
    ``ps/pull_bytes``."""

    def __init__(self, backend, registry: Optional[NameRegistry] = None
                 ) -> None:
        self.backend = backend
        self.registry = registry or NameRegistry()
        self._inited: Dict[int, tuple] = {}     # key -> (num_rows, cols)
        self._rounds: Dict[int, int] = {}
        reg = get_registry()
        self._m_push_bytes = reg.counter("ps/push_bytes")
        self._m_pull_bytes = reg.counter("ps/pull_bytes")

    def exchange(self, idx, rows, num_rows: int, name: str) -> np.ndarray:
        """One sync round; returns the dense ``[num_rows, cols]`` sum over
        the workers. Distinct tables need distinct names."""
        idx = np.asarray(idx, np.int32).reshape(-1)
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"rows must be [n, cols]; got {rows.shape}")
        cols, dtype = rows.shape[1], str(rows.dtype)
        key = self.registry.declare(name).key_for_partition(0)
        dense_nbytes = num_rows * cols * rows.dtype.itemsize
        prev = self._inited.get(key)
        if prev is None:
            self.backend.init_key(key, dense_nbytes, dtype)
            self._inited[key] = (num_rows, cols)
        elif prev != (num_rows, cols):
            raise ValueError(f"table {name!r} was {prev}, now "
                             f"{(num_rows, cols)} — shape must be stable")
        rnd = self._rounds.get(key)
        if rnd is None:
            # seeded from the server, as the dense exchange is: a rejoined
            # worker resumes at the job's round, not 1 (round 1 would be a
            # stale table at once). Read before the push, which may
            # complete the round.
            rnd = int(self.backend.round(key))
        rnd += 1
        self._rounds[key] = rnd
        self.backend.push_rowsparse(key, idx, rows, dense_nbytes, dtype)
        self._m_push_bytes.inc(4 + idx.nbytes + rows.nbytes)
        out = np.empty(num_rows * cols, rows.dtype)
        self.backend.pull(key, out, round=rnd)
        self._m_pull_bytes.inc(out.nbytes)
        return out.reshape(num_rows, cols)
