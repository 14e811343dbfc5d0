"""ZeRO-style cross-replica sharded weight update on the PS path (the
port's copy of ``byteps_tpu/sharded_update.py``, ``BPS_SHARDED_UPDATE=1``).

Every sync-PS worker otherwise pulls every summed gradient and runs the
whole optimizer step: pull bytes, apply work and optimizer state are all
O(model) on every replica, whatever the data-parallel degree (the
redundancy of arXiv 2004.13336, and the memory ZeRO, arXiv 1910.02054,
targets). Here:

  - the exchange's bucket groups (``PSGradientExchange.leaf_groups``) are
    partitioned across the ``dp`` replicas by byte-balanced ownership, the
    ``HashRing`` successor walk from each group's defining bucket key
    breaking ties (``server/plane/placement.py``): every worker, the JAX
    package's too, derives the same assignment from the shared bucket
    plan, with no coordination round;
  - every worker still pushes every gradient bucket (the server's sum
    needs all of them) but pulls only the buckets that cover its owned
    groups and applies the optimizer only to those
    (``optim.ChunkedApply``'s ``owned``): a torch optimizer makes a
    parameter's state at its first step, so state exists for the owned
    parameters alone;
  - the owner publishes each group's updated parameter bytes through the
    server's param mailbox (``ParamStore``; ops 21 PUT and 22 GET of the
    wire, a versioned last-wins store, one frame per (group, step)), and
    the other replicas fetch and install them instead of pulling the
    gradients. PUT frames ride the wire credit's latency class with
    next-step first-use priority (``server/admission.py::SendScheduler``).

Cross steps: a fetched group marks the same per-leaf epoch
(``ChunkedApply.mark_epoch``) that an applied one does, so the cross-step
driver's gates and the per-key admission gate work unchanged. For a
bucket that is not pulled, the gate is released when the param frames of
every group the bucket covers have landed, which implies that the owner
pulled that bucket's round.

Error feedback: a compressed key commits its round's pending residual when
the round is known consumed: the owner on its pull, a non-owner when the
round's param frames land (``server/ps_mode.py::_Round.release_skipped``).

Failure: an owner that dies between its pull and its publish never leaves
the others hanging. A fetch waits ``BPS_PARAM_TIMEOUT_MS`` (default 30000)
and then raises naming the group, the owner rank, the step and the param
key; until then the watchdog's dump shows the bucket as ``await_param``
with its owner.

Probe or fall back: dp 1, a backend without the mailbox, async mode,
legacy ``compressor_type`` keys, fewer than two groups and an optimizer
that is not leafwise decomposable each keep the full apply, with one INFO
line naming the reason.

Not ported yet (ROADMAP.md, queue 1, item 6): a live membership change
(``reshard``, the optimizer-state handoff through ``STATE_KEY_BASE`` keys)
and sharded checkpoints. They raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .common.logging import get_logger
from .obs import flight
from .obs.metrics import get_registry, observe_stage
from .server.ps_mode import _dtype_name

#: param-class key space: bit 41 set on ``decl_key << 16 | group``,
#: disjoint from gradient keys (< 2^40) and activation channels (bit 40)
PARAM_KEY_BASE = 1 << 41

#: the membership handoff's key space (bit 42), kept free of param keys;
#: the handoff itself is not ported
STATE_KEY_BASE = 1 << 42

#: mailbox retention, seqs per key: two rounds in flight (cross steps)
#: and slack for a straggling fetcher's retry
PARAM_RETAIN = 4

_NOT_PORTED = ("is not ported yet (see ROADMAP.md, 'Modules still to "
               "port', queue 1, item 6)")


def param_timeout_ms() -> int:
    """How long a non-owner waits for an owner's param frame before it
    raises the owner-death diagnostic."""
    return int(os.environ.get("BPS_PARAM_TIMEOUT_MS", "30000") or 30000)


class ParamStore:
    """The server's param mailbox: ``put`` is last-wins per (key, seq), so
    a resend after a lost ACK stores the same bytes again; ``get`` blocks
    until the seq arrives and does not consume it (dp - 1 replicas read
    each frame). A key keeps the ``retain`` newest seqs."""

    def __init__(self, retain: int = PARAM_RETAIN) -> None:
        self.retain = int(retain)
        self._cv = threading.Condition()
        self._data: Dict[int, Dict[int, bytes]] = {}

    def put(self, key: int, seq: int, payload) -> None:
        key, seq = int(key), int(seq)
        with self._cv:
            d = self._data.setdefault(key, {})
            d[seq] = bytes(payload)
            for s in [s for s in d if s <= seq - self.retain]:
                del d[s]
            self._cv.notify_all()

    def get(self, key: int, seq: int, timeout_ms: int = 30000) -> bytes:
        key, seq = int(key), int(seq)
        deadline = time.monotonic() + timeout_ms / 1e3
        with self._cv:
            while True:
                d = self._data.get(key)
                if d is not None and seq in d:
                    return d[seq]
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"param get(key={key:#x}, seq={seq}) timed out "
                        f"after {timeout_ms}ms — owner never published")
                self._cv.wait(min(left, 0.5))

    def latest(self, key: int) -> int:
        """The newest retained seq of ``key`` (0: nothing stored)."""
        with self._cv:
            d = self._data.get(int(key))
            return max(d) if d else 0


class _RoundView:
    """What a sharded ``ps_mode._Round`` needs: the buckets to pull, the
    leaves to stream, and the owner ranks of each skipped bucket (the
    watchdog's diagnostic)."""

    __slots__ = ("pull_buckets", "stream_leaves", "skip_owner")

    def __init__(self, pull_buckets, stream_leaves, skip_owner) -> None:
        self.pull_buckets = frozenset(pull_buckets)
        self.stream_leaves = frozenset(stream_leaves)
        self.skip_owner = dict(skip_owner)


class ShardedUpdatePlan:
    """Deterministic byte-balanced ownership of the exchange's bucket
    groups across ``world`` data-parallel replicas.

    Each group's candidates are the ``HashRing`` successor walk from its
    defining bucket's PS key, and the group goes to the lightest candidate
    by bytes assigned so far (walk order breaks ties). ``keyed`` is the
    exchange's ``[(pskey, Bucket)]``, ``groups`` its ``leaf_groups`` and
    ``leaf_meta`` ``(shape, dtype, nbytes)`` per flat leaf
    (``leaf_meta_of``)."""

    def __init__(self, keyed, groups, leaf_meta, rank: int, world: int,
                 vnodes: int = 0, live=None, prev_owner=None,
                 weights=None, owner_map=None) -> None:
        from .server.plane.placement import DEFAULT_VNODES, HashRing
        if world <= 1:
            raise ValueError("sharded update needs dp > 1")
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} outside [0, {world})")
        self.rank, self.world = int(rank), int(world)
        self.groups = [tuple(g) for g in groups]
        # the ranks that may own groups; one outside it still pushes and
        # fetches, and owns nothing
        self.live = (frozenset(range(world)) if live is None
                     else frozenset(int(r) for r in live))
        if not self.live:
            raise ValueError("membership needs at least one live rank")
        if not all(0 <= r < world for r in self.live):
            raise ValueError(f"live ranks {sorted(self.live)} outside "
                             f"[0, {world})")
        self.leaf_meta = list(leaf_meta)
        leaf_group: Dict[int, int] = {}
        for gi, g in enumerate(self.groups):
            for li in g:
                leaf_group[li] = gi
        # the buckets each group's leaves touch: its owner pulls them all
        # (a leaf larger than a bucket spans several)
        needed: List[set] = [set() for _ in self.groups]
        for bi, (_, b) in enumerate(keyed):
            for s in b.segments:
                gi = leaf_group.get(s.leaf_index)
                if gi is not None:
                    needed[gi].add(bi)
        self.needed = [frozenset(n) for n in needed]
        self.group_bytes = [sum(self.leaf_meta[li][2] for li in g)
                            for g in self.groups]
        self.bucket_labels = [getattr(b, "index", bi)
                              for bi, (_, b) in enumerate(keyed)]
        # the defining bucket: the last one covering the group, whose pull
        # completes it; a group of zero-size leaves keys off its index
        self.group_bucket = [max(n) if n else None for n in needed]
        if weights is not None and len(weights) != len(self.groups):
            raise ValueError(f"{len(weights)} weights for "
                             f"{len(self.groups)} groups")
        w = ([max(0, int(x)) for x in weights] if weights is not None
             else list(self.group_bytes))
        self.weights = w
        dead = set(range(world)) - self.live
        ring = HashRing(world, vnodes=vnodes or DEFAULT_VNODES)
        n = len(self.groups)
        load = [0] * world
        owner: List[Optional[int]] = [None] * n
        if owner_map is not None:
            # an authoritative map, installed as it is
            if len(owner_map) != n:
                raise ValueError(
                    f"owner map covers {len(owner_map)} groups, plan "
                    f"has {n} — peers are running different bucket "
                    f"plans")
            for gi, o in enumerate(owner_map):
                o = int(o)
                if o not in self.live:
                    raise ValueError(f"owner map assigns group {gi} to "
                                     f"rank {o} outside the live set")
                owner[gi] = o
                load[o] += w[gi]
        else:
            if prev_owner is not None and len(prev_owner) != n:
                raise ValueError(
                    f"previous owner map covers {len(prev_owner)} "
                    f"groups, plan has {n}")
            if prev_owner is not None:
                # minimal movement: a group whose owner is still live
                # stays with it
                for gi, o in enumerate(prev_owner):
                    if o in self.live:
                        owner[gi] = int(o)
                        load[o] += w[gi]
            for gi in range(n):
                if owner[gi] is not None:
                    continue
                bi = self.group_bucket[gi]
                ring_key = keyed[bi][0] if bi is not None else gi
                cands = ring.successors(ring_key, world, skip=dead)
                r = min(cands, key=lambda c: load[c])   # first wins ties
                owner[gi] = r
                load[r] += w[gi]
            if prev_owner is not None:
                # leveling after a join: move the largest strictly
                # improving group from the heaviest to the lightest owner
                # until the spread is within one group
                lv = sorted(self.live)
                for _ in range(n):
                    h = max(lv, key=lambda r: load[r])
                    lo = min(lv, key=lambda r: load[r])
                    best = None
                    for gi in sorted(range(n), key=lambda g: (-w[g], g)):
                        if owner[gi] == h and \
                                2 * w[gi] <= load[h] - load[lo]:
                            best = gi
                            break
                    if best is None:
                        break
                    owner[best] = lo
                    load[h] -= w[best]
                    load[lo] += w[best]
        self.owner = [int(o) for o in owner]
        self.load = load
        self._keyed = list(keyed)
        self._vnodes = int(vnodes)
        self.owned = tuple(gi for gi, o in enumerate(owner) if o == rank)
        self.owned_set = frozenset(self.owned)
        self.stream_leaves = frozenset(
            li for gi in self.owned for li in self.groups[gi])
        self.pull_buckets = frozenset(
            bi for gi in self.owned for bi in needed[gi])
        all_buckets = frozenset(range(len(keyed)))
        covered = frozenset(bi for n in needed for bi in n)
        # every bucket's leaves belong to some group: every bucket is
        # pulled here or released by param fetches
        assert covered == all_buckets, (covered, all_buckets)
        # skipped bucket -> the groups whose frames release it, and every
        # owner to name (a boundary bucket may wait on two)
        self.skip_groups: Dict[int, Tuple[int, ...]] = {}
        self.skip_owner: Dict[int, Tuple[int, ...]] = {}
        for bi in sorted(all_buckets - self.pull_buckets):
            gs = tuple(gi for gi in range(len(self.groups))
                       if bi in needed[gi])
            self.skip_groups[bi] = gs
            self.skip_owner[bi] = tuple(sorted({owner[gi] for gi in gs}))
        # fetches go in next-step first-use order (lowest leaf first)
        self.fetch_order = tuple(sorted(
            (gi for gi in range(len(self.groups)) if owner[gi] != rank),
            key=lambda gi: min(self.groups[gi], default=0)))
        decl_key = (keyed[0][0] >> 16) if keyed else 0
        self.decl_key = decl_key
        self.param_keys = {
            gi: PARAM_KEY_BASE | (decl_key << 16) | gi
            for gi in range(len(self.groups))}
        self.state_keys = {
            gi: STATE_KEY_BASE | (decl_key << 16) | gi
            for gi in range(len(self.groups))}

    def reshard(self, live, weights=None) -> "ShardedUpdatePlan":
        """The next membership epoch's plan over ``live``: kept owners stay,
        a departed rank's groups go to the lightest live candidate on
        their walk, a joiner is leveled up by the largest strictly
        improving moves. Pure planning, the same on every replica."""
        return ShardedUpdatePlan(self._keyed, self.groups,
                                 self.leaf_meta, self.rank, self.world,
                                 vnodes=self._vnodes, live=live,
                                 prev_owner=self.owner, weights=weights)

    def with_owner_map(self, owner_map, live=None) -> "ShardedUpdatePlan":
        """A plan with ownership installed from ``owner_map`` as it is."""
        return ShardedUpdatePlan(
            self._keyed, self.groups, self.leaf_meta, self.rank,
            self.world, vnodes=self._vnodes,
            live=live if live is not None else sorted(set(owner_map)),
            owner_map=owner_map)

    def round_view(self) -> _RoundView:
        return _RoundView(self.pull_buckets, self.stream_leaves,
                          self.skip_owner)

    def balance_ratio(self) -> float:
        """max / min owned bytes over the replicas (1.0: even); the
        largest single group bounds the imbalance."""
        lo = min(self.load)
        return float(max(self.load)) / float(lo) if lo else float("inf")

    # ------------------------------------------------------ param frames

    def pack_group(self, gi: int, host_leaves: Sequence[np.ndarray]) -> bytes:
        """A group's updated parameter bytes, concatenated in group order:
        the JAX package's frame for the same leaves."""
        parts = []
        for li, arr in zip(self.groups[gi], host_leaves):
            shape, dtype, nbytes = self.leaf_meta[li]
            a = np.ascontiguousarray(arr)
            if a.nbytes != nbytes or np.dtype(a.dtype) != np.dtype(dtype):
                raise ValueError(
                    f"param publish of leaf {li}: got {a.nbytes}B "
                    f"{a.dtype}, plan expects {nbytes}B {dtype}")
            parts.append(a.tobytes())
        return b"".join(parts)

    def unpack_group(self, gi: int, payload) -> List[np.ndarray]:
        """The leaves of a group's frame (views of ``payload``); a frame of
        another size means the peers run different bucket plans."""
        want = sum(self.leaf_meta[li][2] for li in self.groups[gi])
        if len(payload) != want:
            raise ValueError(
                f"param frame for group {gi} is {len(payload)}B, plan "
                f"expects {want}B — peers are running different bucket "
                f"plans")
        out, off = [], 0
        for li in self.groups[gi]:
            shape, dtype, nbytes = self.leaf_meta[li]
            n = nbytes // max(1, np.dtype(dtype).itemsize)
            a = np.frombuffer(payload, dtype=dtype, count=n, offset=off)
            out.append(a.reshape(shape))
            off += nbytes
        return out

    @staticmethod
    def leaf_meta_of(tree) -> List[Tuple[tuple, str, int]]:
        """``(shape, dtype, nbytes)`` per leaf of ``tree``: tensors or
        arrays, or ``(path, tensor)`` pairs, in the trainer's flat order
        (the JAX tree's)."""
        metas = []
        for leaf in tree:
            if isinstance(leaf, tuple):
                leaf = leaf[1]
            shape = tuple(leaf.shape)
            dtype = _dtype_name(leaf)
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            metas.append((shape, dtype, nbytes))
        return metas


def pack_opt_state(state) -> bytes:
    """The membership handoff's optimizer-state frame: not ported."""
    raise NotImplementedError(f"the sharded update's optimizer-state "
                              f"handoff (pack_opt_state) {_NOT_PORTED}")


def unpack_opt_state(payload, template):
    """The membership handoff's optimizer-state frame: not ported."""
    raise NotImplementedError(f"the sharded update's optimizer-state "
                              f"handoff (unpack_opt_state) {_NOT_PORTED}")


def _fallback(reason: str) -> None:
    get_logger().info("BPS_SHARDED_UPDATE falls back to the full weight "
                      "update: %s", reason)


def build_sharded_state(exchange, params, optimizer, name: str, rank: int,
                        world: int) -> Optional["ShardedUpdateState"]:
    """Probe or fall back (the trainer calls it at its first step, once the
    exchange's backend is final): the state, or None with one INFO line
    naming why the sharded contract cannot hold. ``params``: the
    trainer's ``(path, parameter)`` pairs in the flat order."""
    from .optim import leafwise_decomposable
    if world <= 1:
        _fallback("dp=1 (nothing to shard across)")
        return None
    backend = exchange.backend
    if not hasattr(backend, "param_put") or not hasattr(backend,
                                                       "param_get"):
        _fallback(f"backend {type(backend).__name__} has no param "
                  f"mailbox (param_put/param_get)")
        return None
    if getattr(backend, "async_mode", False):
        _fallback("async PS mode (round-less pulls leave no ownership "
                  "anchor)")
        return None
    params = list(params)
    decl_name, keyed = exchange._plan(params, name)
    if any(pskey in exchange._chains for pskey, _ in keyed):
        _fallback("legacy compressor_type keys on this declaration "
                  "(their byte-path pulls carry codec state per worker)")
        return None
    groups = exchange.leaf_groups(params, name=name)
    if len(groups) < 2:
        _fallback(f"{len(groups)} bucket group(s) — nothing to partition")
        return None
    if not leafwise_decomposable(optimizer, [p for _, p in params],
                                 [tuple(g) for g in groups]):
        _fallback("optimizer is not leafwise-decomposable (owned-shard "
                  "apply would change the math)")
        return None
    plan = ShardedUpdatePlan(keyed, groups,
                             ShardedUpdatePlan.leaf_meta_of(params),
                             rank, world)
    return ShardedUpdateState(exchange, plan, decl_name)


@contextlib.contextmanager
def _on(stream):
    """Make ``stream`` current (a CUDA stream), or nothing."""
    if stream is None:
        yield
        return
    with torch.cuda.stream(stream):
        yield


class ShardedUpdateState:
    """One trainer's sharded-update machinery: the ownership plan, the
    param-frame seq (every replica steps in lockstep, so equal seqs are
    the same step) and the publisher thread that ships the owned groups'
    updated parameters without holding up the apply loop."""

    def __init__(self, exchange, plan: ShardedUpdatePlan, name: str) -> None:
        self.exchange = exchange
        self.plan = plan
        self.name = name
        self._seq_lock = threading.Lock()
        self.timeout_ms = param_timeout_ms()
        # a rejoining owner resumes its seq above the server's retained
        # frames (OP_PARAM_SEQ); a fresh job finds none and starts at 0
        self._seq = 0
        be = exchange.backend
        if hasattr(be, "param_latest"):
            try:
                self._seq = max((int(be.param_latest(k))
                                 for k in plan.param_keys.values()),
                                default=0)
            except Exception as e:   # noqa: BLE001 — start at 0, loudly
                self._seq = 0
                get_logger().warning(
                    "sharded update: param-seq seed scan failed (%s: %s) "
                    "— seq starts at 0; if this worker rejoins a live "
                    "job, its peers block on the real next seq until "
                    "BPS_PARAM_TIMEOUT_MS", type(e).__name__, e)
            if self._seq:
                get_logger().info(
                    "sharded update: param seq resumes at %d from the "
                    "server's retained frames", self._seq)
        reg = get_registry()
        self._m_put = reg.counter("ps/param_put_bytes")
        self._m_fetch = reg.counter("ps/param_fetch_bytes")
        self._pub_q: List = []
        self._pub_busy = False          # a frame is on its way out
        self._pub_cv = threading.Condition()
        self._pub_stop = False
        self._pub_err: Optional[BaseException] = None
        self._pub_thread: Optional[threading.Thread] = None
        # PUT frames are the wire credit's latency class, in next-step
        # first-use order among themselves
        if hasattr(be, "set_send_priority"):
            nleaves = len(plan.leaf_meta)
            for gi, key in plan.param_keys.items():
                first = min(plan.groups[gi], default=0)
                be.set_send_priority(key, nleaves - first)

    def next_seq(self) -> int:
        """The seq of the next sharded round: taken once a step, at tail
        launch, in step order, on every replica alike."""
        with self._seq_lock:
            self._seq += 1
            return self._seq

    # ------------------------------------------------------- membership

    def reshard(self, *args, **kwargs):
        """A live membership change: not ported."""
        raise NotImplementedError(f"a live membership change of the sharded "
                                  f"update (reshard) {_NOT_PORTED}")

    def adopt_membership(self, *args, **kwargs):
        """A membership view from a sharded checkpoint: not ported."""
        raise NotImplementedError(f"the sharded update's membership "
                                  f"handoff (adopt_membership) {_NOT_PORTED}")

    # -------------------------------------------------------- publisher

    def check_publisher(self) -> None:
        """Raise if the publisher died: frames this replica owed its peers
        never reached the store."""
        with self._pub_cv:
            err = self._pub_err
        if err is not None:
            raise RuntimeError(
                "sharded-update param publisher died — some owned "
                "groups' param frames never reached the store; "
                "non-owners of those groups will time out") from err

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Wait until every queued frame reached the store (the trainer's
        ``drain()``: what a step owes its peers is out, and the counters
        say so); raises if the publisher died or the wait outlasts
        ``timeout_s`` (default ``BPS_PARAM_TIMEOUT_MS``)."""
        limit = self.timeout_ms / 1e3 if timeout_s is None else timeout_s
        deadline = time.monotonic() + limit
        with self._pub_cv:
            while (self._pub_q or self._pub_busy) and self._pub_err is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"sharded-update param publisher did not flush its "
                        f"queue within {limit:.0f}s")
                self._pub_cv.wait(min(left, 0.5))
        self.check_publisher()

    def close(self) -> None:
        """Flush the queued frames and stop the publisher; raises if the
        flush did not finish or the publisher died."""
        with self._pub_cv:
            self._pub_stop = True
            self._pub_cv.notify_all()
        t = self._pub_thread
        if t is not None:
            t.join(timeout=5.0)
            alive = t.is_alive()
            self._pub_thread = None
            if alive:
                raise RuntimeError(
                    "sharded-update param publisher did not flush its "
                    "queue within 5s at close — param frames owed to "
                    "peer replicas may never have shipped (non-owners "
                    "of this replica's groups will time out)")
        self.check_publisher()

    def _ensure_publisher(self) -> None:
        with self._pub_cv:
            if self._pub_thread is None or not self._pub_thread.is_alive():
                self._pub_stop = False
                self._pub_thread = threading.Thread(
                    target=self._pub_run, name="bps-param-pub", daemon=True)
                self._pub_thread.start()

    def _pub_run(self) -> None:
        while True:
            with self._pub_cv:
                while not self._pub_q and not self._pub_stop:
                    self._pub_cv.wait(0.5)
                if self._pub_stop and not self._pub_q:
                    return
                gi, seq, host = self._pub_q.pop(0)
                self._pub_busy = True
            key = self.plan.param_keys[gi]
            try:
                t0 = time.time()
                payload = self.plan.pack_group(gi, host)
                self.exchange.backend.param_put(key, seq, payload)
                self._m_put.inc(len(payload))
                flight.record("param_put", key=key, round=seq,
                              nbytes=len(payload))
                observe_stage("PS_PARAM_PUT", time.time() - t0)
                self.exchange._mark_progress()
            except BaseException as e:   # noqa: BLE001 — surfaced to the
                flight.record("param_put", key=key, round=seq,  # tail
                              outcome=f"error:{type(e).__name__}")
                with self._pub_cv:
                    if self._pub_err is None:
                        self._pub_err = e
            finally:
                with self._pub_cv:
                    self._pub_busy = False
                    self._pub_cv.notify_all()

    def publish(self, gi: int, seq: int, host_leaves) -> None:
        """Queue group ``gi``'s updated parameters (host arrays, a
        finished snapshot) for the wire."""
        with self._pub_cv:
            if self._pub_err is not None:
                raise RuntimeError(
                    "param publisher died — non-owners of this replica's "
                    "groups will time out waiting") from self._pub_err
            self._pub_q.append((gi, seq, list(host_leaves)))
            self._pub_cv.notify_all()
        self._ensure_publisher()

    # ------------------------------------------------------------- tail

    def param_installer(self, device):
        """``put_param(param, arr, stream)``: an owner's bytes copied into
        ``param`` in place, as they are (never divided by the workers,
        unlike a pulled gradient sum), on ``stream``; returns the event
        after the copy (None on the CPU). On the card the bytes go through
        a pinned buffer, so the copy is one asynchronous DMA ordered on
        the stream that runs the forward."""
        from .staging import PinnedPool
        cuda = torch.device(device).type == "cuda"
        pool = PinnedPool() if cuda else None

        def put_param(param, arr: np.ndarray, stream):
            t0 = time.time()
            src = np.ascontiguousarray(arr).reshape(-1)
            ev = None
            with torch.no_grad():
                dst = param.detach()
                if not cuda:
                    dst.copy_(torch.tensor(src).view(dst.shape))
                else:
                    buf = pool.alloc(src.size, src.dtype)
                    np.copyto(buf, src)
                    with _on(stream):
                        dst.copy_(torch.from_numpy(buf).view(dst.shape),
                                  non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(dst.device))
                    pool.release(buf, ev)
            observe_stage("PS_H2D", time.time() - t0)
            return ev

        return put_param

    def run_tail(self, handle, chunked, e: int, seq: int, copy_grad,
                 put_param, hyper, stream=None, should_abort=None) -> int:
        """Consume one sharded round end to end; returns the number of
        groups applied here.

          - a reader thread drains the round's ready stream (owned leaves
            only: the round's pull mask keeps the others off it), copies
            each summed leaf to the device (``copy_grad(arr, shape) ->
            (tensor, event)``) and queues complete owned groups by
            next-use priority;
          - up to four fetcher threads take the other groups' frames in
            first-use order, install them (after the group's previous
            epoch, ``put_param``), mark their epoch, and release the
            skipped buckets' admission keys (committing their residuals);
          - this thread applies the owned groups in turn, after each one's
            previous epoch, on ``stream`` (None: the current one), takes a
            finished host copy of the new parameters, queues the publish
            and marks the epoch.
        """
        rnd = handle.round_state
        plan = self.plan
        params = chunked.params
        shapes = [tuple(p.shape) for p in params]
        if stream is None and params and params[0].is_cuda:
            stream = torch.cuda.current_stream(params[0].device)
        cv = threading.Condition()
        ready_groups: List = []
        landed: dict = {}
        state = {"done": False, "exc": None}

        def fail(exc: BaseException) -> None:
            with cv:
                if state["exc"] is None:
                    state["exc"] = exc
                cv.notify_all()

        def aborted() -> bool:
            return (state["exc"] is not None
                    or (should_abort is not None and should_abort()))

        def reader() -> None:
            remaining = {gi: len(plan.groups[gi]) for gi in plan.owned}
            try:
                for li, arr in handle.ready():
                    d = copy_grad(arr, shapes[li])
                    gi = chunked.leaf_group.get(li)
                    with cv:
                        landed[li] = d
                        if gi in remaining:
                            remaining[gi] -= 1
                            if remaining[gi] == 0:
                                heapq.heappush(
                                    ready_groups,
                                    (min(plan.groups[gi], default=0), gi))
                                cv.notify_all()
            except BaseException as exc:   # noqa: BLE001 — relayed
                fail(exc)
            finally:
                with cv:
                    state["done"] = True
                    cv.notify_all()

        skip_lock = threading.Lock()
        skip_left = {bi: set(gs) for bi, gs in plan.skip_groups.items()}
        fetch_iter = iter(plan.fetch_order)
        fetch_lock = threading.Lock()

        def fetch_one(gi: int) -> None:
            key = plan.param_keys[gi]
            t0 = time.time()
            try:
                payload = self.exchange.backend.param_get(
                    key, seq, timeout_ms=self.timeout_ms)
            except TimeoutError as te:
                flight.record("param_fetch", key=key, round=seq,
                              outcome="error:TimeoutError")
                if rnd._pull_err is not None:
                    # this replica's own push or pull failed in the round:
                    # the server round never completed, so no owner could
                    # publish; blame the real cause, not a healthy owner
                    raise RuntimeError(
                        f"sharded update: this replica's gradient "
                        f"push/pull failed in the round (step {e}), so "
                        f"the server round never completed and no "
                        f"owner could publish group {gi}'s params"
                    ) from rnd._pull_err
                raise RuntimeError(
                    f"sharded update: param frame for group "
                    f"{gi} (key {key:#x}, step {e}, seq {seq}) "
                    f"never arrived from owner replica "
                    f"{plan.owner[gi]} within "
                    f"{self.timeout_ms}ms — owner died between "
                    f"its grad pull and its param publish? "
                    f"Non-owners cannot apply this group"
                ) from te
            self._m_fetch.inc(len(payload))
            flight.record("param_fetch", key=key, round=seq,
                          nbytes=len(payload))
            observe_stage("PS_PARAM_GET", time.time() - t0)
            host = plan.unpack_group(gi, payload)
            group = plan.groups[gi]
            chunked.wait_epoch(group, e - 1, should_abort=aborted)
            if aborted():
                return
            ev = None
            for li, a in zip(group, host):
                ev = put_param(params[li], a, stream)
            chunked.apply_events[gi] = ev
            # marked only after the install was enqueued: a gate waking
            # earlier would read the previous step's weights
            chunked.mark_epoch(group, e)
            self.exchange._mark_progress()
            with skip_lock:
                fire = []
                for bi, left in skip_left.items():
                    if gi in left:
                        left.discard(gi)
                        if not left:
                            fire.append(bi)
            for bi in sorted(fire):
                rnd.release_skipped(bi)

        def fetcher() -> None:
            try:
                while not aborted():
                    with fetch_lock:
                        gi = next(fetch_iter, None)
                    if gi is None:
                        return
                    fetch_one(gi)
            except BaseException as exc:   # noqa: BLE001 — relayed
                fail(exc)

        rt = threading.Thread(target=reader, daemon=True,
                              name=f"bps-shard-ready-{e}")
        rt.start()
        fts = [threading.Thread(target=fetcher, daemon=True,
                                name=f"bps-shard-fetch-{e}-{i}")
               for i in range(min(4, max(1, len(plan.fetch_order))))]
        for ft in fts:
            ft.start()
        applied = 0
        try:
            while True:
                with cv:
                    while not ready_groups and not state["done"] \
                            and state["exc"] is None:
                        cv.wait()
                    if state["exc"] is not None:
                        raise state["exc"]
                    if not ready_groups and state["done"]:
                        break
                    _, gi = heapq.heappop(ready_groups)
                group = plan.groups[gi]
                chunked.wait_epoch(group, e - 1, should_abort=aborted)
                with cv:
                    if state["exc"] is not None:
                        raise state["exc"]
                    items = [landed.pop(i) for i in group]
                chunked.apply_group(gi, [t for t, _ in items], hyper,
                                    [ev for _, ev in items if ev is not None],
                                    stream=stream)
                # a finished host copy BEFORE the epoch is marked: the next
                # step's apply of this group updates the parameters in
                # place as soon as the mark lets it
                with _on(stream):
                    host = [params[li].detach().to("cpu", copy=True).numpy()
                            for li in group]
                self.publish(gi, seq, host)
                chunked.mark_epoch(group, e)
                applied += 1
            # the owned applies ending is not the round ending: the
            # installs gate later steps too
            for ft in fts:
                ft.join()
            with cv:
                if state["exc"] is not None:
                    raise state["exc"]
            # a skipped bucket's failed push streams nothing and feeds no
            # fetch here: its error is only in the round's _pull_err, and
            # every peer is about to wait on the incomplete server round
            if rnd._pull_err is not None:
                raise RuntimeError(
                    f"sharded round (step {e}) has a failed bucket "
                    f"push/pull on this replica — the server round is "
                    f"incomplete and peers cannot finish it"
                ) from rnd._pull_err
        except BaseException:
            # wake the other threads' gates; the caller reports the step
            # as partial, as for an unsharded tail
            with cv:
                if state["exc"] is None:
                    state["exc"] = RuntimeError("sharded tail aborted")
                cv.notify_all()
            raise
        return applied
