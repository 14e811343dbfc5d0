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

A live membership change (``ShardedUpdateState.reshard``, the JAX
package's ``:642-754``): at a step boundary every replica re-plans
ownership over the live ranks (``ShardedUpdatePlan.reshard``: kept owners
stay), publishes each group it loses as an optimizer-state frame
(``pack_opt_state``) under ``STATE_KEY_BASE | decl << 16 | gi`` with seq
the new member epoch, and only then fetches and adopts the groups it
gains: publish before fetch on every rank, so no rank waits on another
that waits on it. A frame that never comes (the old owner crashed) is
logged and the group restarts from a fresh state. A sharded checkpoint
(``checkpoint.py``) stores the same frames, one a group, and its restore
adopts the saved owner map (``adopt_membership``).
"""

from __future__ import annotations

import contextlib
import heapq
import io
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

#: the membership handoff's key space (bit 42): a lost group's optimizer
#: state frame rides the param mailbox under ``1 << 42 | decl << 16 |
#: group``, seq the member epoch that hands it over
STATE_KEY_BASE = 1 << 42

#: mailbox retention, seqs per key: two rounds in flight (cross steps)
#: and slack for a straggling fetcher's retry
PARAM_RETAIN = 4

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


def _host(t: torch.Tensor) -> np.ndarray:
    """A state tensor's host copy (bfloat16 as its ``uint16`` bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _like(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array ``a`` as a tensor of ``dtype`` on ``device``."""
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind in "uiV":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def pack_opt_state(state) -> bytes:
    """One group's optimizer-state frame (``optim.GroupState``): the
    membership handoff's frame and a sharded checkpoint's slice, one
    format for both, an ``np.savez`` of arrays ``a0``, ``a1``, ...

    Adam and AdamW (``state.adam``) take the JAX package's layout, the
    flat leaves of optax's ``ScaleByAdamState``: ``a0`` the group's count
    (int32, 0-d; torch's common ``step``), then the ``exp_avg`` of each
    parameter in group order (mu), then the ``exp_avg_sq`` (nu). A frame
    of either package unpacks in the other to the same arrays; the bytes
    differ, since ``np.savez`` writes zip timestamps.

    Another optimizer's frame is the port's own layout: each parameter's
    state tensors in group order and, within a parameter, in its state
    dict's order, with an entry ``keys`` naming each (``"<j>:<key>"``;
    ``"<j>:<key>:py"`` for a Python number, stored 0-d); the JAX package
    reads no such frame."""
    arrays = {}
    if state.adam:
        steps = {float(s["step"]) for s in state.state if s}
        if len(steps) > 1 or (steps and not all(state.state)):
            raise ValueError(f"opt-state frame: the group's parameters are "
                             f"at different steps {sorted(steps)}")
        count = int(steps.pop()) if steps else 0
        arrays["a0"] = np.asarray(count, dtype=np.int32)
        n = len(state.state)
        for j, s in enumerate(state.state):
            for i, key in ((1 + j, "exp_avg"), (1 + n + j, "exp_avg_sq")):
                # a group never stepped: the fresh state's zeros
                arrays[f"a{i}"] = _host(s[key] if s else torch.zeros_like(
                    state.params[j], memory_format=torch.contiguous_format))
    else:
        names = []
        for j, s in enumerate(state.state):
            for key, v in s.items():
                if torch.is_tensor(v):
                    arrays[f"a{len(names)}"] = _host(v)
                    names.append(f"{j}:{key}")
                elif isinstance(v, (bool, int, float)):
                    arrays[f"a{len(names)}"] = np.asarray(v)
                    names.append(f"{j}:{key}:py")
                else:
                    raise TypeError(f"opt-state frame: parameter {j}'s "
                                    f"state {key!r} is a "
                                    f"{type(v).__name__}, neither a tensor "
                                    f"nor a number")
        arrays["keys"] = np.asarray(names, dtype=np.str_)
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _leaf_count(n: int, want: int) -> None:
    if n != want:
        raise ValueError(
            f"opt-state frame has {n} leaves, template expects {want} — "
            f"peers are running different optimizer recipes or bucket "
            f"plans")


def _leaf_shape(i: int, a: np.ndarray, want: tuple) -> None:
    if tuple(a.shape) != tuple(want):
        raise ValueError(
            f"opt-state leaf {i} is {tuple(a.shape)}, template expects "
            f"{tuple(want)} — peers are running different plans")


def unpack_opt_state(payload, template):
    """The group state of a ``pack_opt_state`` frame, against
    ``template`` (``ChunkedApply.init_group`` of the group, or its current
    state): each tensor in its template tensor's dtype and on its device,
    where torch keeps it. A leaf count or a shape other than the
    template's means the peers run different plans, and raises the JAX
    package's ``ValueError``."""
    from .optim import GroupState
    data = np.load(io.BytesIO(bytes(payload)))
    files = set(data.files)
    n = len(template.state)
    if template.adam:
        _leaf_count(len(files), 1 + 2 * n)
        if files != {f"a{i}" for i in range(1 + 2 * n)}:
            raise ValueError(
                f"opt-state frame holds {sorted(files)}, not the Adam "
                f"layout's a0..a{2 * n} — peers are running different "
                f"optimizer recipes")
        leaves = [data[f"a{i}"] for i in range(1 + 2 * n)]
        shapes = [()] + [tuple(t[key].shape) for key in ("exp_avg",
                                                         "exp_avg_sq")
                         for t in template.state]
        for i, (a, want) in enumerate(zip(leaves, shapes)):
            _leaf_shape(i, a, want)
        out = []
        for j, t in enumerate(template.state):
            out.append({"step": torch.full((), float(leaves[0]),
                                           dtype=t["step"].dtype,
                                           device=t["step"].device),
                        "exp_avg": _into(leaves[1 + j], t["exp_avg"]),
                        "exp_avg_sq": _into(leaves[1 + n + j],
                                            t["exp_avg_sq"])})
        return GroupState(template.params, out, True,
                          template.scalar_on_device)
    if "keys" not in files:
        raise ValueError("opt-state frame has the Adam layout, the "
                         "template another optimizer's — peers are running "
                         "different optimizer recipes")
    names = [str(x) for x in data["keys"]]
    _leaf_count(len(files) - 1, len(names))
    want = sum(len(s) for s in template.state)
    if want:
        _leaf_count(len(names), want)
    out = [{} for _ in range(n)]
    for i, name in enumerate(names):
        j, key, *py = name.split(":")
        j = int(j)
        if not 0 <= j < n:
            raise ValueError(f"opt-state leaf {i} names parameter {j} of a "
                             f"group of {n} — peers are running different "
                             f"plans")
        a = data[f"a{i}"]
        if py:
            out[j][key] = a.item()
            continue
        t = template.state[j].get(key)
        if torch.is_tensor(t):
            _leaf_shape(i, a, t.shape)
            out[j][key] = _into(a, t)
            continue
        p = template.params[j]
        if a.ndim == 0:
            dev = (p.device if template.scalar_on_device[j]
                   else torch.device("cpu"))
            out[j][key] = torch.from_numpy(np.array(a)).to(dev)
        else:
            _leaf_shape(i, a, p.shape)
            out[j][key] = _like(a, p.dtype, p.device)
    return GroupState(template.params, out, False,
                      template.scalar_on_device)


def _into(a: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """A new tensor like ``t`` (dtype, device, memory format) holding
    ``a``."""
    out = torch.empty_like(t)
    out.copy_(_like(a, t.dtype, t.device).view(t.shape))
    return out


#: live-weight quantization: the balance greedy reads weights only as
#: ratios, and every replica must compute the same ones; rungs of 1/64 of
#: the largest absorb sub-percent counter skew between workers
_WEIGHT_BUCKETS = 64


def live_group_weights(plan: ShardedUpdatePlan, name: str,
                       registry=None) -> Optional[List[int]]:
    """A reshard's per-group weights from the live per-layer
    ``ps/push_bytes/<name>.<bucket label>`` counters (registered when the
    compression plane takes a bucket), quantized to ``_WEIGHT_BUCKETS``
    rungs of the largest, at least 1; None while no counter has moved (a
    cold registry, or dense PS, where the plane registers none: the
    static plan bytes then). Push counters only: every replica pushes
    every bucket, so under a pinned codec the counts agree across
    replicas, where the pull counts differ by ownership. Under
    ``BPS_COMPRESS=auto`` they differ too (``DistributedTrainer.reshard``
    passes none there)."""
    reg = registry if registry is not None else get_registry()
    names = reg.counters_with_prefix(("ps/push_bytes/",))
    raw = []
    for gi in range(len(plan.groups)):
        raw.append(sum(names.get(f"ps/push_bytes/{name}."
                                 f"{plan.bucket_labels[bi]}", 0)
                       for bi in plan.needed[gi]))
    top = max(raw, default=0)
    if top <= 0:
        return None
    return [max(1, round(_WEIGHT_BUCKETS * b / top)) if b else 1
            for b in raw]


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
        self.member_epoch = 1
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
                get_logger().warning(
                    "sharded update: rejoined a live job (retained param "
                    "frames found). This fresh plan is at member epoch 1: "
                    "if the job's membership epoch has moved, adopt the "
                    "current owner map before any reshard "
                    "(restore_sharded from a sharded checkpoint, or "
                    "adopt_membership); a reshard from a fresh plan would "
                    "diverge from the peers'")
                flight.record("member_join",
                              detail=f"rank {plan.rank} rejoined; param "
                                     f"seq resumed at {self._seq}")
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

    def reshard(self, chunked, live, weights=None,
                handoff_timeout_ms: Optional[int] = None) -> Dict:
        """A membership epoch: ownership re-planned over ``live``
        (``ShardedUpdatePlan.reshard``, kept owners staying) and each moved
        group's optimizer state handed to its new owner through the param
        mailbox; the gradient keys, the param keys and the server stay as
        they are. Every live replica calls it at the same step boundary,
        after draining (``DistributedTrainer.reshard``):

          1. each group this rank loses goes out as a state frame
             (``pack_opt_state``, key ``state_keys[gi]``, seq the new
             epoch);
          2. then each group it gains is fetched and adopted; a frame that
             does not come within ``handoff_timeout_ms`` (default
             ``BPS_PARAM_TIMEOUT_MS``: the old owner crashed) is logged
             and the group restarts from ``chunked.init_group``;
          3. the owned set flips, and the lost groups' state is freed.

        Returns ``{"member_epoch", "gained", "lost", "live"}``."""
        from .common.logging import get_logger
        plan = self.plan
        live = frozenset(int(r) for r in live)
        if live == plan.live:
            return {"member_epoch": self.member_epoch, "gained": (),
                    "lost": (), "live": sorted(live)}
        if chunked is None or not chunked.decomposable:
            raise RuntimeError(
                "reshard needs the engaged chunked sharded tail — run at "
                "least one step first")
        timeout = (self.timeout_ms if handoff_timeout_ms is None
                   else int(handoff_timeout_ms))
        new_plan = plan.reshard(live, weights=weights)
        epoch = self.member_epoch + 1
        before, after = plan.owned_set, new_plan.owned_set
        lost = tuple(sorted(before - after))
        gained = tuple(sorted(after - before))
        be = self.exchange.backend
        reg = get_registry()
        # 1. every rank publishes before it fetches: no wait cycle
        for gi in lost:
            payload = pack_opt_state(chunked.group_state(gi))
            be.param_put(plan.state_keys[gi], epoch, payload)
            reg.counter("ps/state_put_bytes").inc(len(payload))
            # no key: a dump filtered to the wedged keys keeps it
            flight.record("state_put", round=epoch, nbytes=len(payload),
                          detail=f"group {gi} opt-state handoff "
                                 f"(key {plan.state_keys[gi]:#x})")
        # 2. adopt the gained groups from their old owners' frames
        for gi in gained:
            template = chunked.init_group(gi)
            try:
                payload = be.param_get(plan.state_keys[gi], epoch,
                                       timeout_ms=timeout)
            except TimeoutError:
                get_logger().warning(
                    "reshard (member epoch %d): group %d's previous owner "
                    "(rank %s) never published its opt_state handoff "
                    "frame — crashed leave: the group's optimizer moments "
                    "restart from init (restore a sharded checkpoint for "
                    "a lossless takeover)", epoch, gi, plan.owner[gi])
                state = template
            else:
                reg.counter("ps/state_fetch_bytes").inc(len(payload))
                state = unpack_opt_state(payload, template)
            chunked.adopt_group(gi, state)
        # 3. flip ownership; free what was handed away only now
        chunked.set_owned(after)
        for gi in lost:
            chunked.release_group(gi)
        if plan.rank in plan.live and plan.rank not in live:
            flight.record("member_leave",
                          detail=f"rank {plan.rank} left the ownership "
                                 f"plan at member epoch {epoch}")
        elif plan.rank not in plan.live and plan.rank in live:
            flight.record("member_join",
                          detail=f"rank {plan.rank} joined the ownership "
                                 f"plan at member epoch {epoch}")
        flight.record("reshard",
                      detail=f"member epoch {self.member_epoch}->{epoch}: "
                             f"live={sorted(live)} gained={list(gained)} "
                             f"lost={list(lost)}")
        get_logger().info(
            "sharded update reshard: member epoch %d -> %d, live=%s, rank "
            "%d gained %s lost %s", self.member_epoch, epoch, sorted(live),
            plan.rank, list(gained), list(lost))
        self.plan = new_plan
        self.member_epoch = epoch
        return {"member_epoch": epoch, "gained": gained, "lost": lost,
                "live": sorted(live)}

    def adopt_membership(self, owner_map, member_epoch: int,
                         live=None) -> None:
        """Install the membership of a sharded checkpoint's meta (no
        handoff: the optimizer state comes from the checkpoint's slices).
        Runs before the chunked tail is built, so ownership and state
        agree."""
        self.plan = self.plan.with_owner_map(owner_map, live=live)
        self.member_epoch = int(member_epoch)
        flight.record("member_join",
                      detail=f"rank {self.plan.rank} adopted membership "
                             f"epoch {member_epoch} from checkpoint meta")

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
