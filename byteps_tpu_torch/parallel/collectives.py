"""Gradient synchronization: the port's push_pull (counterpart of
``byteps_tpu/parallel/collectives.py``: ``psum_reducer``,
``bucketed_allreduce`` and the eager ``PushPullEngine``).

What survives of the reference's 12-stage pipeline (reference:
common.h:88-102, core_loops.cc) in a data-parallel all-reduce:

  1. **Bucketing**: many small gradients fused into few fixed-byte buckets
     (``common/partition.py::plan_buckets``).
  2. **Priority order**: buckets communicated in reverse declaration order
     so the earliest-ready gradients go first (reference:
     scheduled_queue.cc:82-102).

Each bucket is one ``torch.distributed.all_reduce`` (NCCL on the card,
gloo on the CPU) on the data-parallel group, or one call of a custom
reducer: a ``Reducer``, ``reducer(buf, group) -> buf`` (the JAX package's
``Reducer``, which takes mesh axes where this one takes the group).

One bucket loop, ``reduce_buckets``, serves both callers:
``bucketed_allreduce``, in place, which the trainer's optimizer calls;
and ``PushPullEngine``, the BytePS API's engine (``bps.push_pull``,
handles, broadcasts), which returns new tensors.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common.naming import NameRegistry
from ..common.partition import Bucket, LeafSpec, plan_buckets
from ..obs.metrics import observe_stage
from .mesh import data_group, dp_size


Reducer = Callable[[torch.Tensor, Optional[object]], torch.Tensor]


def psum_reducer(buf: torch.Tensor, group) -> torch.Tensor:
    """Default reducer: an in-place sum over ``group`` (identity without
    one)."""
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def leaf_specs(tensors: Sequence[torch.Tensor],
               names: Optional[Sequence[str]] = None) -> List[LeafSpec]:
    names = names or [str(i) for i in range(len(tensors))]
    return [LeafSpec(name=n, size=t.numel(),
                     dtype=str(t.dtype).removeprefix("torch."))
            for n, t in zip(names, tensors)]


def _pack_bucket(flat: List[torch.Tensor], bucket: Bucket) -> torch.Tensor:
    parts = [flat[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length]
             for s in bucket.segments]
    return torch.cat(parts) if len(parts) > 1 else parts[0].clone()


def _unpack_bucket(buf: torch.Tensor, bucket: Bucket,
                   flat: List[torch.Tensor]) -> None:
    for s in bucket.segments:
        flat[s.leaf_index][s.leaf_offset:s.leaf_offset + s.length].copy_(
            buf[s.bucket_offset:s.bucket_offset + s.length])


def bucketed_allreduce(tensors: Sequence[torch.Tensor], group=None,
                       partition_bytes: int = 4 << 20, average: bool = True,
                       names: Optional[Sequence[str]] = None,
                       reducer: Optional[Reducer] = None) -> None:
    """Bucketed gradient all-reduce, IN PLACE on ``tensors``.

    Flattens the leaves, packs them into ~partition_bytes buckets in
    reverse declaration order, sums each bucket over ``group`` (default:
    the data group) or hands it to ``reducer``, divides by the group size
    when ``average``, and copies the result back: ``reduce_buckets``
    landing in the leaves themselves, on the caller's stream (the host
    does not wait for the card). At world 1 the plain sum has nothing to
    do and the call returns at once, as the JAX trainer drops size-1 axes
    (``training.py:337-342``); a custom reducer still runs there, with
    ``group`` None, as the JAX trainer keeps the axis for it.
    """
    if group is None:
        group = data_group()
    if not tensors or (dp_size(group) == 1 and reducer is None):
        return
    buckets = plan_buckets(leaf_specs(tensors, names), partition_bytes,
                           reverse_order=True)
    flat = [t.view(-1) for t in tensors]
    reduce_buckets(flat, buckets, group, average, outs=flat,
                   reducer=reducer).result(block=False)


# ---------------------------------------------------------------------------
# Trees: dicts, lists, tuples and named tuples, with the JAX package's paths
# ---------------------------------------------------------------------------

def _flatten(node, path: str, paths: List[str], leaves: list):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        # jax.tree_util: a dict's keys sorted, an OrderedDict's in order
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        return ("dict", type(node), tuple(keys), tuple(
            _flatten(node[k], f"{path}[{k!r}]", paths, leaves)
            for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ("named", type(node), tuple(
            _flatten(v, f"{path}.{f}", paths, leaves)
            for f, v in zip(node._fields, node)))
    if isinstance(node, (list, tuple)):
        return ("seq", type(node), tuple(
            _flatten(v, f"{path}[{i}]", paths, leaves)
            for i, v in enumerate(node)))
    paths.append(path)
    leaves.append(node)
    return ("leaf",)


def tree_flatten(tree) -> Tuple[List[str], list, tuple]:
    """``(paths, leaves, treedef)`` of ``tree``: leaves in
    ``jax.tree_util``'s order, each path as ``jax.tree_util.keystr``
    prints it for the same structure (``['w']``, ``[0]``, ``.field``), so
    names, and the keys declared from them, are the JAX engine's."""
    paths: List[str] = []
    leaves: list = []
    return paths, leaves, _flatten(tree, "", paths, leaves)


def tree_unflatten(treedef: tuple, leaves) -> object:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            vals = [build(c) for c in d[3]]
            cls = d[1] if d[1] in (dict, collections.OrderedDict) else dict
            return cls(zip(d[2], vals))
        vals = [build(c) for c in d[2]]
        return d[1](*vals) if kind == "named" else d[1](vals)
    return build(treedef)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Eager Horovod-style engine
# ---------------------------------------------------------------------------

def _block(work, cuda: bool) -> None:
    """Block the host until ``work`` completes. On the card ``wait`` only
    orders the current stream after the collective, so ask the work."""
    if not cuda:
        work.wait()
        return
    while not work.is_completed():
        time.sleep(20e-6)


class _Reduction:
    """One dispatched reduction of flat leaves: its bucket collectives in
    flight, and the output leaves they land in. On the card the landing
    (each work's stream wait, the average, the copies out) is enqueued at
    dispatch, on a side stream by default, so the caller's stream (the
    backward, for the plugin's hooks) never waits for a collective, and
    an event follows it. On the CPU gloo's ``wait`` blocks, so the
    landing waits for ``result``."""

    def __init__(self, outs: List[torch.Tensor], items: list, div: int,
                 cuda: bool, side_stream: bool = True) -> None:
        self.outs = outs
        self._items = items          # (work, bucket buffer, bucket)
        self._div = div
        self._event = None
        self._landed = False
        self._lock = threading.Lock()
        if cuda:
            cur = torch.cuda.current_stream(outs[0].device)
            side = torch.cuda.Stream(device=outs[0].device) \
                if items and side_stream else cur
            with torch.cuda.stream(side):
                self._land()
                self._event = torch.cuda.Event()
                self._event.record(side)
            if side is not cur:
                for t in outs:
                    t.record_stream(side)

    def _land(self) -> None:
        with self._lock:
            if self._landed:
                return
            for work, buf, b in self._items:
                work.wait()
                if self._div != 1:
                    buf.div_(self._div)
                _unpack_bucket(buf, b, self.outs)
                if buf.is_cuda:     # its memory stays the side stream's
                    buf.record_stream(torch.cuda.current_stream(buf.device))
            self._items = [(w, None, None) for w, _, _ in self._items]
            self._landed = True

    def done(self) -> bool:
        """True once every collective has completed and, on the card, the
        copies back have run."""
        if not all(w.is_completed() for w, _, _ in self._items):
            return False
        return self._event is None or self._event.query()

    def result(self, block: bool = True) -> List[torch.Tensor]:
        """The flat output leaves once the reduction has landed. On the
        card ``block`` waits for it on the host; without it only the
        caller's stream is ordered after the landing."""
        self._land()
        if self._event is not None:
            if block:
                self._event.synchronize()
            else:
                torch.cuda.current_stream(self.outs[0].device).wait_event(
                    self._event)
        return self.outs


class _Credit:
    """``BPS_SCHEDULING_CREDIT``'s byte budget for in-flight buckets
    (reference: scheduled_queue.cc:35-45): before a bucket goes out,
    dispatch waits on the oldest in-flight ones while their bytes exceed
    ``limit`` (the wait is observed as the ``CREDIT_BLOCK`` stage)."""

    def __init__(self, limit: int) -> None:
        self.limit = limit
        self._lock = threading.Lock()
        self._inflight: collections.deque = collections.deque()
        self._bytes = 0

    def wait(self, cuda: bool) -> None:
        with self._lock:
            while self._inflight and self._inflight[0][1].is_completed():
                self._bytes -= self._inflight.popleft()[0]
            if not (self._inflight and self._bytes > self.limit):
                return
        t0 = time.time()
        while True:
            with self._lock:
                if not (self._inflight and self._bytes > self.limit):
                    break
                nbytes, work = self._inflight.popleft()
                self._bytes -= nbytes
            _block(work, cuda)
        observe_stage("CREDIT_BLOCK", time.time() - t0)

    def admit(self, nbytes: int, work) -> None:
        with self._lock:
            self._inflight.append((nbytes, work))
            self._bytes += nbytes


class _Done:
    """The work of a reduction that ran in the caller (a custom
    reducer): already complete."""

    @staticmethod
    def wait() -> None:
        pass

    @staticmethod
    def is_completed() -> bool:
        return True


def reduce_buckets(flat: List[torch.Tensor], buckets: Sequence[Bucket],
                   group, average: bool = True,
                   outs: Optional[List[torch.Tensor]] = None,
                   credit: Optional[_Credit] = None,
                   reducer: Optional[Reducer] = None) -> _Reduction:
    """The bucket loop behind every all-reduce of the port: each bucket of
    the flat leaves ``flat`` packed and summed over ``group`` with one
    ``dist.all_reduce(..., async_op=True)``, or by ``reducer(buf,
    group)`` in the caller, in the order given; the landing divides by
    the group size when ``average`` and copies each bucket into ``outs``:
    new tensors by default, landed on a side stream; ``outs=flat``
    reduces in place, every bucket packed before any lands, on the
    caller's stream (the caller's next use of its leaves must follow it).
    With ``credit``, dispatch waits under its byte budget first. At world
    1 the plain sum launches nothing: the outputs hold the inputs; a
    custom reducer runs at every world."""
    n = dp_size(group)
    cuda = any(f.is_cuda for f in flat)
    if n == 1 and reducer is None:
        return _Reduction([f.clone() for f in flat] if outs is None
                          else outs, [], 1, cuda)
    if outs is None:
        outs = [torch.empty_like(f) for f in flat]
    items = []
    for b in buckets:
        if credit is not None:
            credit.wait(cuda)
        buf = _pack_bucket(flat, b)
        if reducer is not None:
            buf, work = reducer(buf, group), _Done()
        else:
            work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                                   async_op=True)
        items.append((work, buf, b))
        if credit is not None:
            credit.admit(b.nbytes, work)
    return _Reduction(outs, items, n if average else 1, cuda,
                      side_stream=outs is not flat)


class _Record:
    """An async handle's state (reference: handle_manager.cc)."""

    __slots__ = ("red", "treedef", "paths", "shapes", "t0", "nbytes",
                 "name", "hopped", "average")

    def __init__(self, red, treedef, paths, shapes, t0, nbytes,
                 name, average) -> None:
        self.red, self.treedef, self.paths = red, treedef, paths
        self.shapes, self.t0, self.nbytes = shapes, t0, nbytes
        self.name, self.hopped, self.average = name, None, average


class PushPullEngine:
    """Eager bucketed push_pull over the data-parallel group (reference
    API analogue: EnqueueTensor + queue pipeline, operations.cc:182-281;
    the port of ``byteps_tpu/parallel/collectives.py::PushPullEngine``).

    Input convention: one process per GPU, Horovod-style. Every leaf is
    THIS rank's tensor, and ``push_pull`` returns new tensors of the same
    shapes holding the sum (or mean) over the group. The JAX engine is
    single-controller and takes stacked ``[dp, ...]`` leaves instead;
    its buckets, priorities and key names are the same as here.

    A tree is flattened in ``jax.tree_util``'s order and its leaves are
    declared as ``"{name}." + keystr(path)``. One bucket plan is cached per
    tree structure: with every priority at its default (``-key``), the
    last-declared leaves go first (``reverse_order``); once any leaf was
    declared with a priority (``declare_tensor``), the registry's
    priorities order the buckets. Buckets go out in that order, each one
    ``dist.all_reduce(..., async_op=True)``.

    ``scheduling_credit`` (``BPS_SCHEDULING_CREDIT``, 0 = off): once the
    bytes of in-flight buckets exceed it, dispatch waits on the oldest
    until they fit (``_Credit``). Only the synchronous ``push_pull`` and
    the per-tensor dispatch of the torch plugin wait;
    ``push_pull_async`` returns at once.

    PS mode (``ps_factory`` set, ``BPS_ENABLE_PS``): after the group's
    reduction this rank's leaves go through the parameter-server
    exchange, which ``ps_factory`` builds at its first use, and come back
    summed over the ``ps_world`` worker processes, divided by it for the
    mean (``byteps_tpu/parallel/collectives.py:311-313``: the pulled sum,
    then ``/ ps_world`` on the host). ``push_pull_async`` declares
    the exchange's keys at dispatch and defers the exchange to
    ``synchronize``, which drains deferred exchanges in dispatch order.

    With no group (world 1) and no PS exchange, ``push_pull`` returns new
    tensors equal to its inputs and launches no collective.
    """

    def __init__(self, partition_bytes: int = 4 << 20,
                 registry: Optional[NameRegistry] = None,
                 telemetry: Optional[object] = None,
                 scheduling_credit: int = 0, debug_sample: str = "") -> None:
        self.partition_bytes = partition_bytes
        self.registry = registry or NameRegistry()
        self.telemetry = telemetry
        self.credit = _Credit(scheduling_credit) if scheduling_credit > 0 \
            else None
        self.debug_sample = debug_sample   # name substring to sample-log
        self.ps_factory = None
        self.ps_world = 1       # worker processes a PS sum spans
        self._ps_exchange = None
        self._ps_lock = threading.Lock()
        self._plans: Dict[tuple, List[Bucket]] = {}
        self._tensor_plans: Dict[tuple, List[Bucket]] = {}
        self._lock = threading.Lock()
        self._handles: Dict[int, _Record] = {}
        self._next_handle = 0
        self._ps_pending: List[int] = []   # deferred PS hops, dispatch order
        self._drain_lock = threading.Lock()

    @property
    def ps_exchange(self):
        """The PS exchange (None without PS), built at its first use: a
        PS run that trains through ``DistributedTrainer`` alone, with its
        own exchange, never builds this one."""
        if self._ps_exchange is None and self.ps_factory is not None:
            with self._ps_lock:
                if self._ps_exchange is None:
                    self._ps_exchange = self.ps_factory()
        return self._ps_exchange

    # -- plans -------------------------------------------------------------
    def _plan(self, paths, leaves, treedef, name) -> List[Bucket]:
        key = (treedef, name,
               tuple((tuple(t.shape), _dtype_name(t)) for t in leaves))
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                return plan
            prefix = f"{name}." if name else ""
            names = [prefix + p for p in paths]
            decls = [self.registry.declare(n) for n in names]
            specs = [LeafSpec(name=n, size=t.numel(), dtype=_dtype_name(t))
                     for n, t in zip(names, leaves)]
            prios = [d.priority for d in decls]
            if all(p == -d.declared_key for p, d in zip(prios, decls)):
                plan = plan_buckets(specs, self.partition_bytes,
                                    reverse_order=True)
            else:
                plan = plan_buckets(specs, self.partition_bytes,
                                    priorities=prios)
            self._plans[key] = plan
            return plan

    def _tensor_plan(self, t: torch.Tensor, name: str) -> List[Bucket]:
        key = (name, t.numel(), _dtype_name(t))
        plan = self._tensor_plans.get(key)
        if plan is None:
            plan = self._tensor_plans[key] = plan_buckets(
                [LeafSpec(name, t.numel(), _dtype_name(t))],
                self.partition_bytes)
        return plan

    # -- the reduction -------------------------------------------------------
    def _reduce(self, leaves: Sequence[torch.Tensor], buckets, avg: bool,
                credit: bool) -> _Reduction:
        """``reduce_buckets`` of ``leaves`` over the data group into new
        tensors; with ``credit``, under the scheduling credit."""
        return reduce_buckets([t.detach().reshape(-1) for t in leaves],
                              buckets, data_group(), avg,
                              credit=self.credit if credit else None)

    def reduce_tensor(self, tensor: torch.Tensor, average: bool,
                      name: str) -> _Reduction:
        """The torch plugin's collective: ``tensor``'s partitions summed
        over the group now, on the calling thread, under the credit."""
        return self._reduce([tensor], self._tensor_plan(tensor, name),
                            average, credit=True)

    # -- the PS hop and the sampler -------------------------------------------
    def _ps_hop(self, outs: List[torch.Tensor], paths, shapes,
                name: Optional[str], average: bool) -> List[torch.Tensor]:
        """PS mode's cross-worker hop (reference: PUSH/PULL after the
        local reduce, core_loops.cc:538-618): this rank's reduced leaves,
        in their shapes (the exchange's plan is keyed by them), through
        the host service; the sums (``average``: divided by ``ps_world``
        on the host) come back on the leaves' device."""
        summed = self.ps_exchange.exchange(
            [(p, o.view(s)) for p, o, s in zip(paths, outs, shapes)],
            name=name)
        if average and self.ps_world > 1:
            summed = [s / self.ps_world for s in summed]
        return [torch.from_numpy(np.ascontiguousarray(s)).reshape(-1)
                .to(o.device) for o, s in zip(outs, summed)]

    def _maybe_sample(self, outs, paths, name: Optional[str]) -> None:
        """Numeric debugging sampler (reference: BYTEPS_DEBUG_SAMPLE_TENSOR,
        core_loops.cc:37-67), on the final values."""
        if not (self.debug_sample and name and self.debug_sample in name):
            return
        from ..common.logging import get_logger
        for p, t in zip(paths, outs):
            arr = t.detach().float().cpu().numpy()
            get_logger().info("SAMPLE %s%s mean=%.6g std=%.6g first=%.6g",
                              name, p, arr.mean(), arr.std(), arr.ravel()[0])

    def _finish(self, outs, rec_t0: float, nbytes: int, paths, shapes,
                treedef, name):
        self._maybe_sample(outs, paths, name)
        if self.telemetry is not None:
            self.telemetry.record(nbytes, time.time() - rec_t0)
        return tree_unflatten(treedef, [o.reshape(s)
                                        for o, s in zip(outs, shapes)])

    # -- the API -------------------------------------------------------------
    def push_pull(self, tree, average: bool = True,
                  name: Optional[str] = None):
        """Reduce a tree of this rank's tensors; returns the same
        structure of new tensors holding the sum (or mean)."""
        t0 = time.time()
        paths, leaves, treedef = tree_flatten(tree)
        buckets = self._plan(paths, leaves, treedef, name)
        outs = self._reduce(leaves, buckets, average, credit=True).result()
        if self.ps_exchange is not None:
            outs = self._ps_hop(outs, paths, [t.shape for t in leaves],
                                name, average)
        return self._finish(outs, t0, sum(t.nbytes for t in leaves), paths,
                            [t.shape for t in leaves], treedef, name)

    def push_pull_async(self, tree, average: bool = True,
                        name: Optional[str] = None) -> int:
        """Dispatch the bucketed reduction; returns an int handle. Every
        handle must be synchronized, once. In PS mode the exchange's keys
        are declared now and the exchange itself runs at ``synchronize``,
        which drains all deferred exchanges in dispatch order, so workers
        may synchronize in different orders."""
        t0 = time.time()
        paths, leaves, treedef = tree_flatten(tree)
        buckets = self._plan(paths, leaves, treedef, name)
        red = self._reduce(leaves, buckets, average, credit=False)
        if self.ps_exchange is not None:
            self.ps_exchange.plan_for(list(zip(paths, leaves)), name=name)
        rec = _Record(red, treedef, paths, [t.shape for t in leaves], t0,
                      sum(t.nbytes for t in leaves), name, average)
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._handles[h] = rec
            if self.ps_exchange is not None:
                self._ps_pending.append(h)
        return h

    def poll(self, handle: int) -> bool:
        """True once the handle's reduction has completed (in PS mode the
        group's part: the exchange runs at ``synchronize``). Raises
        ``KeyError`` for a released handle."""
        with self._lock:
            rec = self._handles[handle]
        return rec.red.done()

    def _drain_ps_hops(self, handle: int) -> None:
        """Run deferred PS hops in dispatch order up to ``handle``. A
        handle leaves the queue only once its hop succeeded."""
        with self._drain_lock:
            while True:
                with self._lock:
                    if handle not in self._ps_pending:
                        return
                    rec = self._handles[self._ps_pending[0]]
                rec.hopped = self._ps_hop(rec.red.result(), rec.paths,
                                          rec.shapes, rec.name, rec.average)
                with self._lock:
                    self._ps_pending.pop(0)

    def synchronize(self, handle: int):
        """Block until the handle's reduction is done and return its tree;
        the handle is released (``KeyError`` on a second call)."""
        with self._lock:
            if handle not in self._handles:
                raise KeyError(handle)
        self._drain_ps_hops(handle)
        with self._lock:
            rec = self._handles.pop(handle)
        outs = rec.hopped if rec.hopped is not None else rec.red.result()
        return self._finish(outs, rec.t0, rec.nbytes, rec.paths, rec.shapes,
                            rec.treedef, rec.name)

    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   root_rank: int = 0) -> None:
        """Root's values into ``tensors`` on every rank, in place
        (``dist.broadcast``, bit for bit), in the given order."""
        group = data_group()
        if dp_size(group) == 1:
            return
        src = dist.get_global_rank(group, root_rank) \
            if group is not dist.group.WORLD else root_rank
        # NCCL moves only CUDA tensors: a CPU leaf (an optimizer's step
        # count) crosses through the current card
        nccl = dist.get_backend(group) == "nccl"
        for t in tensors:
            buf = t.detach()
            if nccl and not buf.is_cuda:
                buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
            elif not buf.is_contiguous():
                buf = buf.contiguous()
            dist.broadcast(buf, src=src, group=group)
            if buf.data_ptr() != t.data_ptr():
                with torch.no_grad():
                    t.copy_(buf)

    def broadcast(self, tree, root_rank: int = 0):
        """Root's tensors to every rank: a tree of new tensors (reference:
        broadcast_parameters, torch/__init__.py:259-291). Leaves that are
        not tensors pass through; at world 1 the tree comes back as is."""
        if dp_size() == 1:
            return tree
        paths, leaves, treedef = tree_flatten(tree)
        out = [t.detach().clone() if torch.is_tensor(t) else t
               for t in leaves]
        self.broadcast_([t for t in out if torch.is_tensor(t)], root_rank)
        return tree_unflatten(treedef, out)
