"""Tensor push_pull ops of the torch plugin (the port of
``byteps_tpu/torch/ops.py``; reference: torch/ops.py:48-236 +
handle_manager.{cc,h} — int handles over in-flight reductions).

Where the reduction runs decides how it is started:

  - **Parameter server** (``BPS_ENABLE_PS``): as in the JAX plugin, a
    handle wraps a future on a priority-scheduled pool (``_Dispatcher``):
    dispatch returns at once, ``BPS_TORCH_CHANNELS`` push workers start
    ``PSGradientExchange.exchange_async`` lowest-priority-value first,
    and pull workers drain the pulls, so a blocked pull never keeps a
    push off the wire. Start order across workers may differ: the server
    matches pushes per key, as ps-lite does.
  - **Collective** (NCCL between cards, gloo on the CPU): every rank
    must issue the same collectives in the same order, and a pool would
    reorder them. So the collective is issued on the dispatching thread,
    in dispatch order: the hooks' order, which autograd makes the same
    on every rank. ``priority`` does not reorder it — ranks may pass
    different priorities — and ``BPS_SCHEDULING_CREDIT`` bounds the bytes
    in flight by making dispatch wait on the oldest reduction.

Anything order-sensitive (name→key declaration, the exchange's key plan)
happens on the dispatching thread in ``_dispatch``."""

from __future__ import annotations

import heapq
import os
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.global_state import GlobalState


def init(config=None, **kwargs) -> None:
    """``bps.init()`` for torch scripts: the port's ``init`` (``device``,
    ``init_method`` and ``timeout`` pass through)."""
    from .. import init as _init
    _init(config=config, **kwargs)


def shutdown() -> None:
    from .. import shutdown as _shutdown
    _Dispatcher.reset()
    _shutdown()


def size() -> int:
    """World size: the data-parallel processes, one per GPU. In PS mode,
    which joins no process group, the worker processes
    (``BPS_NUM_WORKER``), as the JAX plugin counts them."""
    if GlobalState.initialized() and GlobalState.get().config.enable_ps:
        return GlobalState.get().config.num_worker
    from .. import size as _size
    return _size()


def rank() -> int:
    from .. import rank as _rank
    return _rank()


def local_rank() -> int:
    from .. import local_rank as _local_rank
    return _local_rank()


def local_size() -> int:
    from .. import local_size as _local_size
    return _local_size()


def declare(name: str, **kwargs) -> None:
    """Pre-declare a tensor (priority / compression kwargs — reference:
    byteps_declare_tensor)."""
    GlobalState.get().registry.declare(name, **kwargs)


def declare_model_keys(names) -> None:
    """Declare ``Gradient.*`` then ``Parameter.*`` keys for a model's
    parameter names, each loop sorted (reference: torch/__init__.py:95-100),
    as the JAX plugin does: the same names get the same PS keys and the
    same fp8 noise seeds."""
    reg = GlobalState.get().registry
    for name in sorted(names):
        reg.declare("Gradient." + name)
    for name in sorted(names):
        reg.declare("Parameter." + name)


# the keys each backend's store was seeded under by async_param_exchange:
# a fresh backend (a new init) is seeded again
_async_inited: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def async_param_exchange(name: str, delta: np.ndarray,
                         init: np.ndarray) -> np.ndarray:
    """The async-PS exchange of one parameter (``byteps_tpu/torch/ops.py:
    309-326``): seed the store with ``init`` the first time (the server
    keeps the first worker's values, every worker seeds alike), push the
    weight ``delta`` (its dtype is the wire's; the server casts it into
    the store), pull the store's weights as they are (an async pull never
    waits)."""
    gs = GlobalState.get()
    be = gs.ps_backend
    key = gs.registry.declare(name).key_for_partition(0)
    inited = _async_inited.setdefault(be, set())
    if key not in inited:
        init = np.ascontiguousarray(init)
        be.init_key(key, init.nbytes, str(init.dtype), init=init)
        inited.add(key)
    be.push(key, np.ascontiguousarray(delta))
    out = np.empty(init.size, init.dtype)
    be.pull(key, out)
    return out.reshape(init.shape)


class _Dispatcher:
    """Process-wide handle table, and the PS path's priority pool.

    The pool (``BPS_TORCH_CHANNELS`` push workers, default 4, and as many
    pull workers) drains pending exchanges in priority order (lower value
    first, ties FIFO): backward produces the last layer's gradient first,
    but the next forward needs the first layer's parameters first, so the
    optimizer gives each parameter its forward position as priority.
    Collective handles skip the pool: they are in flight at ``put``."""

    _lock = threading.Lock()
    # handle -> (pending, tensor, in place, dispatch time)
    _handles: Dict[int, Tuple[object, torch.Tensor, bool, float]] = {}
    _next = 0
    _noname = 0
    _pq: Optional[list] = None      # heap of (priority, seq, start, fut)
    _cv: Optional[threading.Condition] = None
    _pullq = None                   # queue of (resolver, fut)
    _threads: list = []
    _stop_evt: Optional[threading.Event] = None   # per pool generation

    @classmethod
    def _ensure_pool(cls) -> None:
        with cls._lock:
            if cls._pq is not None:
                return
            cls._pq = []
            cls._cv = threading.Condition()
            cls._pullq = queue.Queue()
            cls._stop_evt = threading.Event()
            width = max(1, int(os.environ.get("BPS_TORCH_CHANNELS", "4")))
            cls._threads = [
                threading.Thread(target=cls._push_worker, daemon=True,
                                 args=(cls._pq, cls._cv, cls._pullq,
                                       cls._stop_evt),
                                 name=f"bps-torch-push-{i}")
                for i in range(width)]
            cls._threads += [
                threading.Thread(target=cls._pull_worker, daemon=True,
                                 args=(cls._pullq,),
                                 name=f"bps-torch-pull-{i}")
                for i in range(width)]
            for t in cls._threads:
                t.start()

    @classmethod
    def _push_worker(cls, pq: list, cv: threading.Condition, pullq,
                     stop: threading.Event) -> None:
        # pq/cv/stop are this pool generation's own: reset() swaps the
        # class attributes for a fresh pool while these drain. A push
        # worker only starts an exchange (its pushes are in flight when
        # start() returns); the pulls drain on the pull workers, so pushes
        # never queue behind pulls (reference: free-running push and pull
        # loops, core_loops.cc:538-618)
        while True:
            with cv:
                while not pq and not stop.is_set():
                    cv.wait()
                if stop.is_set():
                    return
                _, _, start, fut = heapq.heappop(pq)
            try:
                resolver = start()
            except BaseException as e:   # noqa: BLE001 — via the future
                fut.set_exception(e)
                continue
            pullq.put((resolver, fut))

    @classmethod
    def _pull_worker(cls, pullq) -> None:
        while True:
            item = pullq.get()
            if item is None:
                return
            resolver, fut = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(resolver())
            except BaseException as e:   # noqa: BLE001 — via the future
                fut.set_exception(e)

    @classmethod
    def submit(cls, start, out: torch.Tensor, inplace: bool,
               priority: int = 0) -> int:
        """``start`` runs on a push worker and returns a resolver whose
        call (on a pull worker) yields the reduced tensor."""
        fut: Future = Future()
        while True:
            cls._ensure_pool()
            with cls._lock:
                if cls._pq is None:
                    continue   # reset() raced _ensure_pool; rebuild
                # enqueue under cls._lock: reset() swaps the generation
                # under the same lock, so the exchange cannot land on a
                # retired queue
                h = cls._next
                cls._next += 1
                cls._handles[h] = (fut, out, inplace, time.time())
                with cls._cv:
                    heapq.heappush(cls._pq, (priority, h, start, fut))
                    cls._cv.notify()
                return h

    @classmethod
    def put(cls, pending, out: torch.Tensor, inplace: bool) -> int:
        """A handle for a reduction already in flight."""
        with cls._lock:
            h = cls._next
            cls._next += 1
            cls._handles[h] = (pending, out, inplace, time.time())
            return h

    @classmethod
    def _lookup(cls, handle: int, pop: bool):
        with cls._lock:
            try:
                return (cls._handles.pop(handle) if pop
                        else cls._handles[handle])
            except KeyError:
                raise RuntimeError(
                    f"unknown push_pull handle {handle} — already "
                    "synchronized, or the dispatcher was reset/"
                    "shut down") from None

    @classmethod
    def take(cls, handle: int):
        return cls._lookup(handle, pop=True)

    @classmethod
    def peek(cls, handle: int):
        return cls._lookup(handle, pop=False)

    @classmethod
    def auto_name(cls) -> str:
        with cls._lock:
            n = cls._noname
            cls._noname += 1
        return f"push_pull.noname.{n}"

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            threads, cls._threads = cls._threads, []
            cv, cls._cv = cls._cv, None
            pullq, cls._pullq = cls._pullq, None
            stop, cls._stop_evt = cls._stop_evt, None
            pq, cls._pq = cls._pq, None
            handles = dict(cls._handles)
            cls._handles.clear()
        if cv is None:
            return
        with cv:
            stop.set()            # this generation's flag only
            cv.notify_all()
        for _ in threads:
            pullq.put(None)       # wake and stop the pull workers
        for t in threads:
            t.join(timeout=5)
        # push workers exit on stop without draining: fail the exchanges
        # still queued, and keep their handles so synchronize() raises
        # this error rather than an unknown-handle one
        with cv:
            leftovers, pq[:] = list(pq), []
        for _, h, _, f in leftovers:
            if not f.done():
                f.set_exception(RuntimeError(
                    "push_pull dispatcher was shut down before this "
                    "exchange started"))
                if h in handles:
                    with cls._lock:
                        cls._handles.setdefault(h, handles[h])


def _exchange_start(ex, pairs, name: str, device: torch.device,
                    average: bool, world: int):
    """Start one tensor's PS exchange: its pushes are in flight when this
    returns; the returned resolver (run on a pull worker) waits for the
    merged sum, divides it by the ``world`` worker processes on the host
    for ``average`` (``byteps_tpu/torch/ops.py:285-304``) and puts it on
    ``device``."""
    pend = ex.exchange_async(pairs, name=name)

    def resolve() -> torch.Tensor:
        out = pend.result()[0]
        if average and world > 1:
            out = out / world
        return torch.from_numpy(np.ascontiguousarray(out)).to(device)
    return resolve


def _dispatch(tensor: torch.Tensor, average: bool, name: Optional[str],
              inplace: bool, priority: int = 0) -> int:
    if name is None:
        name = _Dispatcher.auto_name()
    # declare on the dispatching thread: keys follow declaration order,
    # and every worker dispatches in the same order (same model, same
    # hooks); on the pool's racing workers the same name could get
    # different keys on different workers
    gs = GlobalState.get()
    gs.registry.declare(name)
    eng = gs.engine
    ex = eng.ps_exchange
    if ex is None:
        return _Dispatcher.put(eng.reduce_tensor(tensor, average, name),
                               tensor, inplace)
    # snapshot: later in-place changes of the tensor do not reach the
    # exchange; the exchange's keys are planned here, in dispatch order
    pairs = [("['t']", tensor.detach().clone())]
    ex.plan_for(pairs, name=name)
    device = tensor.device
    world = eng.ps_world

    def start():
        return _exchange_start(ex, pairs, name, device, average, world)

    return _Dispatcher.submit(start, tensor, inplace, priority=priority)


def push_pull_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None, priority: int = 0) -> int:
    """Dispatch a reduction of ``tensor``; returns an int handle. The
    input is snapshotted — later in-place changes don't affect the
    reduction; ``synchronize`` returns a NEW tensor. A lower ``priority``
    starts first on the PS pool when its channels are busy (the
    reference's BYTEPS_SCHEDULING priority); a collective is issued at
    once."""
    return _dispatch(tensor, average, name, inplace=False,
                     priority=priority)


def push_pull_async_inplace(tensor: torch.Tensor, average: bool = True,
                            name: Optional[str] = None,
                            priority: int = 0) -> int:
    """Like ``push_pull_async``, but ``synchronize`` writes the result
    back INTO ``tensor`` (reference: the default gradient path)."""
    return _dispatch(tensor, average, name, inplace=True,
                     priority=priority)


def poll(handle: int) -> bool:
    """True once the handle's reduction has completed."""
    return _Dispatcher.peek(handle)[0].done()


def synchronize(handle: int) -> torch.Tensor:
    """Block until the reduction is done; return its result (``tensor``
    itself, written in place, for an in-place handle). With
    ``BPS_TELEMETRY_ON`` the tensor's bytes count towards
    ``get_pushpull_speed``, as every push_pull does in the reference's
    core (global.cc:697-752)."""
    pending, tensor, inplace, t0 = _Dispatcher.take(handle)
    out = pending.result()
    if isinstance(out, list):           # a collective's flat outputs
        out = out[0]
    telemetry = GlobalState.get().telemetry
    if telemetry is not None:
        telemetry.record(tensor.nbytes, time.time() - t0)
    result = out.reshape(tensor.shape).to(tensor.dtype)
    if inplace:
        with torch.no_grad():
            tensor.copy_(result)
        return tensor
    return result


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None) -> torch.Tensor:
    """Synchronous reduce; returns a new tensor (reference: torch/ops.py
    push_pull)."""
    return synchronize(push_pull_async(tensor, average=average, name=name))
