"""Cross-iteration barrier removal of the torch plugin (the port of
``byteps_tpu/torch/cross_barrier.py``).

Plain ``DistributedOptimizer.step()`` drains EVERY parameter's push_pull
before updating anything, so the next iteration's forward waits for the
slowest tensor. ``CrossBarrier`` removes that barrier the way the
reference's scheduled optimizer does (reference:
byteps/torch/cross_barrier.py:28-120, after the ByteScheduler paper):
per-parameter locks and a poller thread apply each parameter's update the
moment ITS reduction lands, and forward pre-hooks on the modules block
only on the parameters that module reads — the next forward starts while
late gradients are still in flight.

As in the JAX package's version, each parameter gets a CHILD instance of
the user's own optimizer class (sharing the parent's ``state``, so
``broadcast_optimizer_state`` and checkpoints see one source of truth)
and the poller calls its ``step()``: any optimizer, live hyper-parameter
changes mirrored each update. ``flush()`` blocks until every in-flight
update is applied.

A module's parameters are gated at its forward pre-hook only if its
forward runs: the port's transformer keeps its layers' weights stacked
in one module that its parent reads, so the first forward seen records
which modules run, and each silent module's parameters move to the
nearest ancestor that does (the JAX package's version gates at the
owning module only).

A PS exchange lands on the poller's queue from its future's callback, in
completion order. A collective reduction is queued at dispatch: the
collectives of one group complete in the order they were issued, so the
poller, waiting on each in turn, applies them as they land.

Usage (reference-compatible)::

    opt = bps.DistributedOptimizer(opt, named_parameters=...)
    opt = bps.CrossBarrier(model, opt, num_steps)
    ...
    loss.backward()
    opt.step()        # returns at once; the poller applies the updates
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Optional

import torch

from .ops import _Dispatcher, size, synchronize

__all__ = ["CrossBarrier", "ForwardGates"]


class ForwardGates:
    """Forward pre-hooks that hold each module's forward until the
    parameters it owns may be read: ``wait(params)`` runs at the pre-hook
    of every module owning some of ``params``.

    A module whose forward never runs (one whose parameters its parent
    reads, such as the port's stacked layer weights) gates nothing: the
    first forward seen records which modules run, and ``learn()`` then
    moves each silent module's parameters to the nearest ancestor that
    ran; parameters with no such ancestor, or owned by no module, are
    ``ungated`` and their owner must wait for them another way. The
    plugin's ``CrossBarrier`` and the trainer's cross-step driver
    (``byteps_tpu_torch/cross_step.py``) share this mechanism."""

    def __init__(self, model: torch.nn.Module, params, wait) -> None:
        params = set(params)
        self._wait = wait
        self._gates = {}
        self._parent = {}
        self._seen: Optional[set] = set()
        for mod in model.modules():
            for child in mod.children():
                self._parent.setdefault(child, mod)
            self._gates[mod] = [p for p in mod.parameters(recurse=False)
                                if p in params]

        me = weakref.ref(self)      # the modules keep no gates alive

        def pre_hook(mod, inputs):
            gates = me()
            if gates is not None:
                gates._pre_hook(mod)

        self._handles = [mod.register_forward_pre_hook(pre_hook)
                         for mod in model.modules()]
        covered = {p for ps in self._gates.values() for p in ps}
        self.ungated = params - covered

    def _pre_hook(self, mod) -> None:
        if self._seen is not None:
            self._seen.add(mod)
        gated = self._gates.get(mod)
        if gated:
            self._wait(gated)

    @property
    def learned(self) -> bool:
        return self._seen is None

    def learn(self) -> bool:
        """After the first forward seen: move each parameter of a module
        that did not run to the nearest ancestor that did (with none, it
        joins ``ungated``). False while no forward was seen yet."""
        if self._seen is None:
            return True
        if not self._seen:
            return False
        ungated = set(self.ungated)
        for mod, params in self._gates.items():
            if mod in self._seen or not params:
                continue
            up = self._parent.get(mod)
            while up is not None and up not in self._seen:
                up = self._parent.get(up)
            if up is None:
                ungated.update(params)
            else:
                self._gates[up] = self._gates[up] + params
            self._gates[mod] = []
        self._seen = None
        self.ungated = ungated
        return True

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


class CrossBarrier:
    """Wraps a ``byteps_tpu_torch.torch.DistributedOptimizer`` (and the model
    whose parameters it owns) with per-parameter cross-iteration
    scheduling. See module docstring."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 num_steps: int = 10 ** 6) -> None:
        if getattr(optimizer, "_enable_async", False):
            # byteps_tpu/torch/cross_barrier.py:57-59
            raise ValueError("CrossBarrier is a sync-mode scheduler; "
                             "async-PS mode has no barrier to cross")
        self._model = model
        self._opt = optimizer
        self._step_count = 0
        self._final_step = num_steps
        self._locks = {p: threading.Lock()
                       for g in optimizer.param_groups for p in g["params"]}
        self._child = {}          # param -> single-param child optimizer
        self._child_group = {}    # param -> its group in the PARENT
        # the user's optimizer class: the parent is a dynamic subclass
        # created by DistributedOptimizer, so its immediate base is the
        # real torch optimizer class
        self._user_cls = type(optimizer).__mro__[1]
        for g in optimizer.param_groups:
            for p in g["params"]:
                self._child_group[p] = g
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._error = None
        self._poller = None
        self._ungated: set = set()
        self._gates = None
        if size() > 1:
            # intercept the parent's dispatch: every push_pull now also
            # takes the param's lock and lands on the poller's queue
            self._orig_dispatch = optimizer._push_pull_grad_async
            optimizer._push_pull_grad_async = self._dispatch
            self._gates = ForwardGates(model, self._locks, self._wait_params)
            self._set_ungated(self._gates.ungated)
            self._poller = threading.Thread(target=self._poll_loop,
                                            daemon=True,
                                            name="bps-cross-barrier")
            self._poller.start()

    # -- attribute delegation (param_groups, state, zero_grad target...) --

    def __getattr__(self, item):
        return getattr(self._opt, item)

    # -- dispatch + per-parameter completion ------------------------------

    def _dispatch(self, p):
        """Replaces the parent's ``_push_pull_grad_async``: the same
        reduction, plus the forward-blocking lock and the poller's queue.
        Hyper-parameters are snapshotted here: the poller may apply this
        update after the user changed lr for the next step, and the update
        must use the values in force when its gradient was produced."""
        self._locks[p].acquire()
        try:
            g = self._child_group[p]
            hyper = {k: v for k, v in g.items() if k != "params"}
            handle, ctx = self._orig_dispatch(p)
            item = (p, handle, ctx, hyper)
            pending = (None if handle is None
                       else _Dispatcher.peek(handle)[0])
            if hasattr(pending, "add_done_callback"):
                pending.add_done_callback(
                    lambda _f, _item=item: self._queue.put(_item))
            else:
                self._queue.put(item)
        except BaseException:
            # a leaked lock would hang the next forward forever
            self._locks[p].release()
            raise
        return handle, ctx

    def _child_opt(self, p, hyper):
        child = self._child.get(p)
        if child is None:
            # hyperparams ride in the group dict, not constructor kwargs:
            # groups may carry keys that aren't __init__ args (e.g.
            # AdamW's decoupled_weight_decay)
            child = self._user_cls([{"params": [p], **hyper}])
            self._child[p] = child
        else:
            child.param_groups[0].update(hyper)
        # ONE state table: momentum/exp_avg buffers live in the parent,
        # so broadcast_optimizer_state / state_dict see them. Re-bound
        # on EVERY update because torch's load_state_dict REPLACES the
        # parent's state dict — a cached reference would silently keep
        # updating the pre-checkpoint buffers
        child.state = self._opt.state
        return child

    def _poll_loop(self):
        """Applier loop: synchronize → decompress → child step for each
        queued item (a PS item's exchange has already landed; a
        collective's lands in issue order)."""
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            p, handle, ctx, hyper = item
            try:
                if handle is not None:
                    out = synchronize(handle)
                    with torch.no_grad():
                        p.grad.copy_(
                            self._opt._compression.decompress(out, ctx))
                self._opt._push_pull_delay[p] = \
                    self._opt.backward_passes_per_step
                self._child_opt(p, hyper).step()
                # None, not zero_(): serial training's default
                # zero_grad(set_to_none=True) leaves unused params'
                # grads None so torch SKIPS their update — a zeroed
                # (non-None) grad would be re-dispatched every step and
                # momentum/weight-decay would keep moving the param
                p.grad = None
                # drop the parent's stale handle entry so the next
                # backward's hook doesn't trip on an already-applied
                # exchange (safe: the hook can only write a NEW entry
                # from _dispatch, which blocks on the lock we hold)
                if self._opt._handles.get(p, (None,))[0] is handle:
                    self._opt._handles.pop(p, None)
            except BaseException as e:   # noqa: BLE001 — re-raised on the
                # training thread via step/flush. Restore dispatchability
                # first: a delay stuck at 0 (or
                # a live grad) would raise the misleading "more than
                # backward_passes_per_step" assertion on the NEXT
                # backward before step() could surface the real error
                self._opt._push_pull_delay[p] = \
                    self._opt.backward_passes_per_step
                p.grad = None
                self._error = e
            finally:
                self._locks[p].release()

    # -- forward blocking --------------------------------------------------

    def _wait_params(self, params) -> None:
        """A module's forward may read ``params`` once their in-flight
        updates were applied (the poller releases each lock)."""
        for p in params:
            self._opt._handles.pop(p, None)
            with self._locks[p]:
                pass

    def _learn_gates(self) -> None:
        """After the first forward seen: silent modules' parameters move
        to the nearest ancestor that ran (``ForwardGates.learn``)."""
        if self._gates.learn():
            self._set_ungated(self._gates.ungated)

    def _set_ungated(self, ungated: set) -> None:
        """Parameters no forward pre-hook gates (functional use, tied
        weights, no module that runs): their backward hook can fire while
        the last step's update is still in flight, so a wrapped backward
        hook waits for it first — correct, at the cost of blocking the
        backward on that one parameter's update."""
        if ungated == self._ungated:
            return
        self._ungated = ungated
        opt = self._opt
        for h in opt._hook_handles:
            h.remove()
        opt._hook_handles = []
        inner = opt._make_hook()

        def gated_hook(p):
            if p in self._ungated:
                with self._locks[p]:    # in-flight update applied
                    pass
                opt._handles.pop(p, None)
            inner(p)

        for g in opt.param_groups:
            for p in g["params"]:
                if p.requires_grad:
                    opt._hook_handles.append(
                        p.register_post_accumulate_grad_hook(gated_hook))

    # -- optimizer surface -------------------------------------------------

    def step(self, closure=None):
        """Dispatch any parameters whose hooks never fired, then return
        WITHOUT waiting — per-parameter updates land in the poller."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        # in-flight exchanges (locks held from dispatch until the poller
        # applies) mean the scheduled path MUST run, even at step 0: the
        # documented usage has no bare init step, and a plain local
        # update here would race the poller's averaged update
        inflight = any(l.locked() for l in self._locks.values())
        if self._gates is not None and not self._gates.learned:
            self._learn_gates()
        if size() > 1 and (self._step_count > 0 or inflight):
            opt = self._opt
            missing = {p for p in opt._requires_update - set(opt._handles)
                       if p.grad is not None}
            # in forward order: a collective goes out in dispatch order,
            # which must be the same on every rank
            for p in sorted(missing, key=opt._param_index.get):
                opt._handles[p] = opt._push_pull_grad_async(p)
            for p, (handle, ctx) in list(opt._handles.items()):
                if handle is None:
                    opt._handles[p] = opt._push_pull_grad_async(p)
            # ungated params (no owning-module forward to gate): the
            # next forward reads them with NO lock, so their in-flight
            # updates must land before step() returns — overlap is kept
            # for every module-gated param
            for p in self._ungated:
                lock = self._locks.get(p)
                if lock is not None:
                    with lock:
                        pass
            loss = closure() if closure is not None else None
            self._step_count += 1
            if self._step_count >= self._final_step:
                self.flush()
            return loss
        # step 0 (parameter-broadcast init) or single worker: plain step
        loss = self._user_cls.step(self._opt, closure)
        self._step_count += 1
        return loss

    def zero_grad(self, set_to_none: bool = True):
        """No-op after step 1: the poller zeroes each grad right after
        its per-parameter update (zeroing here would race in-flight
        exchanges)."""
        if size() <= 1 or self._step_count == 0:
            self._opt.zero_grad(set_to_none=set_to_none)

    def flush(self, timeout: float = 60.0):
        """Block until every in-flight exchange has been applied — use
        at eval boundaries, checkpoints, or end of training."""
        deadline = time.time() + timeout
        while not self._queue.empty():
            if time.time() > deadline:
                raise TimeoutError("cross-barrier flush timed out")
            time.sleep(0.001)
        # queue empty means *taken*, not applied: grab every lock once
        for p, lock in self._locks.items():
            if not lock.acquire(timeout=max(0.0, deadline - time.time())):
                raise TimeoutError("cross-barrier flush timed out")
            lock.release()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        """Stop the poller (flushes first)."""
        if self._poller is not None:
            self.flush()
            self._stop.set()
            self._queue.put(None)
            self._poller.join(timeout=10)
            self._poller = None
