"""Cross-step driver of the PS trainer: gated fwd/bwd(k+1) ∥ straggler
pull/apply(k) (the port of ``byteps_tpu/cross_step.py``).

BytePS's cross-barrier lets parameters unblock one by one, so the next
iteration's forward starts while late gradients are still in flight (the
ByteScheduler design the reference ships as ``bps.CrossBarrier``).
``CrossStepDriver`` makes the trainer's ``step()`` non-draining while keeping
exact sync-SGD semantics:

  - step k's tail (pull -> H2D -> per-group optimizer apply) runs on a
    background thread; the trainer's H2D stager divides each pulled sum by
    the worker processes first, the JAX driver's ``/ world``
    (``byteps_tpu/cross_step.py:74``); after each group's apply is
    enqueued and its CUDA
    event recorded, ``ChunkedApply`` publishes the group's leaves in its
    per-leaf readiness EPOCH table;
  - step k+1's forward is gated per module by forward pre-hooks
    (``torch/cross_barrier.py::ForwardGates``, the plugin's mechanism):
    a module's forward waits until the leaves it reads reached epoch k on
    the host, then its stream waits on those groups' apply events on the
    device (``PS_XSTEP_GATE`` measures the stall); leaves no module's
    forward gates are waited for before the forward starts;
  - the exchange admits step k+1's pushes while step k's straggler pulls
    are outstanding (at K=1 the depth-1 ``KeyGate`` keeps the server's
    one published round per key exact), and landed buckets are pulled by
    next-step first-use priority (``PullQueue``); the tail applies complete
    groups input side first.

Bit-exactness: a forward of step k+1 reads a leaf only after its step-k
apply was enqueued (host gate) and ordered before the read (device event),
and never after its step-k+1 apply, because step k+1's tail starts only once
its backward has run; the applies are the same per-group steps in the same
per-group order (a tail waits for the previous step's apply of each group),
so the trajectory is the draining step's bit for bit (at K=1).
``BPS_CROSS_STEP=0`` restores the draining step.

The port's transformer stacks its layers' weights on a leading axis in
modules whose forward never runs, so the gates of those leaves move to the
model's root: the next forward starts once the whole previous tail was
applied. That granularity is the model's; the JAX package cuts its forward
at bucket-group boundaries instead.

Bounded staleness (``BPS_MAX_LAG=K`` > 1, ``byteps_tpu/cross_step.py:88-96``):
step e's readers wait for epoch ``plane.gate_round(e) = e - K`` instead of
``e - 1``, so up to K rounds ride the server at once and a straggler costs
lag rather than wall-clock; tails still apply in step order. The JAX
package's arrays are immutable, so its forward of step e reads each leaf
as some whole epoch however the tail e-1 runs. The port's applies write
the parameters in place, so at K > 1 the tail applies only outside the
forward and backward: the driver holds a compute lock from the gate
through the end of the backward, and each group's apply and epoch mark
run under it. Every leaf a forward reads therefore holds one epoch in
[e-K, e-1] for the whole step, the same one in the forward and in the
backward, and no apply touches a tensor autograd saved (which would be a
version-counter error, or, through a swapped storage, a silently wrong
gradient). A tail blocked on the lock keeps landing its leaves on the
card; the cost is those gradients, up to one fp32 copy of the parameters,
held on the card until the backward ends (1.34 GB for BERT-large), and no
second copy of the parameters. The gate itself waits at the root: every
leaf before the forward, outside the lock. At K=1 none of this runs, and
the step is unchanged.

Under the sharded weight update (``sharded_update.py``) a tail runs
``ShardedUpdateState.run_tail`` with the round's view: owned groups are
pulled, applied and published, the others installed from their owners'
frames, and a fetched group marks the same epoch an applied one does (the
install is ordered on the forward's stream, its event is the group's
apply event). The epoch counter continues the trainer's: its first,
draining step already marked epoch 1 (``byteps_tpu/cross_step.py:81-86``).
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time
import weakref
from typing import List

import torch

from .obs.metrics import get_registry, observe_stage


class CrossStepDriver:
    """The cross-step pipeline of one PS-mode ``DistributedTrainer``.

    Built after the trainer's first (draining) step has built its
    ``ChunkedApply``; from then on every step of the trainer's staged
    route runs through ``step()``. ``drain()`` joins the outstanding
    tails; a tail's failure poisons the trainer until fresh state is
    installed (``supersede``)."""

    def __init__(self, trainer, ungated: List[int]) -> None:
        # a proxy: the trainer owns the driver, not the other way round
        self._tr = weakref.proxy(trainer)
        self._chunked = trainer._chunked
        self._ex = trainer.ps_exchange
        self._ungated = sorted(ungated)
        # a draining sharded step already marked its epoch: continue it
        self._epoch = trainer._sharded_epoch
        # bounded staleness: the readers of step e wait for epoch
        # gate_round(e) (e - 1 at K=1); at K > 1 the applies and the
        # forward/backward exclude each other (module docstring)
        plane = self._ex.plane
        self._gate_round = plane.gate_round
        self._compute = (threading.Lock() if plane.max_lag > 1 else None)
        self._tails: List[threading.Thread] = []
        self._err = None             # (exc, applied groups, epoch)
        self._err_lock = threading.Lock()
        self._dirty = False

    # ------------------------------------------------------- lifecycle

    @property
    def busy(self) -> bool:
        """True while any step's tail is still pulling or applying."""
        return any(t.is_alive() for t in self._tails)

    @property
    def pending(self) -> bool:
        """True when cross steps ran since the last drain."""
        return bool(self._tails)

    @property
    def failed(self) -> bool:
        """True once a tail died: the weights are partially stepped, and
        every synchronization point keeps raising."""
        return self._err is not None

    def join(self) -> None:
        """Join the outstanding tails without raising their failure."""
        for t in list(self._tails):
            t.join()
        self._tails = []

    def supersede(self) -> None:
        """Fresh state is about to be installed (a restore, the remedy for
        a failed tail): join the tails without raising, lift the poison,
        and mark every leaf ready at the current epoch before the next
        step."""
        self.join()
        with self._err_lock:
            self._err = None
        self._dirty = True

    def drain(self) -> None:
        """The explicit barrier: join every outstanding tail; raise the
        first tail failure."""
        self.join()
        self._check_err()

    def _check_err(self) -> None:
        with self._err_lock:
            err = self._err
        if err is None:
            return
        exc, applied, e = err
        raise RuntimeError(
            f"cross-step tail for step {e} failed after {applied}/"
            f"{len(self._chunked.groups)} optimizer groups applied — "
            f"parameters and optimizer state are PARTIALLY stepped; do not "
            f"retry this step on the same trainer (install fresh state "
            f"with load_state_dict, or run with BPS_CROSS_STEP=0 for "
            f"draining steps)") from exc

    # ------------------------------------------------------------ step

    def _gate(self, e: int, leaf_ids) -> None:
        """Step ``e``'s reader of ``leaf_ids`` waits for their applies of
        step ``gate_round(e)``: on the host (epochs), then on the device
        (the current stream waits on the groups' apply events)."""
        if not leaf_ids:
            return
        t0 = time.time()
        self._chunked.wait_epoch(leaf_ids, self._gate_round(e),
                                 should_abort=lambda: self._err is not None)
        self._check_err()
        self._chunked.wait_device(leaf_ids)
        observe_stage("PS_XSTEP_GATE", time.time() - t0)

    def step(self, batch) -> torch.Tensor:
        """One non-draining step: the gated forward and the staged
        backward feed a fresh ingest round; the tail goes to a background
        thread; returns the loss."""
        self._check_err()
        self._tails = [t for t in self._tails if t.is_alive()]
        chunked = self._chunked
        if not self._tails and self._dirty:
            chunked.mark_epoch(range(len(chunked.params)), self._epoch)
            self._dirty = False
        e = self._epoch = self._epoch + 1
        reg = get_registry()
        reg.gauge("xstep/tails_in_flight").set(len(self._tails) + 1)
        reg.gauge("xstep/epoch_lag").set(e - 1 - min(chunked.ready_epoch,
                                                     default=e - 1))
        tr = self._tr
        t_ex = time.time()
        hyper = chunked.hyper()
        compute = (torch.cuda.current_stream(tr.device)
                   if tr.device.type == "cuda" else None)
        # re-resolved every step: None is an unsharded round
        st = tr._sharded_active()
        handle = self._ex.exchange_ingest(
            tr._ps_params, name=tr._name, step=e,
            host_alloc=tr._stager.host_alloc,
            sharded=st.plan.round_view() if st is not None else None)
        if st is not None:
            tr._sharded_epoch = e

        def gate(leaf_ids) -> None:
            self._gate(e, leaf_ids)

        try:
            if self._compute is None:
                gate(self._ungated)
                loss = tr._staged_backward(batch, handle, gate)
            else:
                # every leaf before the lock: a gate inside it would wait
                # for applies that the lock holds back
                gate(range(len(chunked.params)))
                with self._compute:
                    loss = tr._staged_backward(batch, handle, None)
        except BaseException:
            # no tail will mark epoch e: roll the counter back, or every
            # later gate waits for marks that never come (the staged
            # backward aborted the round)
            self._epoch = e - 1
            if st is not None:
                tr._sharded_epoch = e - 1
            raise
        # the param-frame seq is taken at tail launch, in step order, so
        # equal seqs are the same step on every replica
        seq = st.next_seq() if st is not None else None
        t = threading.Thread(target=self._tail,
                             args=(handle, e, hyper, compute, t_ex, st, seq),
                             name=f"bps-xstep-tail-{e}", daemon=True)
        self._tails.append(t)
        t.start()
        return loss

    # ------------------------------------------------------------ tail

    def _tail(self, handle, e: int, hyper, compute, t_ex: float, st=None,
              seq=None) -> None:
        """Step ``e``'s straggler consumer: a reader thread copies each
        leaf to the card as it lands and queues complete groups by
        next-use priority; this thread applies them, each once its
        step-(e-1) apply was enqueued, on the forward's stream. ``st``,
        ``seq``: the sharded state and the step's param-frame seq (its
        ``run_tail`` then consumes the round, with the same gating and
        the same poison on failure)."""
        chunked, stager = self._chunked, self._tr._stager
        if st is not None:
            applied = 0
            try:
                applied = st.run_tail(
                    handle, chunked, e, seq, stager.copy, self._tr._put_param,
                    hyper, stream=compute,
                    should_abort=lambda: self._err is not None)
                observe_stage("PS_PUSH_PULL", time.time() - t_ex)
            except BaseException as exc:   # noqa: BLE001 — surfaced on the
                with self._err_lock:       # next step(), drain() or read
                    if self._err is None:
                        self._err = (exc, applied, e)
                chunked.mark_epoch((), e)
            return
        shapes = [tuple(p.shape) for _, p in self._tr._ps_params]
        cv = threading.Condition()
        ready: List = []             # (first leaf, group) min-heap
        landed: dict = {}
        state = {"done": False, "exc": None}

        def reader() -> None:
            remaining = [len(g) for g in chunked.groups]
            try:
                for li, arr in handle.ready():
                    d = stager.copy(arr, shapes[li])
                    gi = chunked.leaf_group[li]
                    with cv:
                        landed[li] = d
                        remaining[gi] -= 1
                        if remaining[gi] == 0:
                            heapq.heappush(ready, (min(chunked.groups[gi]),
                                                   gi))
                            cv.notify()
            except BaseException as exc:   # noqa: BLE001 — rethrown by
                with cv:                   # the apply loop below
                    state["exc"] = exc
            finally:
                with cv:
                    state["done"] = True
                    cv.notify()

        rt = threading.Thread(target=reader, daemon=True,
                              name=f"bps-xstep-ready-{e}")
        rt.start()
        applied = 0
        try:
            while True:
                with cv:
                    while not ready and not state["done"]:
                        cv.wait()
                    if state["exc"] is not None:
                        raise state["exc"]
                    if not ready:
                        break
                    _, gi = heapq.heappop(ready)
                group = chunked.groups[gi]
                chunked.wait_epoch(group, e - 1,
                                   should_abort=lambda: self._err is not None)
                self._check_err()
                with cv:
                    items = [landed.pop(i) for i in group]
                with self._compute or contextlib.nullcontext():
                    chunked.apply_group(
                        gi, [t for t, _ in items], hyper,
                        [ev for _, ev in items if ev is not None],
                        stream=compute)
                    # published only after the apply was enqueued and its
                    # event recorded: a gate waking earlier would read
                    # the step-(e-1) weights
                    chunked.mark_epoch(group, e)
                applied += 1
            observe_stage("PS_PUSH_PULL", time.time() - t_ex)
        except BaseException as exc:   # noqa: BLE001 — surfaced on the
            with self._err_lock:       # next step(), drain() or read
                if self._err is None:
                    self._err = (exc, applied, e)
            # wake the gates that poll should_abort
            chunked.mark_epoch((), e)
