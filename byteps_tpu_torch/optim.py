"""Distributed optimizer wrapper of the port (counterpart of
``byteps_tpu/optim.py::distributed_optimizer``).

The reference wraps each framework's optimizer so that every gradient is
push_pulled before the local update (reference: torch/__init__.py:115-174
_DistributedOptimizer), with gradient accumulation via
``backward_passes_per_step`` (torch/__init__.py:83-113). Here the wrapper
holds an inner ``torch.optim`` optimizer: at each sync boundary it runs
the bucketed all-reduce over the data-parallel group, then
``inner.step()``. With ``compression`` (the reference's string kwargs,
e.g. onebit with error feedback and Nesterov momentum) the reduction is
``ops.compression.CompressionPlan``'s compressed exchange instead
(counterpart of ``byteps_tpu/optim.py::_make_compressed``), and with a
custom ``reducer`` each bucket goes through it in place of the sum.

``ChunkedApply`` is the parameter-server step's per-group apply of the
inner optimizer (counterpart of ``byteps_tpu/optim.py::ChunkedApply``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .obs.metrics import observe_stage
from .parallel.collectives import Reducer, bucketed_allreduce, leaf_specs
from .parallel.mesh import dp_size


def adamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults — in
    particular weight_decay 1e-4, where torch's own default is 1e-2. The
    two apply the same update: decoupled decay of the pre-step weights
    plus the bias-corrected Adam step with eps outside the square root."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


class DistributedOptimizer:
    """Cross-replica gradient sync in front of an inner optimizer.

    ``backward_passes_per_step = k > 1`` lets gradients accumulate (sum)
    over k backward passes; the k-th ``step()`` divides them by k — the
    mean, as ``optax.MultiSteps`` takes it — then all-reduces and steps.
    No bandwidth is spent on the passes in between.

    A parameter that received no gradient gets zeros before the sync:
    every replica then reduces the same buckets, and the inner optimizer
    updates it as optax does a zero gradient (decay and moments included).

    ``compression``: string kwargs in the reference's format
    (docs/gradient-compression.md "Interface"). The bucket plan then runs
    over the leaves in the JAX tree's order (the dotted names sorted by
    path), so a bucket holds what the JAX package's bucket holds and its
    compressor sees the same values. Buckets under ``min_compress_bytes``
    take the plain sum. The compressor state (error feedback, momentum)
    is this process's own, on the parameters' device. Unlike the dense
    path, the compressed one runs at world 1 too: only the collective is
    skipped. The plan's rs exchange shards each bucket over ``group``'s
    size.

    ``reducer``: ``reducer(buf, group) -> buf`` for each bucket in place
    of the sum over ``group`` (``parallel.collectives.Reducer``; the
    average still divides by the group size). Like compression it runs at
    world 1 too, with ``group`` None. The two are exclusive: the
    compressed exchange is its own reduction.
    """

    def __init__(self, inner: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 group=None, partition_bytes: int = 4 << 20,
                 backward_passes_per_step: int = 1,
                 compression: Optional[Dict[str, str]] = None,
                 min_compress_bytes: int = 65536,
                 reducer: Optional[Reducer] = None) -> None:
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if reducer is not None and compression:
            raise ValueError("a custom reducer and compression are "
                             "exclusive: the compressed exchange is the "
                             "reduction")
        self.reducer = reducer
        self.inner = inner
        self.group = group
        self.partition_bytes = partition_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self._params = [p for g in inner.param_groups for p in g["params"]]
        names = {id(p): n for n, p in (named_parameters or ())}
        self._names = [names.get(id(p), str(i))
                       for i, p in enumerate(self._params)]
        self._passes = 0
        self.plan = None
        if compression:
            from .ops.compression.reducer import CompressionPlan
            self._order = sorted(range(len(self._params)),
                                 key=lambda i: self._names[i].split("."))
            self.plan = CompressionPlan(
                leaf_specs([self._params[i] for i in self._order],
                           [self._names[i] for i in self._order]),
                partition_bytes, {k: str(v) for k, v in compression.items()},
                min_compress_bytes, world=dp_size(group))
            self.comp_states = None     # made at the first sync

    def syncs_next(self) -> bool:
        """True when the next ``step()`` ends the accumulation window."""
        return (self._passes + 1) % self.backward_passes_per_step == 0

    def step(self) -> bool:
        """Returns True when this call synced and applied an update,
        False mid-window."""
        self._passes += 1
        k = self.backward_passes_per_step
        if self._passes % k:
            return False
        grads = []
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        with torch.no_grad():
            if k > 1:
                for g in grads:
                    g.div_(k)
            if self.plan is None:
                bucketed_allreduce(grads, group=self.group,
                                   partition_bytes=self.partition_bytes,
                                   average=True, names=self._names,
                                   reducer=self.reducer)
            else:
                if self.comp_states is None:
                    self.comp_states = self.plan.init_state(grads[0].device)
                self.comp_states = self.plan.reduce(
                    [grads[i] for i in self._order], self.comp_states,
                    group=self.group, average=True)
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        return True


def distributed_optimizer(inner: torch.optim.Optimizer, **kwargs
                          ) -> DistributedOptimizer:
    return DistributedOptimizer(inner, **kwargs)


# ------------------------------------------------------- chunked apply
#
# The sync-PS step's tail applies the optimizer per bucket group as the
# group's summed gradients land (the port of ``byteps_tpu/optim.py:141-335``):
# group 0's weights update while group N's gradients are still on the wire.
# The inner torch optimizer is stepped through CHILD instances of its own
# class, one per group, that share the parent's ``state`` (the plugin's
# ``torch/cross_barrier.py`` does the same per parameter), so checkpoints and
# ``state_dict()`` see one source of truth and no second state exists.

def _hyper(optimizer) -> List[dict]:
    """The hyper-parameters of each of ``optimizer``'s param groups."""
    return [{k: v for k, v in g.items() if k != "params"}
            for g in optimizer.param_groups]


def _group_index(optimizer) -> Dict[int, int]:
    """id(param) -> index of the optimizer's param group holding it."""
    return {id(p): j for j, g in enumerate(optimizer.param_groups)
            for p in g["params"]}


def _child(cls, params, hyper, group_of) -> Tuple[object, List[int]]:
    """A ``cls`` instance over ``params``, one param group per parent group
    they come from, with that group's hyper-parameters; the parent group
    indices in the child's group order. None when the parent steps none of
    ``params``."""
    by: Dict[int, list] = {}
    for p in params:
        j = group_of.get(id(p))
        if j is not None:
            by.setdefault(j, []).append(p)
    if not by:
        return None, []
    order = sorted(by)
    return cls([dict(hyper[j], params=by[j]) for j in order]), order


def leafwise_decomposable(optimizer, params, groups, steps: int = 2) -> bool:
    """Numeric probe: does ``optimizer``'s class update each leaf
    independently of the others, so that stepping it one group at a time
    equals one fused ``step()`` bit for bit?

    ``steps`` updates of a tiny same-structure problem (two elements a
    leaf, seeded values, on the parameters' device, in the parent's param
    groups with its hyper-parameters), fused and per group, must give
    identical parameters. A value-coupled optimizer (one that scales by a
    norm over all its parameters) differs on any non-degenerate values; one
    that cannot run on the probe raises, and counts as coupled too."""
    gen = torch.Generator().manual_seed(0)

    def tiny(p):
        return torch.randn(2, generator=gen).to(device=p.device,
                                                dtype=p.dtype)

    start = [tiny(p) for p in params]
    grads = [[tiny(p) for p in params] for _ in range(steps)]
    cls, hyper = type(optimizer), _hyper(optimizer)
    real_group = _group_index(optimizer)
    try:
        fused_p = [torch.nn.Parameter(t.clone()) for t in start]
        part_p = [torch.nn.Parameter(t.clone()) for t in start]
        # the probe's params fall in the groups their real leaves are in
        group_of = {}
        for i, p in enumerate(params):
            j = real_group.get(id(p))
            if j is not None:
                group_of[id(fused_p[i])] = group_of[id(part_p[i])] = j
        fused, _ = _child(cls, fused_p, hyper, group_of)
        parts = [_child(cls, [part_p[i] for i in g], hyper, group_of)[0]
                 for g in groups]
        for s in range(steps):
            for ps in (fused_p, part_p):
                for p, g in zip(ps, grads[s]):
                    p.grad = g.clone()
            if fused is not None:
                fused.step()
            for o in parts:
                if o is not None:
                    o.step()
        return all(torch.equal(a, b) for a, b in zip(fused_p, part_p))
    except Exception:       # noqa: BLE001 — an optimizer the probe cannot
        return False        # run keeps the fused apply


def _adam_layout(optimizer) -> bool:
    """Whether ``optimizer`` keeps optax's ``ScaleByAdamState`` per
    parameter: torch's Adam or AdamW without amsgrad (``step``,
    ``exp_avg``, ``exp_avg_sq``: the count, mu and nu)."""
    return (isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW))
            and not any(g.get("amsgrad") for g in optimizer.param_groups))


def _scalar_on_device(hyper: dict) -> bool:
    """Whether torch keeps a parameter's 0-d state on its device."""
    return bool(hyper.get("capturable") or hyper.get("fused"))


def _adam_fresh(p, hyper: dict) -> dict:
    """The state torch's Adam and AdamW make at a parameter's first step
    (``Adam._init_group``): ``step`` 0, a 0-d tensor on the CPU (on the
    parameter's device under ``capturable`` or ``fused``), float32 (float64
    when that is the default dtype and the step is not fused), and the
    two moments as zeros like the parameter."""
    fused = bool(hyper.get("fused"))
    dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
             and not fused else torch.float32)
    dev = p.device if _scalar_on_device(hyper) else torch.device("cpu")
    return {"step": torch.zeros((), dtype=dtype, device=dev),
            "exp_avg": torch.zeros_like(
                p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format)}


class GroupState:
    """One bucket group's optimizer state, as torch keeps it: ``state``
    holds a dict a parameter of ``params`` (the group's leaves, in group
    order), the entries of ``optimizer.state``. ``adam``: the optimizer's
    state has the JAX package's Adam layout (``_adam_layout``), the frame
    layout of ``sharded_update.pack_opt_state``. ``scalar_on_device``:
    per parameter, whether torch keeps its 0-d state (``step``) on the
    parameter's device (``capturable`` or ``fused``) rather than on the
    CPU."""

    __slots__ = ("params", "state", "adam", "scalar_on_device")

    def __init__(self, params, state, adam: bool, scalar_on_device) -> None:
        self.params = list(params)
        self.state = [dict(s) for s in state]
        self.adam = bool(adam)
        self.scalar_on_device = list(scalar_on_device)


class ChunkedApply:
    """The inner optimizer applied per bucket group of the flat parameter
    list ``params`` (the trainer's leaves, in the JAX tree's order), the
    groups being ``PSGradientExchange.leaf_groups``.

    When the optimizer is leafwise decomposable (``leafwise_decomposable``)
    ``apply_group`` steps one group's child optimizer; its result is the
    fused ``step()``'s bit for bit, each leaf seeing the same operations.
    Otherwise ``decomposable`` is False and the caller keeps the fused
    ``apply_fused`` (its H2D copies still stream).

    For the cross-step driver each leaf has a readiness EPOCH (the last
    step whose apply was enqueued for it, ``mark_epoch`` / ``wait_epoch``)
    and each group the CUDA event recorded after its latest apply
    (``wait_device``): the host gate and the device order a later reader
    needs.

    ``owned`` (the sharded weight update, ``sharded_update.py``): the
    groups this replica applies. A group's child optimizer is made at its
    first apply, and a torch optimizer makes a parameter's state at its
    first step, so optimizer state exists for the owned groups only;
    applying another group raises (its state lives on its owner). A
    membership change moves a group's state with ``init_group``,
    ``adopt_group``, ``release_group`` and ``set_owned``."""

    def __init__(self, optimizer, params, groups, owned=None) -> None:
        self.opt = optimizer
        self.params = list(params)
        self.groups = [tuple(g) for g in groups if g]
        self.leaf_group = {li: gi for gi, g in enumerate(self.groups)
                           for li in g}
        covered = sorted(self.leaf_group) == list(range(len(self.params)))
        self.decomposable = covered and leafwise_decomposable(
            optimizer, self.params, self.groups)
        self.ready_epoch = [0] * len(self.params)
        self._epoch_cv = threading.Condition()
        self.apply_events: List = [None] * len(self.groups)
        self._children: List = [None] * len(self.groups)
        self.owned = None if owned is None else frozenset(owned)

    def hyper(self) -> List[dict]:
        """The parent's hyper-parameters now: a step's applies use those in
        force when its gradients were produced, even when its tail runs
        after the caller changed them."""
        return _hyper(self.opt)

    def _child_for(self, gi: int, hyper):
        if self._children[gi] is None:
            self._children[gi] = _child(
                type(self.opt), [self.params[li] for li in self.groups[gi]],
                hyper, _group_index(self.opt))
        child, order = self._children[gi]
        if child is not None:
            for cg, j in zip(child.param_groups, order):
                cg.update(hyper[j])
            # ONE state table: re-bound every time, since the parent's
            # load_state_dict replaces its state dict
            child.state = self.opt.state
        return child

    def _run(self, leaf_ids, grads, step, events, stream):
        """``step()`` with ``grads`` as the leaves' ``.grad``, after
        ``events``, on ``stream`` (the card's compute stream; None: the
        current one); returns the event recorded after it (None on the
        CPU)."""
        ps = [self.params[li] for li in leaf_ids]
        cuda = bool(ps) and ps[0].is_cuda
        ctx = (torch.cuda.stream(stream) if cuda and stream is not None
               else contextlib.nullcontext())
        with ctx:
            ev = None
            if cuda:
                cur = torch.cuda.current_stream(ps[0].device)
                for e in events:
                    cur.wait_event(e)
                for g in grads:
                    # made on the H2D stream, read here: not recycled
                    # before this stream is done with it
                    g.record_stream(cur)
            for p, g in zip(ps, grads):
                p.grad = g
            try:
                step()
            finally:
                for p in ps:
                    p.grad = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record(cur)
        return ev

    def apply_group(self, gi: int, grads, hyper, events=(),
                    stream=None) -> None:
        """Step group ``gi`` with ``grads`` (in ``groups[gi]`` order)."""
        if self.owned is not None and gi not in self.owned:
            raise RuntimeError(
                f"apply_group({gi}) on a non-owned group: this replica "
                f"holds no optimizer state for it (sharded update) — "
                f"non-owned groups are installed from the owner's "
                f"param frames, never applied locally")
        t0 = time.time()
        child = self._child_for(gi, hyper)
        ev = self._run(self.groups[gi], grads,
                       child.step if child is not None else (lambda: None),
                       events, stream)
        self.apply_events[gi] = ev
        observe_stage("PS_APPLY_CHUNK", time.time() - t0)

    def apply_fused(self, grads, events=(), stream=None) -> None:
        """The parent's own ``step()`` over every leaf (a non-decomposable
        optimizer)."""
        t0 = time.time()
        ev = self._run(range(len(self.params)), grads, self.opt.step,
                       events, stream)
        self.apply_events = [ev] * len(self.groups)
        observe_stage("PS_APPLY_CHUNK", time.time() - t0)

    def groups_with_state(self) -> List[int]:
        """The groups of which some parameter has optimizer state."""
        state = self.opt.state
        return [gi for gi, g in enumerate(self.groups)
                if any(state.get(self.params[li]) for li in g)]

    # ------------------------------------------------ membership changes
    #
    # The sharded update's ownership moves (``sharded_update.py``'s
    # ``reshard`` and the sharded checkpoints) through these: the port of
    # ``byteps_tpu/optim.py:258-287``. A group's state is its parameters'
    # entries of the one ``optimizer.state`` table.

    def _stepped(self, gi: int):
        """The leaves of group ``gi`` that the optimizer steps, and the
        param-group dict of each."""
        where = _group_index(self.opt)
        ps = [self.params[li] for li in self.groups[gi]
              if id(self.params[li]) in where]
        return ps, [self.opt.param_groups[where[id(p)]] for p in ps]

    def group_state(self, gi: int) -> GroupState:
        """Group ``gi``'s optimizer state as it stands (a parameter without
        state has an empty dict)."""
        ps, hyper = self._stepped(gi)
        st = self.opt.state
        return GroupState(ps, [st.get(p, {}) for p in ps],
                          _adam_layout(self.opt), [_scalar_on_device(g)
                                                   for g in hyper])

    @property
    def states(self) -> Optional[List[Optional[GroupState]]]:
        """Per group, its state, or None where no parameter of it has any
        (the JAX package's ``states``); None for a tail that is not
        decomposable."""
        if not self.decomposable:
            return None
        return [s if any(s.state) else None
                for s in (self.group_state(gi)
                          for gi in range(len(self.groups)))]

    def init_group(self, gi: int) -> GroupState:
        """The state a fresh optimizer has for group ``gi`` once its first
        step made it: the unpack template of a handoff frame or a
        checkpoint slice, and the state a crashed owner's group restarts
        from. For Adam and AdamW, what ``Adam._init_group`` makes
        (``_adam_fresh``), so a group restarted from it steps as one that
        never had state; another optimizer makes its state from the first
        gradient, so its fresh state is none (empty dicts)."""
        ps, hyper = self._stepped(gi)
        adam = _adam_layout(self.opt)
        return GroupState(ps, [_adam_fresh(p, g) if adam else {}
                               for p, g in zip(ps, hyper)],
                          adam, [_scalar_on_device(g) for g in hyper])

    def adopt_group(self, gi: int, state: GroupState) -> None:
        """Install ``state`` (from ``init_group`` or
        ``sharded_update.unpack_opt_state``, its tensors where torch keeps
        them) as group ``gi``'s optimizer state."""
        if not self.decomposable:
            raise RuntimeError(
                "adopt_group on a non-decomposable tail — sharded "
                "ownership never engages there")
        ps, _ = self._stepped(gi)
        if len(state.state) != len(ps):
            raise ValueError(f"adopt_group({gi}): state for "
                             f"{len(state.state)} parameters, the group "
                             f"steps {len(ps)}")
        for p, s in zip(ps, state.state):
            if s:
                self.opt.state[p] = dict(s)
            else:
                self.opt.state.pop(p, None)

    def release_group(self, gi: int) -> None:
        """Drop group ``gi``'s optimizer state (ownership handed away: the
        ~1/dp memory holds through membership changes)."""
        for li in self.groups[gi]:
            self.opt.state.pop(self.params[li], None)

    def set_owned(self, owned) -> None:
        """Flip the owned set at a membership epoch's boundary (the caller
        adopts the gained groups before and releases the lost ones
        after); applying a group outside it raises."""
        self.owned = None if owned is None else frozenset(owned)

    def mark_epoch(self, leaf_ids, epoch: int) -> None:
        """Publish ``leaf_ids`` as applied through step ``epoch`` (after
        the apply was enqueued and its event recorded)."""
        with self._epoch_cv:
            for li in leaf_ids:
                self.ready_epoch[li] = epoch
            self._epoch_cv.notify_all()

    def wait_epoch(self, leaf_ids, epoch: int, should_abort=None) -> float:
        """Block until every leaf of ``leaf_ids`` reached ``epoch``;
        returns the seconds waited. ``should_abort()`` is polled, so a
        dead tail cannot leave the gate waiting forever."""
        t0 = time.time()
        with self._epoch_cv:
            while not all(self.ready_epoch[li] >= epoch for li in leaf_ids):
                if should_abort is not None and should_abort():
                    break
                self._epoch_cv.wait(0.05)
        return time.time() - t0

    def wait_device(self, leaf_ids) -> None:
        """Order the current CUDA stream after the latest apply of every
        group holding one of ``leaf_ids``: a host flag alone would let a
        reader on another stream see a half-written parameter."""
        seen = set()
        for li in leaf_ids:
            gi = self.leaf_group.get(li)
            if gi is None or gi in seen:
                continue
            seen.add(gi)
            ev = self.apply_events[gi]
            if ev is not None:
                torch.cuda.current_stream(self.params[li].device) \
                    .wait_event(ev)
