"""DistributedOptimizer + parameter/optimizer-state broadcast of the torch
plugin (the port of ``byteps_tpu/torch/optimizer.py``; reference:
torch/__init__.py:35-409).

The wrapper subclasses the user's optimizer class dynamically (the
reference's trick) and:

  - hooks every parameter's gradient accumulation
    (``register_post_accumulate_grad_hook``, the modern form of the
    reference's ``grad_acc.register_hook``) to dispatch an async
    push_pull the moment a gradient is ready, overlapping communication
    with the rest of backward — only when ``size() > 1``, as the
    reference does: at world 1 the wrapper is the plain optimizer;
  - counts ``backward_passes_per_step`` backwards before communicating
    (local gradient accumulation, reference :83-113);
  - ``synchronize()`` drains the handles and writes the averaged
    gradients back, so gradient clipping between backward and step works;
  - async-PS mode (``BPS_ENABLE_ASYNC`` as ``bps.init()``'s ``Config`` read
    it; the JAX plugin's, ``byteps_tpu/torch/optimizer.py:157-187``): the
    hooks dispatch nothing, and ``step()`` at ``size() > 1`` applies the
    local update, then per parameter pushes the weight delta (on the
    parameter's device in fp32, narrowed there to
    ``BPS_ASYNC_WIRE_DTYPE`` if it is set, ``ps_mode.async_wire_dtype``)
    and pulls the store's fp32
    weights through ``ops.async_param_exchange("AsyncParam." + name)``,
    the store seeded with the parameter's weights before the step.
    ``CrossBarrier`` refuses an async optimizer. ``broadcast_parameters``
    raises in async-PS mode at ``size() > 1``: there ``push_pull`` is this
    worker's own values, so the JAX plugin's zero-then-sum broadcast
    leaves every other worker's parameters at zero (ROADMAP.md, queue 3,
    "Deliberate differences").
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..common.global_state import GlobalState
from ..server.ps_mode import async_wire_dtype, host_leaf, torch_dtype
from .compression import Compression
from .ops import (async_param_exchange, declare_model_keys, push_pull_async,
                  rank, size, synchronize)


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._enable_async = GlobalState.get().config.enable_async

        named_parameters = list(named_parameters or [])
        if any(not isinstance(p, tuple) for p in named_parameters):
            raise ValueError("named_parameters should be a sequence of "
                             "(name, parameter) tuples, usually "
                             "model.named_parameters()")
        names = [n for n, _ in named_parameters]
        if len(set(names)) != len(names):
            dups = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"parameter names must be unique; "
                             f"duplicates: {', '.join(dups)}")
        if named_parameters:
            self._parameter_names = {p: n for n, p in named_parameters}
        else:
            # one running index across ALL groups: a per-group index would
            # give the first parameter of every group the same name
            allp = [p for group in self.param_groups
                    for p in group["params"]]
            self._parameter_names = {
                p: f"push_pull.noname.{i}" for i, p in enumerate(allp)}
        self.backward_passes_per_step = backward_passes_per_step
        # forward position of each parameter (named_parameters yields in
        # module order): its exchange priority on the PS pool
        self._param_index = {p: i for i, p in
                             enumerate(self._parameter_names)}
        self._push_pull_delay = {p: backward_passes_per_step
                                 for p in self._parameter_names}
        self._handles = {}
        self._hook_handles = []
        self._requires_update = set()
        self._should_sync = True
        if size() > 1:
            self._register_hooks()
        declare_model_keys(self._parameter_names.values())

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._requires_update.add(p)
                    self._hook_handles.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook()))

    def _make_hook(self):
        def hook(p):
            if p in self._handles and self._handles[p][0] is not None:
                if self._push_pull_delay[p] <= 0:
                    raise AssertionError(
                        "Gradients were computed more than "
                        "backward_passes_per_step times before step(); "
                        "increase backward_passes_per_step to accumulate")
            assert self._push_pull_delay[p] > 0
            handle, ctx = None, None
            self._push_pull_delay[p] -= 1
            if self._push_pull_delay[p] == 0:
                handle, ctx = self._push_pull_grad_async(p)
            self._handles[p] = (handle, ctx)
        return hook

    def _push_pull_grad_async(self, p):
        name = self._parameter_names[p]
        if self._enable_async:
            return None, None        # the exchange is step()'s
        compressed, ctx = self._compression.compress(p.grad)
        # priority = forward position: on a busy PS pool earlier layers'
        # exchanges go first, so the next forward unblocks soonest
        handle = push_pull_async(compressed, average=True,
                                 name="Gradient." + name,
                                 priority=self._param_index.get(p, 0))
        return handle, ctx

    def set_backward_passes_per_step(self, passes):
        self.backward_passes_per_step = passes
        for p in self._push_pull_delay:
            self._push_pull_delay[p] = passes

    def synchronize(self):
        if size() <= 1:
            return
        # parameters whose hook never fired (unused in this forward) and
        # that have no gradient contribute nothing: every rank skips them
        # alike (autograd leaves unused parameters' grads None everywhere)
        missing = {p for p in self._requires_update - set(self._handles)
                   if p.grad is not None}
        for p in sorted(missing, key=self._param_index.get):
            self._handles[p] = self._push_pull_grad_async(p)
        for p, (handle, ctx) in list(self._handles.items()):
            if handle is None and not self._enable_async:
                self._handles[p] = self._push_pull_grad_async(p)
        for p, (handle, ctx) in self._handles.items():
            if handle is None:
                continue
            out = synchronize(handle)
            self._push_pull_delay[p] = self.backward_passes_per_step
            with torch.no_grad():
                p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()

    @contextmanager
    def skip_synchronize(self):
        if self._enable_async:
            raise AssertionError(
                "skip_synchronize cannot be used in async training")
        self._should_sync = False
        try:
            yield
        finally:
            self._should_sync = True

    def step(self, closure=None):
        if self._enable_async and size() > 1:
            return self._async_step(closure)
        if self._should_sync:
            self.synchronize()
        return super(self.__class__, self).step(closure)

    def _async_step(self, closure):
        """Local update, then per parameter the delta pushed and the
        store's weights pulled into it (no barrier between workers)."""
        old = {p: p.detach().clone() for p in self._parameter_names}
        loss = super(self.__class__, self).step(closure)
        wire = async_wire_dtype()
        wire = None if wire is None else torch_dtype(wire)
        for p, name in self._parameter_names.items():
            with torch.no_grad():
                # the store is fp32 whatever the parameter's dtype
                delta = (p.detach() - old[p]).float()
                if wire is not None:
                    delta = delta.to(wire)
            fresh = async_param_exchange(
                "AsyncParam." + name, host_leaf(delta),
                host_leaf(old[p].float()).reshape(tuple(p.shape)))
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.ascontiguousarray(fresh))
                        .to(p.dtype))
        self._handles.clear()
        for p in self._push_pull_delay:
            self._push_pull_delay[p] = self.backward_passes_per_step
        return loss


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1):
    """Wrap a torch optimizer so gradients are push_pull-averaged across
    workers before each step (reference: torch/__init__.py:218-252 — a
    dynamic subclass of the wrapped optimizer's class)."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step)


def broadcast_parameters(params, root_rank, prefix="Parameter."):
    """Root's values into every worker's tensors, in place (reference:
    torch/__init__.py:259-291). Over a process group the port replaces the
    reference's zero-the-others + sum with ``dist.broadcast``: root's bits
    exactly, a -0.0 included, and no key declared. PS mode joins no
    group, so there it is the JAX plugin's way
    (``byteps_tpu/torch/optimizer.py:205-229``): every worker but root
    zeroes its tensors and all push_pull the sum through the servers under
    ``prefix + name``. ``params``: a dict (a ``state_dict()``, broadcast in
    sorted name order) or a list of tensors or (name, tensor) pairs."""
    if isinstance(params, dict):
        items = sorted(params.items())
    elif isinstance(params, list):
        items = [p if isinstance(p, tuple) else (None, p) for p in params]
    else:
        raise ValueError(f"invalid params of type {type(params)}")
    if size() <= 1:
        return
    cfg = GlobalState.get().config
    if cfg.enable_ps and cfg.enable_async:
        raise NotImplementedError(
            "broadcast_parameters in async-PS mode: push_pull is this "
            "worker's own values there, so the JAX plugin's zero-then-sum "
            "broadcast zeroes every other worker's parameters; the async "
            "store is seeded by the first worker's weights instead (see "
            "ROADMAP.md, queue 3, 'Deliberate differences')")
    if cfg.enable_ps:
        handles = []
        for name, p in items:
            if not isinstance(p, torch.Tensor):
                continue
            with torch.no_grad():
                if rank() != root_rank:
                    p.fill_(0)
            handles.append((p, push_pull_async(
                p, average=False,
                name=(prefix + name) if name else None)))
        for p, h in handles:
            out = synchronize(h)
            with torch.no_grad():
                p.copy_(out)
        return
    GlobalState.get().engine.broadcast_(
        [p for _, p in items if isinstance(p, torch.Tensor)], root_rank)


def broadcast_optimizer_state(optimizer, root_rank,
                              prefix="OptimizerState."):
    """Root's optimizer state to every worker; scalar state entries are
    tensor-ized for the wire (reference: torch/__init__.py:293-409)."""
    if size() <= 1:
        return
    if not optimizer.state_dict().get("state"):
        # a fresh optimizer: materialize its state with a zero-gradient
        # step (the reference's trick) so every worker broadcasts the same
        # entries — a checkpoint-loaded root would otherwise send entries
        # a fresh worker never receives. Parameters are restored around
        # the step: weight decay would move them.
        saved = [(p, p.detach().clone())
                 for g in optimizer.param_groups for p in g["params"]]
        grads = [p.grad for p, _ in saved]
        for p, _ in saved:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        with torch.no_grad():
            for (p, v), g in zip(saved, grads):
                p.copy_(v)
                p.grad = g
    state = optimizer.state_dict()
    tensors = {}
    scalars = []                       # (pid, key, original python type)
    for pid, pstate in state.get("state", {}).items():
        for k, v in list(pstate.items()):
            key = f"{prefix}{pid}.{k}"
            if isinstance(v, torch.Tensor):
                tensors[key] = v
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                t = torch.tensor(float(v), dtype=torch.float64)
                tensors[key] = t
                pstate[k] = t
                scalars.append((pid, k, type(v)))
    broadcast_parameters(tensors, root_rank, prefix="")
    for pid, k, typ in scalars:        # back to python scalars
        state["state"][pid][k] = typ(state["state"][pid][k].item())
    optimizer.load_state_dict(state)
