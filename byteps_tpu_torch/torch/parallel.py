"""DistributedDataParallel of the torch plugin (the port of
``byteps_tpu/torch/parallel.py``; reference:
torch/parallel/distributed.py:122-287 — a module wrapper with group-sync
counting: every parameter's gradient hook dispatches an async push_pull,
and the LAST hook of the backward drains them all, so gradients are
already averaged when ``loss.backward()`` returns and any plain torch
optimizer can step).

Differences from wrapping the optimizer (``DistributedOptimizer``): the
model, not the optimizer, is wrapped; gradients sync during backward with
no ``synchronize()`` call; ``no_sync()`` accumulates locally for
gradient-accumulation loops, syncing on the first backward after the
context exits (torch DDP semantics). Buffers (batch-norm statistics) are
broadcast from rank 0 before every forward."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .compression import Compression
from .ops import declare_model_keys, push_pull_async, size, synchronize
from .optimizer import broadcast_parameters


class DistributedDataParallel(torch.nn.Module):
    def __init__(self, module: torch.nn.Module, broadcast_buffers=True,
                 compression=Compression.none):
        super().__init__()
        self.module = module
        self.broadcast_buffers = broadcast_buffers
        self._compression = compression
        self._require_backward_grad_sync = True
        self._handles = {}
        self._hook_handles = []
        named = list(module.named_parameters())
        self._parameter_names = {p: n for n, p in named}
        self._num_grads = sum(p.requires_grad for _, p in named)
        self._fired = 0
        if size() > 1:
            for _, p in named:
                if p.requires_grad:
                    self._hook_handles.append(
                        p.register_post_accumulate_grad_hook(self._hook))
        declare_model_keys(self._parameter_names.values())
        if size() > 1:
            # rank 0's weights, and its buffers unless told otherwise
            broadcast_parameters(
                self.module.state_dict() if broadcast_buffers
                else dict(self.module.named_parameters()), root_rank=0)

    def forward(self, *args, **kwargs):
        if (self.broadcast_buffers and size() > 1
                and any(True for _ in self.module.buffers())):
            # torch DDP semantics: buffers re-broadcast from rank 0 before
            # every forward, so running statistics stay identical
            broadcast_parameters(dict(self.module.named_buffers()),
                                 root_rank=0, prefix="Buffer.")
        return self.module(*args, **kwargs)

    def _hook(self, p):
        if not self._require_backward_grad_sync:
            return                      # no_sync(): accumulate locally
        name = self._parameter_names[p]
        if p in self._handles:
            raise RuntimeError(
                f"gradient for {name!r} is already in flight — the "
                f"previous backward left {len(self._handles)} "
                f"reduction(s) unsynced (requires_grad parameters unused "
                f"in that graph?). Call model.synchronize() after any "
                f"backward that does not touch every parameter "
                f"(upstream torch DDP raises in this case too).")
        compressed, ctx = self._compression.compress(p.grad)
        self._handles[p] = (push_pull_async(
            compressed, average=True, name="Gradient." + name), ctx)
        self._fired += 1
        if self._fired >= self._num_grads:
            # group sync: the LAST gradient of the backward drains every
            # handle (reference: byteps_torch_set_num_grads counting)
            self._sync_all()

    def _sync_all(self):
        for p, (handle, ctx) in self._handles.items():
            out = synchronize(handle)
            with torch.no_grad():
                p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()
        self._fired = 0

    def synchronize(self):
        """Drain the in-flight gradient reductions by hand: needed only
        when some requires_grad parameters are unused in a backward (the
        group count never fills — the reference's
        byteps_torch_set_num_grads contract); call it between backward()
        and optimizer.step() then."""
        self._sync_all()

    @contextmanager
    def no_sync(self):
        """Skip gradient sync inside the context (accumulation loops); the
        first backward after it syncs the accumulated gradients."""
        self._require_backward_grad_sync = False
        try:
            yield
        finally:
            self._require_backward_grad_sync = True
