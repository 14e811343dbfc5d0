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
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

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
