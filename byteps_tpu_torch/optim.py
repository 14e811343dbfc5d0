"""Distributed optimizer wrapper of the port (counterpart of
``byteps_tpu/optim.py::distributed_optimizer``).

The reference wraps each framework's optimizer so that every gradient is
push_pulled before the local update (reference: torch/__init__.py:115-174
_DistributedOptimizer), with gradient accumulation via
``backward_passes_per_step`` (torch/__init__.py:83-113). Here the wrapper
holds an inner ``torch.optim`` optimizer: at each sync boundary it runs
the bucketed all-reduce over the data-parallel group, then
``inner.step()``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from .parallel.collectives import bucketed_allreduce


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
    """

    def __init__(self, inner: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 group=None, partition_bytes: int = 4 << 20,
                 backward_passes_per_step: int = 1) -> None:
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.inner = inner
        self.group = group
        self.partition_bytes = partition_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self._params = [p for g in inner.param_groups for p in g["params"]]
        names = {id(p): n for n, p in (named_parameters or ())}
        self._names = [names.get(id(p), str(i))
                       for i, p in enumerate(self._params)]
        self._passes = 0

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
            bucketed_allreduce(grads, group=self.group,
                               partition_bytes=self.partition_bytes,
                               average=True, names=self._names)
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        return True


def distributed_optimizer(inner: torch.optim.Optimizer, **kwargs
                          ) -> DistributedOptimizer:
    return DistributedOptimizer(inner, **kwargs)
