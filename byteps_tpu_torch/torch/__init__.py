"""PyTorch plugin: the reference's ``byteps.torch`` API on the port's
runtime, CUDA tensors in and out (the port of ``byteps_tpu/torch/``).

The reference's largest plugin (reference: torch/__init__.py, ops.py,
cross_barrier.py) hooks every parameter's gradient accumulation,
push_pulls gradients asynchronously while backward still runs, and
drains the handles in ``step()``. The same surface here, one process per
GPU:

  - without the parameter server the reduction is a collective of the
    port's ``PushPullEngine`` over the data-parallel group (NCCL between
    cards, gloo on the CPU), issued on the thread that dispatches it;
  - with ``BPS_ENABLE_PS`` it is the engine's ``PSGradientExchange``, a
    CUDA gradient encoded on the card by the int8 and fp8 kernels;
  - at world 1 without PS nothing leaves the process.

Unlike the JAX package's plugin, whose tensors cross to the host and
which therefore defaults to its host-only mode, this one leaves the
gradients where they are: ``init`` does not set ``BPS_HOST_ONLY``.

Usage is byteps-torch-compatible::

    import byteps_tpu_torch.torch as bps
    bps.init()
    optimizer = bps.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())
    bps.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from __future__ import annotations

from .compression import Compression
from .cross_barrier import CrossBarrier
from .ops import (declare, init, local_rank, local_size, poll, push_pull,
                  push_pull_async, push_pull_async_inplace, rank, shutdown,
                  size, synchronize)
from .optimizer import (DistributedOptimizer, broadcast_optimizer_state,
                        broadcast_parameters)
from .parallel import DistributedDataParallel

__all__ = [
    "Compression", "CrossBarrier", "DistributedDataParallel",
    "DistributedOptimizer", "broadcast_optimizer_state",
    "broadcast_parameters", "declare", "init", "local_rank", "local_size",
    "poll", "push_pull", "push_pull_async", "push_pull_async_inplace",
    "rank", "shutdown", "size", "synchronize",
]
