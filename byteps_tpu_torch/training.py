"""High-level distributed trainer of the port (counterpart of the dense
data-parallel path of ``byteps_tpu/training.py::DistributedTrainer``).

The reference's ``DistributedTrainer`` (reference:
mxnet/__init__.py:164-345) owns the optimizer, push_pulls every gradient,
and steps locally. Here one process drives one GPU, BytePS's own model:
``step`` runs the user's loss on this process's batch, backpropagates,
and hands the gradients to ``optim.DistributedOptimizer`` (bucketed
all-reduce over the data-parallel group, or the compressed exchange when
``compression`` is given, then the inner step).

The parameter-server and async paths of the JAX trainer and custom
reducers are not ported yet (ROADMAP.md): their options raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .common.config import Config
from .common.global_state import GlobalState, resolve_device
from .optim import DistributedOptimizer
from .parallel.mesh import data_group, dp_size

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port')"


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device, non_blocking=True)
    if torch.is_tensor(x):
        return x.to(device, non_blocking=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    return x


class DistributedTrainer:
    """Owns the model, the optimizer and the distributed train step.

    Args:
      loss_fn: ``loss_fn(model, batch) -> scalar`` on this process's batch.
      model: an ``nn.Module``; moved to ``device``.
      optimizer: the inner ``torch.optim`` optimizer over the model's
        parameters (``optim.adamw`` gives optax's AdamW defaults).
      partition_bytes: all-reduce bucket size (default
        ``BPS_PARTITION_BYTES``).
      backward_passes_per_step: local gradient accumulation (reference:
        torch/__init__.py:83-113).
      compression: gradient compression kwargs in the reference's format,
        e.g. ``{"compressor_type": "onebit",
        "compressor_onebit_scaling": "true", "ef_type": "vanilla",
        "momentum_type": "nesterov"}``; None for the dense all-reduce.
      min_compress_bytes: buckets below it skip compression (default
        ``BPS_MIN_COMPRESS_BYTES``).
      device: where the step runs; None means the card (``cuda``) and
        raises when none is present. Tests pass ``"cpu"``.
      group: the data-parallel process group (default: the one ``init()``
        joined; none at world 1).
    """

    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 partition_bytes: Optional[int] = None,
                 backward_passes_per_step: int = 1,
                 reducer=None, compression: Optional[dict] = None,
                 min_compress_bytes: Optional[int] = None,
                 device=None, group=None) -> None:
        if reducer is not None:
            raise NotImplementedError(f"custom reducers: the port {_NOT_PORTED}")
        gs = GlobalState._instance
        cfg = gs.config if gs is not None else Config.from_env()
        if cfg.enable_ps:
            raise NotImplementedError(
                f"the parameter-server path (BPS_ENABLE_PS) {_NOT_PORTED}")
        if cfg.enable_async:
            raise NotImplementedError(
                f"the async parameter-server path (BPS_ENABLE_ASYNC) "
                f"{_NOT_PORTED}")
        if device is None and gs is not None:
            self.device = gs.device
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.group = group if group is not None else data_group()
        self.tx = DistributedOptimizer(
            optimizer, named_parameters=self.model.named_parameters(),
            group=self.group,
            partition_bytes=(cfg.partition_bytes if partition_bytes is None
                             else partition_bytes),
            backward_passes_per_step=backward_passes_per_step,
            compression=compression,
            min_compress_bytes=(cfg.min_compress_bytes
                                if min_compress_bytes is None
                                else min_compress_bytes))
        self.backward_passes_per_step = backward_passes_per_step
        self._loss_fn = loss_fn
        self.step_count = 0

    def step(self, batch) -> torch.Tensor:
        """One training step on this process's batch (numpy or tensors);
        returns the loss averaged over the data-parallel group, detached
        and still on the device."""
        batch = _to_device(batch, self.device)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        self.tx.step()
        self.step_count += 1
        loss = loss.detach()
        n = dp_size(self.group)
        if n > 1:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=self.group)
            loss = loss / n
        return loss
