"""byteps_tpu_torch — the PyTorch/CUDA port of byteps_tpu.

A second package beside the JAX one: the same module layout and names,
idiomatic PyTorch inside, and hand-written Hopper kernels where the JAX
package has Pallas kernels. It imports nothing of JAX or of ``byteps_tpu``.
The public surface keeps the reference's Horovod-style names
(reference: byteps/common/__init__.py:59-139, byteps/torch/__init__.py):

    import byteps_tpu_torch as bps
    bps.init()                     # one process per GPU, env-configured
    trainer = DistributedTrainer(loss_fn, model, optimizer)
    loss = trainer.step(batch)     # bucketed all-reduce + inner step

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .common.config import Config
from .common.global_state import GlobalState

__version__ = "0.1.0"

# PyTorch's CPU exp sets itself up on its first call. When that call is
# split across threads, one thread's share can come out of a low-accuracy
# path (errors near 1e-4, so the plain versions' softmax misses 1e-5 in
# about one process in four under load). One call on one element sets it
# up on this thread first.
torch.exp(torch.zeros(1))


# -- lifecycle (reference: operations.cc:34-129) ----------------------------

def init(config: Optional[Config] = None, device=None, init_method=None,
         timeout=None) -> None:
    """Initialise the runtime (reference: byteps_init, operations.cc:36-88)."""
    GlobalState.init(config, device=device, init_method=init_method,
                     timeout=timeout)


def shutdown() -> None:
    GlobalState.shutdown()


# -- topology queries (reference: operations.cc:121-129) --------------------

def _config() -> Config:
    return GlobalState.get().config if GlobalState.initialized() \
        else Config.from_env()


def rank() -> int:
    """This process's data-parallel rank in ``[0, size())``."""
    if dist.is_initialized():
        return dist.get_rank()
    return _config().worker_id


def size() -> int:
    """Total number of data-parallel replicas (reference: byteps_size)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_rank() -> int:
    return _config().local_rank


def local_size() -> int:
    return _config().local_size
