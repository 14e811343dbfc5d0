"""byteps_tpu_torch — the PyTorch/CUDA port of byteps_tpu.

A second package beside the JAX one: the same module layout and names,
idiomatic PyTorch inside, and hand-written Hopper kernels where the JAX
package has Pallas kernels. It imports nothing of JAX or of ``byteps_tpu``.
The public surface keeps the reference's Horovod-style names
(reference: byteps/common/__init__.py:59-139, byteps/torch/__init__.py):

    import byteps_tpu_torch as bps
    bps.init()                     # one process per GPU, env-configured
    grads = bps.push_pull(grads)   # this rank's tensors, bucketed
    trainer = bps.DistributedTrainer(loss_fn, model, optimizer)
    loss = trainer.step(batch)     # bucketed all-reduce + inner step

One process drives one GPU, so every call takes THIS rank's tensors and
returns their sum or mean over the data-parallel group, where the JAX
package's single controller takes stacked ``[dp, ...]`` leaves. The
reference's torch plugin is ``byteps_tpu_torch.torch``.

Entry points run on the card unless the caller asks for the CPU.

This module never names PyTorch ``torch`` at module level: once
``byteps_tpu_torch.torch`` (the plugin) is imported, Python binds that
submodule as this package's attribute ``torch``, which is this module's
global of the same name.
"""

from __future__ import annotations

from typing import Optional

import torch as _torch
import torch.distributed as dist

from .common.config import Config
from .common.global_state import GlobalState

__version__ = "0.1.0"

# PyTorch's CPU exp sets itself up on its first call. When that call is
# split across threads, one thread's share can come out of a low-accuracy
# path (errors near 1e-4, so the plain versions' softmax misses 1e-5 in
# about one process in four under load). One call on one element sets it
# up on this thread first.
_torch.exp(_torch.zeros(1))

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port'"

_suspended = None        # (registry, device) between suspend/resume


# -- lifecycle (reference: operations.cc:34-129) ----------------------------

def init(config: Optional[Config] = None, device=None, init_method=None,
         timeout=None) -> None:
    """Initialise the runtime (reference: byteps_init, operations.cc:36-88)."""
    GlobalState.init(config, device=device, init_method=init_method,
                     timeout=timeout)


def shutdown() -> None:
    GlobalState.shutdown()


def suspend() -> None:
    """Tear down, remembering the tensor declarations (reference:
    byteps_suspend)."""
    global _suspended
    dev = GlobalState.get().device if GlobalState.initialized() else None
    _suspended = (GlobalState.suspend(), dev)


def resume(num_worker: Optional[int] = None, config: Optional[Config] = None,
           device=None, init_method=None, timeout=None) -> None:
    """Init again after a membership change, replaying the declarations
    so name→key stays the same (reference: byteps_resume,
    operations.cc:96-112). The config comes from the environment, with
    ``num_worker`` over it; the device is the suspended one unless given."""
    global _suspended
    registry, dev = _suspended or (None, None)
    if config is None:
        config = Config.from_env(**({} if num_worker is None
                                    else {"num_worker": num_worker}))
    GlobalState.resume(registry, config, device=device or dev,
                       init_method=init_method, timeout=timeout)
    _suspended = None


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


def replica_ranks() -> range:
    """The data-parallel replica slots this process owns: one process per
    GPU owns exactly ``rank()`` (the JAX package's single controller owns
    several, hence the helper)."""
    return range(rank(), rank() + 1)


# -- observability ----------------------------------------------------------

def get_metrics():
    """The process-wide metrics registry (counters, gauges, per-stage
    latency histograms); recording obeys ``BPS_STATS``."""
    from .obs.metrics import get_registry
    return get_registry()


def get_pushpull_speed() -> float:
    """MB/s over a 10 s sliding window (reference: global.cc:697-752);
    0.0 unless ``BPS_TELEMETRY_ON`` is set."""
    t = GlobalState.get().telemetry
    return t.mbps() if t is not None else 0.0


# -- data plane -------------------------------------------------------------

def declare_tensor(name: str, priority: Optional[int] = None, **kwargs) -> int:
    """Pre-declare a tensor (reference: byteps_declare_tensor /
    IsTensorDeclared); returns its stable key. A ``priority`` (higher goes
    first) reorders the buckets of every tree holding the name."""
    return GlobalState.get().registry.declare(
        name, priority=priority, **kwargs).declared_key


def push_pull(tree, average: bool = True, name: Optional[str] = None):
    """Sum (``average``: mean) a tree of this rank's tensors over the
    data-parallel group — the reference's push_pull ≡ allreduce
    (common/__init__.py:83-100). Returns a tree of new tensors; in PS mode
    the sum runs through the parameter server."""
    return GlobalState.get().engine.push_pull(tree, average=average, name=name)


def push_pull_async(tree, average: bool = True,
                    name: Optional[str] = None) -> int:
    """Dispatch ``push_pull`` and return an int handle (reference:
    torch/ops.py push_pull_async + handle_manager)."""
    return GlobalState.get().engine.push_pull_async(tree, average=average,
                                                    name=name)


def push_pull_rowsparse(indices, rows, num_rows: int, average: bool = False,
                        name: str = "rowsparse"):
    """Row-sparse push_pull (``byteps_tpu/__init__.py:228-261``): this
    worker pushes only the touched (row index, row) pairs of a ``[num_rows,
    cols]`` table and gets back the dense table summed over the PS workers
    (``average``: divided by them), a tensor on ``rows``' device.
    ``indices``: any integer dtype, ``[n]``; ``rows``: ``[n, cols]`` on any
    device, moved to the host once. Duplicate indices within a push sum, in
    index order (scatter-add). The reference reserved this request type
    (kRowSparsePushPull, common.h:267-271) but shipped no handler; here it
    rides the sync PS path (``BPS_ENABLE_PS=1``), whose server scatters
    each worker's rows into a dense table and sums. Distinct tables need
    distinct names; each round is pulled at its own number."""
    gs = GlobalState.get()
    eng = gs.engine
    if eng.ps_factory is None:
        if gs.ps_backend is not None:
            raise NotImplementedError(
                "row-sparse push_pull needs SYNC PS mode — drop "
                "BPS_ENABLE_ASYNC (the async store folds weight deltas, "
                "not per-round gradient merges)")
        raise NotImplementedError(
            "row-sparse push_pull rides the PS path — run with "
            "BPS_ENABLE_PS=1 (sync mode); the collective path has no "
            "sparse win (an all-reduce is dense)")
    if rows.dtype == _torch.bfloat16:
        raise TypeError("push_pull_rowsparse: bfloat16 rows have no numpy "
                        "scatter-add on the host; pass float32 rows")
    rsx = getattr(eng, "_rs_exchange", None)
    if rsx is None:
        from .server.ps_mode import RowSparseExchange
        rsx = eng._rs_exchange = RowSparseExchange(gs.ps_backend,
                                                   gs.registry)
    idx = indices.detach().reshape(-1).to("cpu", _torch.int32).numpy()
    host = rows.detach().to("cpu").contiguous().numpy()
    out = rsx.exchange(idx, host, num_rows, name)
    if average and eng.ps_world > 1:
        out = out / eng.ps_world
    return _torch.from_numpy(out).to(rows.device)


def poll(handle: int) -> bool:
    """True once the handle's reduction has completed."""
    return GlobalState.get().engine.poll(handle)


def synchronize(handle: int):
    """Block until the handle's reduction is done; return its tree. A
    handle is single-use."""
    return GlobalState.get().engine.synchronize(handle)


def broadcast_parameters(tree, root_rank: int = 0):
    """Root's tensors to every rank (reference: torch/__init__.py:259-291):
    returns a tree of new tensors holding root's values, bit for bit.
    Every rank passes its own tensors (one process per GPU: there is no
    stacked ``[dp, ...]`` convention to choose, as the JAX package's
    ``stacked`` argument does); leaves that are not tensors pass through."""
    return GlobalState.get().engine.broadcast(tree, root_rank)


def broadcast_optimizer_state(opt_state, root_rank: int = 0):
    """Root's optimizer state to every rank, with ``broadcast_parameters``'
    per-leaf semantics: tensors take root's values, anything else (step
    counts as Python numbers, hyper-parameters) passes through. The torch
    plugin's ``broadcast_optimizer_state`` takes an optimizer instead."""
    return GlobalState.get().engine.broadcast(opt_state, root_rank)


# -- high-level wrappers ----------------------------------------------------

def DistributedOptimizer(*args, **kwargs):
    from .optim import DistributedOptimizer as _DO
    return _DO(*args, **kwargs)


def DistributedTrainer(*args, **kwargs):
    from .training import DistributedTrainer as _DT
    return _DT(*args, **kwargs)


class _NotPortedMeta(type):
    def __getattr__(cls, item):
        raise NotImplementedError(cls._why)


def _not_ported(name: str, what: str, queue: int) -> type:
    """A name of the JAX package's surface whose feature the port does not
    have: calling it or reading from it raises."""
    why = f"{what} {_NOT_PORTED}, queue {queue})"

    def __new__(cls, *args, **kwargs):
        raise NotImplementedError(why)
    return _NotPortedMeta(name, (), {"_why": why, "__new__": __new__,
                                     "__doc__": why})


MirroredStrategy = _not_ported("MirroredStrategy",
                               "the strategy-style API (strategy.py)", 10)
# the JAX package's compat names; the torch plugin
# (``byteps_tpu_torch.torch``) has the reference's own DistributedDataParallel
# and Compression
DistributedDataParallel = _not_ported(
    "DistributedDataParallel", "compat.DistributedDataParallel", 10)
DistributedGradientTape = _not_ported(
    "DistributedGradientTape", "compat.DistributedGradientTape", 10)
Compression = _not_ported("Compression", "compat.Compression", 10)


__all__ = [
    "init", "shutdown", "suspend", "resume", "rank", "size", "local_rank",
    "local_size", "replica_ranks", "declare_tensor", "push_pull",
    "push_pull_async", "push_pull_rowsparse", "poll", "synchronize",
    "broadcast_parameters", "broadcast_optimizer_state",
    "get_pushpull_speed", "get_metrics", "DistributedOptimizer",
    "DistributedTrainer", "MirroredStrategy", "DistributedDataParallel",
    "DistributedGradientTape", "Compression", "Config", "__version__",
]
