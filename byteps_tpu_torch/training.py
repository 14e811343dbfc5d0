"""High-level distributed trainer of the port (counterpart of the dense
data-parallel path and the sync parameter-server path of
``byteps_tpu/training.py::DistributedTrainer``).

The reference's ``DistributedTrainer`` (reference:
mxnet/__init__.py:164-345) owns the optimizer, push_pulls every gradient,
and steps locally. Here one process drives one GPU, BytePS's own model:
``step`` runs the user's loss on this process's batch, backpropagates,
and hands the gradients to ``optim.DistributedOptimizer`` (bucketed
all-reduce over the data-parallel group, or the compressed exchange when
``compression`` is given, then the inner step).

With ``BPS_ENABLE_PS=1`` (and ``bps.init()``, which builds the in-process
server) the same script trains through the parameter server instead, the
JAX trainer's sync PS branch (``training.py:228-299``, ``_ps_step``
``:563-599``): the local backward; ``PSGradientExchange.exchange`` of the
gradients in the JAX tree's order (encoded on the card under
``BPS_COMPRESS=int8`` or ``fp8_e4m3``); the summed gradients copied back
to the card (the port's PS runs one worker, so the sum is the mean); the
inner optimizer's step. ``compression`` kwargs in PS mode ride the
trainer's declaration (``byteps_tpu/training.py:243-244``): the exchange
gives each bucket at or above ``min_compress_bytes`` the legacy host chain
(``server/ps_mode.py``), which keeps precedence over the fused plane.
The port always runs that monolithic tail, the JAX package's
``BPS_APPLY_CHUNKED=0`` route: the streamed tail, the staged head, the
cross-step driver and the sharded update overlap work without changing a
number, and are not ported yet.

The async path, gradient accumulation in PS mode and pipeline
parallelism (``BPS_PP_STAGES`` > 1) are not ported yet (ROADMAP.md): their
options raise.

``ShardedTrainer`` is the data × sequence-parallel step (counterpart of
the JAX ``ShardedTrainer`` on a mesh whose only axes above 1 are
``data`` and ``seq``): each rank trains on the sequence shard of its data
shard, ring attention joins the shards, replicated parameters' gradients
are summed over the ``seq`` group and then all-reduced (or exchanged
compressed) over the ``data`` group by ``DistributedOptimizer``, at each
sync boundary of its gradient accumulation.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .common.config import Config
from .common.global_state import GlobalState, check_ps_config, resolve_device
from .obs.metrics import observe_stage
from .optim import DistributedOptimizer
from .parallel.collectives import bucketed_allreduce
from .parallel.mesh import Mesh, data_group, dp_size, use_mesh

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
      reducer: ``reducer(buf, group) -> buf``, the collective of each
        gradient bucket in place of the sum (``parallel.collectives.
        Reducer``); None for the sum. Like compression it runs at world 1
        too (``group`` None there), as the JAX trainer keeps the size-1
        data axis for it. PS mode refuses it (ValueError), as the JAX
        trainer does.
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
      name: the PS declaration name of the gradients (PS mode); defaults
        to a hash of the parameters' names, shapes and dtypes, with
        positional suffixes for later trainers of the same structure.
    """

    # per-structure-hash creation counts (never pruned: a freed name could
    # alias a live server's keys)
    _name_counts: dict = {}

    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 partition_bytes: Optional[int] = None,
                 backward_passes_per_step: int = 1,
                 reducer=None, compression: Optional[dict] = None,
                 min_compress_bytes: Optional[int] = None,
                 device=None, group=None, name: Optional[str] = None) -> None:
        gs = GlobalState._instance
        cfg = gs.config if gs is not None else Config.from_env()
        if cfg.pp_stages > 1:
            # the JAX trainer's refusal (byteps_tpu/training.py:164-173)
            raise ValueError(
                f"BPS_PP_STAGES={cfg.pp_stages}: DistributedTrainer is the "
                f"data-parallel step — its whole-model step would silently "
                f"train only replicas; pipeline parallelism {_NOT_PORTED}")
        check_ps_config(cfg)
        if device is None and gs is not None:
            self.device = gs.device
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.backward_passes_per_step = backward_passes_per_step
        self._loss_fn = loss_fn
        self.step_count = 0
        self.ps_exchange = None
        if cfg.enable_ps:
            if reducer is not None:
                # the JAX trainer's refusal (byteps_tpu/training.py:238-242)
                raise ValueError(
                    "custom reducers run on the collective path and would "
                    "be silently unused in PS mode — express lossy "
                    "exchange via compression kwargs instead")
            self._init_ps(gs, optimizer, partition_bytes,
                          backward_passes_per_step, compression,
                          min_compress_bytes, name)
            return
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
                                else min_compress_bytes),
            reducer=reducer)

    # ------------------------------------------------------------ PS mode

    def _init_ps(self, gs, optimizer, partition_bytes,
                 backward_passes_per_step, compression, min_compress_bytes,
                 name) -> None:
        if gs is None or gs.ps_backend is None:
            raise RuntimeError("BPS_ENABLE_PS: call bps.init() first; it "
                               "builds the parameter-server backend")
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                f"backward_passes_per_step > 1 in PS mode {_NOT_PORTED}")
        from .server.ps_mode import PSGradientExchange
        cfg = gs.config
        # the JAX tree's flatten order: dotted names sorted by path
        self._ps_params = sorted(self.model.named_parameters(),
                                 key=lambda kv: kv[0].split("."))
        if name is None:
            sig = "|".join(f"{n}:{tuple(p.shape)}:{p.dtype}"
                           for n, p in self._ps_params)
            base = "trainer-" + hashlib.sha1(sig.encode()).hexdigest()[:10]
            n = DistributedTrainer._name_counts.get(base, 0)
            DistributedTrainer._name_counts[base] = n + 1
            name = base if n == 0 else f"{base}-{n}"
        self._name = name
        # declared now, before any other tree: keys follow declaration
        # order, and the fp8 noise seed follows the keys. The compression
        # kwargs ride the declaration: the exchange gives each bucket at or
        # above the floor its host chain (byteps_tpu/training.py:243-244)
        gs.registry.declare(name, **(compression or {}))
        self.ps_exchange = PSGradientExchange(
            gs.ps_backend,
            partition_bytes=(cfg.partition_bytes if partition_bytes is None
                             else partition_bytes),
            registry=gs.registry,
            min_compress_bytes=(cfg.min_compress_bytes
                                if min_compress_bytes is None
                                else min_compress_bytes),
            watchdog_sec=cfg.watchdog_sec, compress=cfg.compress,
            device=self.device)
        gs.exchanges.append(self.ps_exchange)
        self.tx = optimizer          # the plain inner optimizer

    def _ps_step(self) -> None:
        """Exchange the gradients through the server, copy the sum back
        to the card, step the inner optimizer."""
        grads = []
        for n, p in self._ps_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append((n, p.grad))
        t0 = time.time()
        summed = self.ps_exchange.exchange(grads, name=self._name)
        observe_stage("PS_PUSH_PULL", time.time() - t0)
        t0 = time.time()
        with torch.no_grad():
            for (_, g), s in zip(grads, summed):
                g.copy_(torch.from_numpy(s).view_as(g), non_blocking=False)
        observe_stage("PS_H2D", time.time() - t0)
        self.tx.step()
        self.tx.zero_grad(set_to_none=True)

    def close(self) -> None:
        """Stop the PS exchange's threads (``bps.shutdown()`` does too)."""
        if self.ps_exchange is not None:
            self.ps_exchange.close()

    # ---------------------------------------------------------------- step

    def step(self, batch) -> torch.Tensor:
        """One training step on this process's batch (numpy or tensors);
        returns the loss averaged over the data-parallel group (in PS mode
        this process's loss), detached and still on the device."""
        batch = _to_device(batch, self.device)
        loss = self._loss_fn(self.model, batch)
        loss.backward()
        if self.ps_exchange is not None:
            self._ps_step()
            self.step_count += 1
            return loss.detach()
        self.tx.step()
        self.step_count += 1
        loss = loss.detach()
        n = dp_size(self.group)
        if n > 1:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=self.group)
            loss = loss / n
        return loss


def _shard(x, rows: slice, cols: slice):
    """This rank's block of a global batch leaf: rows on the data axis,
    the sequence (dim 1) on the seq axis."""
    if isinstance(x, (tuple, list)):
        return type(x)(_shard(v, rows, cols) for v in x)
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x[rows, cols] if x.ndim >= 2 else x[rows])
    if torch.is_tensor(x):
        return (x[rows, cols] if x.ndim >= 2 else x[rows]).contiguous()
    return x


class ShardedTrainer:
    """The data × sequence-parallel train step on a ``parallel.mesh``
    mesh (counterpart of ``byteps_tpu/training.py::ShardedTrainer``,
    ``:1106-1215``, for meshes of ``data`` and ``seq`` axes).

    Args:
      loss_fn: ``loss_fn(model, batch) -> scalar``, the global loss on
        every rank (the models' losses under ``sp_axis`` sum over the
        ``seq`` axis before dividing).
      model: an ``nn.Module`` whose config names the mesh's ``seq`` axis
        as its ``sp_axis``; moved to ``device``.
      optimizer: the inner ``torch.optim`` optimizer.
      mesh: ``parallel.mesh.make_mesh({"data": dp, "seq": sp})``; size-1
        axes are kept (a ``seq`` axis of 1 is a ring of one).
      partition_bytes: the data all-reduce's bucket size (default
        ``BPS_PARTITION_BYTES``).
      device: None means the card (``cuda``) and raises without one.
      compression: the reference's compression kwargs, as in
        ``DistributedTrainer``: the exchange runs over the ``data`` axis
        only (at size 1 too: only the collective is skipped), with this
        rank's own compressor state, as the JAX trainer keeps one state
        per device of the whole mesh.
      min_compress_bytes: buckets below it skip compression (default
        ``BPS_MIN_COMPRESS_BYTES``).
      backward_passes_per_step: local gradient accumulation. The
        accumulators hold this rank's local gradients between sync
        boundaries; at a boundary the ``seq`` sum and the ``data``
        exchange run once, on the accumulated sum (the sum over ``seq``
        commutes with the accumulation), and the mean over the window is
        stepped, as the JAX trainer's ``optax.MultiSteps`` takes it.

    ``step(batch)`` takes the GLOBAL batch (every rank the same), whose
    leaves are [batch, seq, ...] (or [batch]): rank (i, j) of the mesh
    trains on rows i of ``data`` and sequence block j of ``seq``. The
    gradients are those of the global loss: each rank's share (the
    backward of the loss's seq sum is the identity) summed over the
    ``seq`` group, then averaged over the ``data`` group with the
    bucketed all-reduce, as the JAX trainer's psum-then-rescale gives
    them. The returned loss is the global one averaged over ``data``,
    every micro-step.

    Tensor, pipeline and expert parallelism (mesh axes ``model``,
    ``pipe``, ``expert`` and ``dcn`` above 1) and a ``param_spec_tree``
    are not ported (ROADMAP.md): they raise.
    """

    def __init__(self, loss_fn: Callable, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, mesh: Mesh,
                 partition_bytes: Optional[int] = None, device=None,
                 param_spec_tree=None, compression: Optional[dict] = None,
                 backward_passes_per_step: int = 1,
                 min_compress_bytes: Optional[int] = None) -> None:
        over = [a for a in ("model", "pipe", "expert", "dcn")
                if mesh.size(a) > 1]
        if over:
            raise NotImplementedError(
                f"mesh axes {over}: tensor, pipeline and expert parallelism "
                f"{_NOT_PORTED}")
        if param_spec_tree is not None:
            raise NotImplementedError(f"param_spec_tree (sharded parameters) "
                                      f"{_NOT_PORTED}")
        gs = GlobalState._instance
        cfg = gs.config if gs is not None else Config.from_env()
        if device is None and gs is not None:
            self.device = gs.device
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self._loss_fn = loss_fn
        self._seq = mesh.ring("seq") if "seq" in mesh.shape else None
        with use_mesh(mesh):    # the plan's world: the data axis's size
            self.tx = DistributedOptimizer(
                optimizer, named_parameters=self.model.named_parameters(),
                group=data_group(),
                partition_bytes=(cfg.partition_bytes if partition_bytes is None
                                 else partition_bytes),
                backward_passes_per_step=backward_passes_per_step,
                compression=compression,
                min_compress_bytes=(cfg.min_compress_bytes
                                    if min_compress_bytes is None
                                    else min_compress_bytes))
        self.step_count = 0

    def shard_batch(self, batch):
        """This rank's block of the global ``batch``."""
        def block(axis, n):
            if axis not in self.mesh.shape:
                return slice(None)
            r = self.mesh.ring(axis)
            if n % r.size:
                raise ValueError(f"dim of {n} does not split over the "
                                 f"{r.size} ranks of {axis!r}")
            return slice(r.index * (n // r.size), (r.index + 1) * (n // r.size))

        leaf = batch[0] if isinstance(batch, (tuple, list)) else batch
        rows = block("data", leaf.shape[0])
        cols = block("seq", leaf.shape[1]) if leaf.ndim >= 2 else slice(None)
        return _shard(batch, rows, cols)

    def step(self, batch) -> torch.Tensor:
        """One step (a micro-step under accumulation) on the global
        ``batch``; returns the global loss averaged over the data group,
        detached, on the device."""
        batch = _to_device(self.shard_batch(batch), self.device)
        with use_mesh(self.mesh):
            loss = self._loss_fn(self.model, batch)
            loss.backward()
            if (self._seq is not None and self._seq.size > 1
                    and self.tx.syncs_next()):
                grads = []
                for p in self.model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    grads.append(p.grad)
                with torch.no_grad():
                    bucketed_allreduce(grads, group=self._seq.group,
                                       partition_bytes=self.tx.partition_bytes,
                                       average=False)
            self.tx.step()
            loss = loss.detach()
            n = dp_size()
            if n > 1:
                dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=data_group())
                loss = loss / n
        self.step_count += 1
        return loss

