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

With ``BPS_ENABLE_PS=1`` (and ``bps.init()``, which builds the server
backend: in process at world 1, ``BPS_SERVER_ADDRS`` for standalone servers
that ``BPS_NUM_WORKER`` worker processes share) the same script trains
through the parameter server instead, the JAX trainer's sync PS branch
(``byteps_tpu/training.py:228-299``): the gradients go through
``PSGradientExchange`` in the JAX tree's order (encoded on the card under
``BPS_COMPRESS=int8`` or ``fp8_e4m3``), the summed gradients are divided by
the worker count on the host and come back to the card, and the inner
optimizer steps. ``compression`` kwargs
in PS mode ride the trainer's declaration (``byteps_tpu/training.py:243-244``):
the exchange gives each bucket at or above ``min_compress_bytes`` the legacy
host chain (``server/ps_mode.py``), which keeps precedence over the fused
plane.

By default the PS step is the JAX package's full BytePS pipeline, bwd ∥ push
∥ server sum ∥ pull ∥ apply (``byteps_tpu/training.py:254-290``), in three
parts that each change no number:

  - the staged head (``BPS_BWD_STAGED``, default 1): a
    ``register_post_accumulate_grad_hook`` on every parameter hands each
    gradient, with a CUDA event recorded where autograd produced it, to an
    ``exchange_ingest`` round; a bucket group (``BPS_BWD_GROUPS`` > 0 caps
    their number) is fed when its last leaf landed, and its buckets' encode
    or D2H and push start on side streams while earlier layers are still
    being differentiated. The backward itself is unchanged, so the
    gradients are the monolithic head's bit for bit;
  - the streamed tail (``BPS_APPLY_CHUNKED``, default 1): each summed leaf
    is copied to the card as its last bucket's pull lands (pinned buffers,
    ``non_blocking`` on a side stream, ``staging.py``), and the optimizer
    is applied per bucket group as the group completes
    (``optim.ChunkedApply``, bit for bit the fused step; an optimizer the
    probe finds coupled keeps the fused step). A failure after some groups
    applied raises loudly: the step is partial;
  - the cross-step driver (``BPS_CROSS_STEP``, default 1;
    ``cross_step.py``): from the second step, ``step()`` returns after the
    backward, the tail runs on a background thread, and the next forward
    is gated per module on the applies it reads. ``model``, ``tx``,
    ``state_dict()`` and ``drain()`` wait for the tails;
    ``load_state_dict`` installs fresh state over them.

``BPS_APPLY_CHUNKED=0`` is the monolithic tail (every bucket pulled, the
whole tree copied back, one optimizer step); the staged head and the
cross-step driver ride on the streamed tail and switch off with it, as in
the JAX trainer. ``backward_passes_per_step`` > 1 accumulates the JAX
package's running mean in fp32 on the card, ``acc + (g - acc) / n``, and
exchanges it at the window's end through the streamed tail (the staged
head stays off, ``byteps_tpu/training.py:517-518``).

``BPS_SHARDED_UPDATE=1`` (with ``BPS_NUM_WORKER`` > 1) shards the streamed
tail across the workers (``BPS_SHARD_WORLD`` of them, default
``BPS_NUM_WORKER``; ``sharded_update.py``, the JAX trainer's
``byteps_tpu/training.py:305-330``): each worker still pushes every bucket,
but pulls and applies only the bucket groups it owns (``shard_rank=``,
default ``BPS_SHARD_RANK``, else ``BPS_WORKER_ID``), publishes their
updated parameters through the server's param mailbox, and installs the
other groups from their owners' frames, as they are (a pulled sum is
divided by the workers, a fetched parameter never is). The optimizer then
holds state for the owned groups only. It needs the streamed tail and
``backward_passes_per_step`` 1, and is built at the first step, where a
case it cannot serve keeps the full update with one INFO line; both the
draining and the cross-step tails run it. A failed sharded step raises: it
may be partial. ``reshard(live)`` changes the membership at a step
boundary (every worker calls it; it drains first, and the moved groups'
optimizer state hands off through the server), and
``checkpoint.save_sharded_checkpoint`` / ``restore_sharded`` save and
restore each worker's owned slices of the optimizer state with the
owner map; the full-tree checkpoints of ``checkpoint.py`` take
``state_dict()``.

``BPS_MAX_LAG=K`` > 1 (bounded staleness; ``BPS_LAG_GRACE_MS`` on the
server) sends the dense buckets through the server's versioned round
store with this worker's id (``BPS_WORKER_ID``), and lets the cross-step
driver's forward of step e read epoch e-K or later (``cross_step.py``
says how the in-place applies stay out of its way). K > 1 together with
the sharded update raises NotImplementedError.

``BPS_ENABLE_ASYNC=1`` (with ``BPS_ENABLE_PS``) is the JAX trainer's
async PS branch (``byteps_tpu/training.py:179-227``, its step ``:1019-1046``):
no gradient exchange, no staged head, streamed tail, cross-step driver or
sharded update. Each step runs the forward and backward (accumulated over
``backward_passes_per_step``), keeps a copy of the parameters on the card,
applies the local optimizer, computes the delta new − old on the card in
the wire dtype (``BPS_ASYNC_WIRE_DTYPE``), pushes every leaf's delta
through ``server/ps_mode.py::AsyncPSWorker``, pulls every leaf's weights
from the store and copies them into the parameters in place. The pulled
weights land after the backward and before the next forward, on the
step's own thread and stream, so no forward reads a leaf mid-copy. The
optimizer's state stays this worker's own. As in the JAX package, the
pull right after the pushes may read a store in which the server's engine
has not yet folded this worker's own delta (ROADMAP.md, queue 3,
"Deliberate differences": kept from the reference). A custom reducer and
``compression`` raise ValueError, as in the JAX trainer; ``BPS_MAX_LAG`` >
1 and ``BPS_SHARDED_UPDATE=1``, which its async branch never reads, raise
NotImplementedError.

Pipeline parallelism (``BPS_PP_STAGES`` > 1) is not ported yet
(ROADMAP.md): it raises.

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
import os
import threading
import time
import weakref
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .common.config import Config
from .common.global_state import GlobalState, check_ps_config, resolve_device
from .obs.metrics import get_registry, observe_stage
from .optim import ChunkedApply, DistributedOptimizer
from .server.admission import resolve_max_lag
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


def _runs(groups: List[List[int]], cap: int) -> List[List[int]]:
    """``groups`` merged into at most ``cap`` contiguous runs of near-equal
    count, each run one list of leaves."""
    if cap <= 0 or cap >= len(groups):
        return [list(g) for g in groups]
    out, n = [], len(groups)
    for r in range(cap):
        lo, hi = r * n // cap, (r + 1) * n // cap
        out.append([li for g in groups[lo:hi] for li in g])
    return out


class _HeadFeed:
    """One staged backward's hand-over: gradients land one leaf at a time
    (autograd's device thread calls ``landed``); a feed batch goes to the
    ingest round the moment its last leaf landed."""

    def __init__(self, handle, batches: List[List[int]]) -> None:
        self.handle = handle
        self.batches = batches
        self.batch_of = {li: bi for bi, b in enumerate(batches) for li in b}
        self.need = [len(b) for b in batches]
        self.pending: List[list] = [[] for _ in batches]
        self.landed_ids: set = set()
        self.lock = threading.Lock()

    def landed(self, li: int, grad, event) -> None:
        with self.lock:
            if li in self.landed_ids:
                raise RuntimeError(
                    f"the gradient of leaf {li} landed twice in one backward "
                    f"(a reentrant checkpoint?): the staged head feeds each "
                    f"leaf once; run with BPS_BWD_STAGED=0")
            self.landed_ids.add(li)
            bi = self.batch_of[li]
            self.pending[bi].append((li, grad, event))
            self.need[bi] -= 1
            items = self.pending[bi] if self.need[bi] == 0 else None
        if items:
            self.handle.feed([i for i, _, _ in items],
                             [g for _, g, _ in items],
                             [e for _, _, e in items])

    def flush(self, params) -> None:
        """After the backward: the leaves whose hook never fired (no
        gradient) are fed as zeros, as the monolithic head sends them."""
        for bi, b in enumerate(self.batches):
            with self.lock:
                rest = [li for li in b if li not in self.landed_ids]
                if not rest:
                    continue
                items = self.pending[bi]
                self.landed_ids.update(rest)
                self.need[bi] = 0
            items = items + [(li, torch.zeros_like(params[li]), None)
                             for li in rest]
            self.handle.feed([i for i, _, _ in items],
                             [g for _, g, _ in items],
                             [e for _, _, e in items])


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
      shard_rank: this worker's ownership rank under
        ``BPS_SHARDED_UPDATE`` (default ``BPS_SHARD_RANK``, else
        ``BPS_WORKER_ID``).

    In PS mode the cross-step driver may still be applying the last
    step's update when ``step()`` returns: read the weights through
    ``model``, ``tx`` or ``state_dict()``, which wait for it (``drain()``
    is the explicit barrier), and install weights through
    ``load_state_dict``.
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
                 device=None, group=None, name: Optional[str] = None,
                 shard_rank: Optional[int] = None) -> None:
        gs = GlobalState._instance
        cfg = gs.config if gs is not None else Config.from_env()
        if cfg.pp_stages > 1:
            # the JAX trainer's refusal (byteps_tpu/training.py:164-173)
            raise ValueError(
                f"BPS_PP_STAGES={cfg.pp_stages}: DistributedTrainer is the "
                f"data-parallel step — its whole-model step would silently "
                f"train only replicas; pipeline parallelism {_NOT_PORTED}")
        check_ps_config(cfg)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if device is None and gs is not None:
            self.device = gs.device
        else:
            self.device = resolve_device(device)
        self._model = model.to(self.device)
        self.backward_passes_per_step = backward_passes_per_step
        self._loss_fn = loss_fn
        self.step_count = 0
        self.ps_exchange = None
        self._cross_driver = None
        self._async_worker = None
        if cfg.enable_ps and getattr(gs and gs.ps_backend, "async_mode",
                                     False):
            self._init_async(gs, optimizer, reducer, compression, name)
            return
        if cfg.enable_ps:
            if reducer is not None:
                # the JAX trainer's refusal (byteps_tpu/training.py:238-242)
                raise ValueError(
                    "custom reducers run on the collective path and would "
                    "be silently unused in PS mode — express lossy "
                    "exchange via compression kwargs instead")
            self._init_ps(gs, optimizer, partition_bytes, compression,
                          min_compress_bytes, name, shard_rank)
            return
        self.group = group if group is not None else data_group()
        self._tx = DistributedOptimizer(
            optimizer, named_parameters=self._model.named_parameters(),
            group=self.group,
            partition_bytes=(cfg.partition_bytes if partition_bytes is None
                             else partition_bytes),
            backward_passes_per_step=backward_passes_per_step,
            compression=compression,
            min_compress_bytes=(cfg.min_compress_bytes
                                if min_compress_bytes is None
                                else min_compress_bytes),
            reducer=reducer)

    # ------------------------------------------------- draining readers

    @property
    def model(self) -> torch.nn.Module:
        """The model. Reading it waits for the cross-step tails, so a
        reader sees fully applied weights; a trainer whose tail failed
        keeps raising here (its weights are partially stepped)."""
        self._drain_pipeline()
        return self._model

    @property
    def tx(self):
        """The optimizer (in PS mode the inner one), after the tails."""
        self._drain_pipeline()
        return self._tx

    def _drain_pipeline(self) -> None:
        d = self._cross_driver
        if d is not None and (d.pending or d.failed):
            d.drain()
        st = getattr(self, "_sharded", None)
        if st is not None:
            # the frames this worker owes its peers are out, or a dead
            # publisher says why not
            st.flush()

    def drain(self) -> None:
        """Join every in-flight cross-step tail and, under the sharded
        update, wait until this worker's param frames are out (a no-op
        otherwise): the explicit end-of-training barrier. Raises a tail's
        or the publisher's failure."""
        self._drain_pipeline()

    def _inner(self) -> torch.optim.Optimizer:
        tx = self._tx
        return tx.inner if isinstance(tx, DistributedOptimizer) else tx

    def state_dict(self) -> dict:
        """The model's and the inner optimizer's state and the step
        count, after the tails."""
        self._drain_pipeline()
        return {"model": self._model.state_dict(),
                "optimizer": self._inner().state_dict(),
                "step_count": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        """Install ``state`` (from ``state_dict()``). In-flight tails are
        joined first and do not overwrite it; a failed tail's poison is
        lifted, since fresh state is its remedy. The optimizer keeps the
        tensors it is given: pass a copy of a state to restore it twice."""
        if self._cross_driver is not None:
            self._cross_driver.supersede()
        self._model.load_state_dict(state["model"])
        self._inner().load_state_dict(state["optimizer"])
        self.step_count = int(state.get("step_count", self.step_count))
        self._accum = None

    # ------------------------------------------------------------ PS mode

    def _init_ps(self, gs, optimizer, partition_bytes, compression,
                 min_compress_bytes, name, shard_rank) -> None:
        if gs is None or gs.ps_backend is None:
            raise RuntimeError("BPS_ENABLE_PS: call bps.init() first; it "
                               "builds the parameter-server backend")
        from .server.ps_mode import PSGradientExchange
        cfg = gs.config
        self._ps_leaves(name)
        name = self._name
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
            max_lag=resolve_max_lag(), worker_id=cfg.worker_id,
            device=self.device)
        gs.exchanges.append(self.ps_exchange)
        # the sums span the worker processes: the tails divide by them
        self._ps_world = gs.engine.ps_world
        self._tx = optimizer          # the plain inner optimizer
        # the overlap schedule, read where the JAX trainer reads it
        # (byteps_tpu/training.py:254-290): none changes a number
        self._apply_chunked = os.environ.get("BPS_APPLY_CHUNKED", "1") != "0"
        self._bwd_staged = os.environ.get("BPS_BWD_STAGED", "1") != "0"
        self._bwd_groups = int(os.environ.get("BPS_BWD_GROUPS", "0") or 0)
        if self._bwd_groups < 0:
            raise ValueError(f"BPS_BWD_GROUPS={self._bwd_groups}: expected "
                             f"0 (one feed batch a bucket group, capped as "
                             f"in the JAX package) or a positive cap")
        self._cross_step = os.environ.get("BPS_CROSS_STEP", "1") != "0"
        self._accum = None
        self._chunked = None          # built at the first streamed step
        self._stager = None
        self._head = None             # the staged backward's feed, if any
        self._gate_fn = None          # the cross step's forward gate
        self._gates = None
        # the sharded weight update: resolved here, built at the first
        # step, once the exchange's backend is final (tests swap it) and
        # before the first round, so step 1 already pulls only its share
        self._sharded = None
        self._sharded_epoch = 0
        self._sharded_cfg = None
        self._put_param = None
        # a sharded checkpoint's slices and membership (restore_sharded),
        # installed by the first step
        self._restored_groups = None
        self._restored_membership = None
        if cfg.sharded_update and self.ps_exchange.plane.max_lag > 1:
            # the JAX package's sharded tails keep e - 1 while its server
            # runs the lag store (byteps_tpu/sharded_update.py:966, 1019)
            self.ps_exchange.close()
            raise NotImplementedError(
                f"BPS_MAX_LAG={self.ps_exchange.plane.max_lag} with "
                f"BPS_SHARDED_UPDATE=1 (bounded staleness under the sharded "
                f"weight update) is not ported yet (see ROADMAP.md, "
                f"'Modules still to port', queue 1, item 6)")
        if cfg.sharded_update and self._apply_chunked \
                and self.backward_passes_per_step == 1:
            rank = (shard_rank if shard_rank is not None
                    else cfg.shard_rank if cfg.shard_rank >= 0
                    else cfg.worker_id)
            self._sharded_cfg = (rank, cfg.shard_world or self._ps_world)
        elif cfg.sharded_update:
            from .sharded_update import _fallback
            _fallback("BPS_APPLY_CHUNKED=0 or backward_passes_per_step>1 "
                      "(the sharded tail is the chunked tail)")
        # the hooks hold the trainer weakly: the model keeps no trainer
        # alive, and dropping the trainer frees the model without the
        # cycle collector
        me = weakref.ref(self)
        if self._staged_route():
            def landed(p):
                tr = me()
                if tr is not None:
                    tr._grad_landed(p)

            for _, p in self._ps_params:
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(landed)
            if self._cross_step:
                from .torch.cross_barrier import ForwardGates

                def wait(params):
                    tr = me()
                    if tr is not None:
                        tr._gate_wait(params)

                self._gates = ForwardGates(
                    self._model, [p for _, p in self._ps_params], wait)
        # bps.shutdown() closes the exchange: in-flight tails end first

        def join_tails():
            tr = me()
            if tr is not None:
                tr._join_tails()

        self.ps_exchange.add_close_hook(join_tails)

    def _ps_leaves(self, name: Optional[str]) -> None:
        """The parameters in the JAX tree's flatten order (dotted names
        sorted by path) and the PS declaration name."""
        self._ps_params = sorted(self._model.named_parameters(),
                                 key=lambda kv: kv[0].split("."))
        self._ps_index = {p: i for i, (_, p) in enumerate(self._ps_params)}
        if name is None:
            sig = "|".join(f"{n}:{tuple(p.shape)}:{p.dtype}"
                           for n, p in self._ps_params)
            base = "trainer-" + hashlib.sha1(sig.encode()).hexdigest()[:10]
            n = DistributedTrainer._name_counts.get(base, 0)
            DistributedTrainer._name_counts[base] = n + 1
            name = base if n == 0 else f"{base}-{n}"
        self._name = name

    # ---------------------------------------------------------- async PS

    def _init_async(self, gs, optimizer, reducer, compression,
                    name) -> None:
        """The async PS branch's set-up (``byteps_tpu/training.py:179-227``):
        the refusals, then the worker, whose keys the store is seeded under
        with this worker's initial weights (first init wins)."""
        if reducer is not None:
            raise ValueError(
                "custom reducers run on the collective path and would be "
                "silently unused in async-PS mode")
        if compression:
            raise ValueError(
                "compression is not supported in async-PS mode (the "
                "reference's async server folds raw weight deltas, "
                "server.cc:310-314) — drop BPS_ENABLE_ASYNC or the "
                "compression kwargs")
        lag = resolve_max_lag()
        for knob, on in ((f"BPS_MAX_LAG={lag}", lag > 1),
                         ("BPS_SHARDED_UPDATE=1", gs.config.sharded_update)):
            if on:
                # the JAX trainer's async branch returns before it reads
                # either knob: there it would be silently unused
                raise NotImplementedError(
                    f"{knob} with BPS_ENABLE_ASYNC=1 is not ported yet: the "
                    f"JAX package's async PS step never reads it (see "
                    f"ROADMAP.md, 'Modules still to port', queue 1, item 6)")
        from .server.ps_mode import AsyncPSWorker, torch_dtype
        self._ps_leaves(name)
        self._tx = optimizer          # the plain inner optimizer
        self._accum = None
        self._async_worker = AsyncPSWorker(
            gs.ps_backend, [p.detach() for _, p in self._ps_params],
            name=self._name, init_store=True, registry=gs.registry)
        wire = self._async_worker.wire_dtype
        self._wire = None if wire is None else torch_dtype(wire)
        self._pulled = None           # the pulls' host buffers

    def _pull_buffers(self):
        """One host buffer a leaf in the pull dtype (pinned beside a
        card), made at the first step: (torch tensors, numpy views)."""
        if self._pulled is None:
            from .server.ps_mode import host_leaf, torch_dtype
            w = self._async_worker
            pin = self.device.type == "cuda"
            ts = [torch.empty(n, dtype=torch_dtype(w.pull_dtype or dt),
                              pin_memory=pin)
                  for n, dt in zip(w.sizes, w.dtypes)]
            self._pulled = (ts, [host_leaf(t) for t in ts])
        return self._pulled

    def _async_ps_step(self, batch) -> torch.Tensor:
        """The async PS step (``byteps_tpu/training.py:1019-1046``): local
        gradients, the local optimizer step, the weight delta pushed, the
        store's weights pulled and installed in place. No barrier: the
        servers fold deltas as they arrive."""
        loss = self._loss_fn(self._model, batch)
        loss.backward()
        grads = self._accumulate(self._take_grads())
        if grads is None:
            return loss.detach()
        params = [p for _, p in self._ps_params]
        t0 = time.time()
        with torch.no_grad():
            old = [p.detach().clone() for p in params]
            for p, g in zip(params, grads):
                p.grad = g
            del grads
            self._tx.step()
            self._tx.zero_grad(set_to_none=True)
            # new − old into the copy, then the wire dtype, on the card:
            # one narrow tensor a leaf crosses to the host
            deltas = [torch.sub(p, o, out=o) for p, o in zip(params, old)]
            del old
            if self._wire is not None:
                deltas = [d if d.dtype == self._wire else d.to(self._wire)
                          for d in deltas]
        self._async_worker.push_delta_tree(deltas)
        del deltas
        observe_stage("ASYNC_PS_PUSH", time.time() - t0)
        t1 = time.time()
        hosts, views = self._pull_buffers()
        self._async_worker.pull_into(views)
        with torch.no_grad():
            for p, h in zip(params, hosts):
                src = h.view(p.shape)
                if src.dtype != p.dtype:    # a narrow pull: widen on the card
                    src = src.to(p.device, non_blocking=True)
                p.copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            # the host buffers serve the next step's pulls
            torch.cuda.current_stream(self.device).synchronize()
        observe_stage("ASYNC_PS_PULL", time.time() - t1)
        return loss.detach()

    def _staged_route(self) -> bool:
        return (self._apply_chunked and self._bwd_staged
                and self.backward_passes_per_step == 1)

    def _join_tails(self) -> None:
        if self._cross_driver is not None:
            self._cross_driver.join()
        st, self._sharded = self._sharded, None
        if st is not None:
            try:
                st.close()            # flush the frames owed to peers
            except Exception as e:   # noqa: BLE001 — the exchange closes
                from .common.logging import get_logger   # regardless
                get_logger().warning("sharded update at shutdown: %s", e)

    # ------------------------------------------------------ sharded update

    def _ensure_sharded(self) -> None:
        """First step: build the sharded state, or fall back with the
        reference's INFO line."""
        if self._sharded_cfg is None:
            return
        rank, world = self._sharded_cfg
        self._sharded_cfg = None
        from .sharded_update import build_sharded_state
        self._sharded = build_sharded_state(
            self.ps_exchange, self._ps_params, self._tx, self._name, rank,
            world)
        if self._sharded is not None:
            self._put_param = self._sharded.param_installer(self.device)
            mem = self._restored_membership
            if mem:
                # the checkpoint's owner map is the shared state: installed
                # as it is (its slices come from disk, no handoff)
                self._sharded.adopt_membership(
                    mem["owner"], mem["member_epoch"], live=mem.get("live"))
        self._restored_membership = None

    def _sharded_active(self):
        """The live sharded state, or None; checked at every round, so a
        round never restricts its pulls under an unsharded tail."""
        st = self._sharded
        if st is not None and self._chunked is not None \
                and not self._chunked.decomposable:
            st.close()
            self._sharded = None
            return None
        return st

    def _round_view(self):
        st = self._sharded_active()
        return st.plan.round_view() if st is not None else None

    def _next_shard_epoch(self) -> int:
        """One monotonic epoch counter for the sharded tails, whichever
        route runs the step."""
        d = self._cross_driver
        self._sharded_epoch = max(self._sharded_epoch,
                                  d._epoch if d is not None else 0) + 1
        return self._sharded_epoch

    def reshard(self, live, weights=None, handoff_timeout_ms=None) -> dict:
        """A live membership change of the sharded update (JOIN or LEAVE;
        ``byteps_tpu/training.py:753-784``): drain this trainer's tails
        and param frames to a step boundary, then move to the next member
        epoch over the ranks ``live``, handing the moved groups' optimizer
        state through the server (``ShardedUpdateState.reshard``). Every
        worker makes the same call at the same step boundary.
        ``weights=None`` balances by the live per-layer push counters
        (``live_group_weights``; the static bytes while they are cold, and
        always under ``BPS_COMPRESS=auto``, whose counts differ between
        workers). Returns ``{"member_epoch", "gained", "lost", "live"}``."""
        st = getattr(self, "_sharded", None)
        if st is None:
            raise RuntimeError(
                "reshard needs an engaged sharded update "
                "(BPS_SHARDED_UPDATE=1, dp>1, at least one step run)")
        self.drain()
        if weights is None:
            from .sharded_update import live_group_weights
            gs = GlobalState._instance
            compress = gs.config.compress if gs is not None else "none"
            if compress != "auto":
                weights = live_group_weights(st.plan, self._name)
        return st.reshard(self._chunked, live, weights=weights,
                          handoff_timeout_ms=handoff_timeout_ms)

    def restore_sharded(self, path: str) -> dict:
        """Restore a sharded checkpoint (``checkpoint.
        save_sharded_checkpoint``) before the first step: the parameters
        and the step count now; the owner map when the first step builds
        the sharded state, and the owned groups' optimizer-state slices
        once it builds the chunked tail, so training goes on sharded.
        The optimizer that ``state_dict()`` and ``load_state_dict()`` see
        is not touched. Returns the checkpoint's meta."""
        if getattr(self, "_chunked", None) is not None:
            raise RuntimeError(
                "restore_sharded must run before the first step — the "
                "chunked tail already built its optimizer states")
        if self.ps_exchange is None or not self._apply_chunked:
            raise RuntimeError(
                "restore_sharded needs the PS path's streamed tail "
                "(BPS_ENABLE_PS=1, BPS_APPLY_CHUNKED=1): it installs the "
                "slices into its per-group optimizer state")
        from .checkpoint import restore_sharded_checkpoint
        params, blobs, step, meta = restore_sharded_checkpoint(
            path, self._model.state_dict())
        self._model.load_state_dict(params)
        self.step_count = int(step)
        self._restored_groups = dict(blobs)
        self._restored_membership = meta.get("sharded")
        return meta

    def _install_restored_groups(self) -> None:
        """First streamed step, once the chunked tail exists: the owned
        groups' slices of a sharded checkpoint unpacked into their state
        (``byteps_tpu/training.py:814-855``); the other groups' slices are
        their owners' to install."""
        blobs, self._restored_groups = self._restored_groups, None
        if not blobs:
            return
        chunked = self._chunked
        if not chunked.decomposable:
            raise RuntimeError(
                "sharded checkpoint restore needs the decomposable "
                "chunked tail (it holds per-group optimizer state) — the "
                "optimizer changed since the save")
        from .sharded_update import unpack_opt_state
        st = self._sharded
        for gi, payload in sorted(blobs.items()):
            if gi >= len(chunked.groups):
                raise ValueError(
                    f"sharded checkpoint has a slice for group {gi} but "
                    f"the plan has {len(chunked.groups)} groups — "
                    f"different bucket plans")
            if st is not None and gi not in st.plan.owned_set:
                continue
            chunked.adopt_group(gi, unpack_opt_state(
                payload, chunked.init_group(gi)))
        missing = [gi for gi in (st.plan.owned if st is not None
                                 else range(len(chunked.groups)))
                   if gi not in blobs]
        if missing:
            from .common.logging import get_logger
            get_logger().warning(
                "sharded checkpoint restore: no slice for owned group(s) "
                "%s — their optimizer moments restart from init (the "
                "owner's save was lost?)", missing)

    # ------------------------------------------------------------ head

    def _grad_landed(self, p) -> None:
        """Post-accumulate hook (autograd's device thread): hand the
        finished gradient to the staged backward's feed, with the event
        of the stream that produced it; the gradient leaves ``p.grad``."""
        feed = self._head
        if feed is None:
            return
        g = p.grad
        p.grad = None
        ev = None
        if g.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(g.device))
        feed.landed(self._ps_index[p], g, ev)

    def _gate_wait(self, params) -> None:
        gate = self._gate_fn
        if gate is not None:
            gate([self._ps_index[p] for p in params])

    def _feed_batches(self) -> List[List[int]]:
        groups = [list(g) for g in self._chunked.groups]
        cap = self._bwd_groups or max(
            2, min(16 if self._cross_step else 8, len(groups)))
        return _runs(groups, cap)

    def _staged_backward(self, batch, handle, gate=None) -> torch.Tensor:
        """Forward and backward with the gradients fed to ``handle`` as
        they land; ``gate`` holds each module's forward for the leaves it
        reads (cross steps). Aborts the round on a failure."""
        feed = _HeadFeed(handle, self._feed_batches())
        pushed = get_registry().counter("ps/push_bytes")
        before = pushed.value
        self._gate_fn = gate
        self._head = feed
        try:
            try:
                loss = self._loss_fn(self._model, batch)
                loss.backward()
            finally:
                self._head = None
                self._gate_fn = None
            # bytes that reached the wire before the backward ended
            get_registry().counter("ps/push_bytes_in_backward").inc(
                pushed.value - before)
            feed.flush([p for _, p in self._ps_params])
            handle.finish()
        except BaseException as exc:
            handle.abort(exc)        # wake the tail's consumer
            raise
        return loss.detach()

    # ------------------------------------------------------------ tail

    def _ensure_streamed_tail(self) -> None:
        """First streamed step: the exchange's bucket groups, the chunked
        apply (or the probe's verdict that the optimizer is coupled) and
        the H2D stager."""
        if self._chunked is not None:
            return
        from .staging import H2DStager
        groups = self.ps_exchange.leaf_groups(self._ps_params,
                                              name=self._name)
        st = self._sharded
        self._chunked = ChunkedApply(self._tx,
                                     [p for _, p in self._ps_params], groups,
                                     owned=st.plan.owned_set if st else None)
        self._stager = H2DStager(self.device, world=self._ps_world)
        self._install_restored_groups()

    def _ps_step_streamed(self, grads=None, handle=None) -> None:
        """The streamed tail: each leaf goes to the card as it lands, the
        optimizer applies per group as the group completes (a coupled
        optimizer keeps one fused step at the end). ``handle``: the staged
        head's ingest round; otherwise ``grads`` start a streaming one."""
        self._ensure_streamed_tail()
        chunked, stager = self._chunked, self._stager
        t_ex = time.time()
        if handle is None:
            handle = self.ps_exchange.exchange_stream(
                [(n, g) for (n, _), g in zip(self._ps_params, grads)],
                name=self._name, host_alloc=stager.host_alloc,
                sharded=self._round_view())
        hyper = chunked.hyper()
        if handle.round_state.sharded is not None:
            self._sharded_tail(handle, hyper, t_ex)
            return
        shapes = [tuple(p.shape) for _, p in self._ps_params]
        landed: dict = {}
        remaining = [len(g) for g in chunked.groups]
        applied = 0
        try:
            for li, arr in handle.ready():
                landed[li] = stager.copy(arr, shapes[li])
                if not chunked.decomposable:
                    continue
                gi = chunked.leaf_group[li]
                remaining[gi] -= 1
                if remaining[gi] == 0:
                    items = [landed.pop(i) for i in chunked.groups[gi]]
                    chunked.apply_group(gi, [t for t, _ in items], hyper,
                                        [e for _, e in items if e is not None])
                    applied += 1
            if not chunked.decomposable:
                items = [landed.pop(i) for i in range(len(shapes))]
                chunked.apply_fused([t for t, _ in items],
                                    [e for _, e in items if e is not None])
        except BaseException as e:
            if applied:
                # the chunked tail is not atomic like the fused one: a
                # retried step would apply the early groups twice
                raise RuntimeError(
                    f"streamed PS step failed after {applied}/"
                    f"{len(chunked.groups)} optimizer groups applied — "
                    f"parameters and optimizer state are PARTIALLY stepped; "
                    f"do not retry this step on the same trainer (install "
                    f"fresh state with load_state_dict, or run with "
                    f"BPS_APPLY_CHUNKED=0 for an all-or-nothing tail)") from e
            raise
        finally:
            observe_stage("PS_PUSH_PULL", time.time() - t_ex)

    def _sharded_tail(self, handle, hyper, t_ex: float) -> None:
        """A draining sharded round: owned groups pulled, applied and
        published, the others installed from their owners' frames; returns
        once every group is applied or installed."""
        st = self._sharded
        if st is None:
            raise RuntimeError("sharded round created but the sharded state "
                               "is gone — a bug in the enable/disable path")
        e = self._next_shard_epoch()
        seq = st.next_seq()
        try:
            st.run_tail(handle, self._chunked, e, seq, self._stager.copy,
                        self._put_param, hyper)
        except BaseException as exc:
            raise RuntimeError(
                "sharded PS step failed — parameters and optimizer state "
                "may be PARTIALLY stepped (owned groups apply and fetched "
                "groups install independently); do not retry this step on "
                "the same trainer (install fresh state with "
                "load_state_dict, or run with BPS_SHARDED_UPDATE=0)") from exc
        finally:
            observe_stage("PS_PUSH_PULL", time.time() - t_ex)

    def _ps_step_mono(self, grads) -> None:
        """The monolithic tail (``BPS_APPLY_CHUNKED=0``): exchange every
        bucket, copy the sums back into the gradients, step once."""
        t0 = time.time()
        summed = self.ps_exchange.exchange(
            [(n, g) for (n, _), g in zip(self._ps_params, grads)],
            name=self._name)
        observe_stage("PS_PUSH_PULL", time.time() - t0)
        if self._ps_world > 1:
            summed = [s / self._ps_world for s in summed]
        t0 = time.time()
        with torch.no_grad():
            for (_, p), g, s in zip(self._ps_params, grads, summed):
                g.copy_(torch.from_numpy(s).view_as(g), non_blocking=False)
                p.grad = g
        observe_stage("PS_H2D", time.time() - t0)
        self._tx.step()
        self._tx.zero_grad(set_to_none=True)

    def _take_grads(self) -> list:
        """The gradients of the backward that just ran, in the tree's
        order (zeros where none came), taken off the parameters."""
        grads = []
        for _, p in self._ps_params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads.append(g)
        return grads

    def _accumulate(self, grads):
        """The running mean over the ``backward_passes_per_step`` window,
        in the JAX package's order of operations (``acc + (g - acc) / n``
        in fp32, ``byteps_tpu/training.py:438-457``), kept on the card.
        None mid-window; the mean at the window's end."""
        k = self.backward_passes_per_step
        i = self.step_count % k
        self.step_count += 1
        if k == 1:
            return grads
        if i == 0:
            self._accum = grads
        else:
            with torch.no_grad():
                # a divisor on the device: CUDA divides by a host scalar
                # as a product with its reciprocal, which can round apart
                # from numpy's quotient
                self._accum = [a + (g - a) / torch.tensor(
                                   i + 1, dtype=a.dtype, device=a.device)
                               for a, g in zip(self._accum, grads)]
        if i + 1 < k:
            return None
        out, self._accum = self._accum, None
        return out

    def _ps_step(self, batch) -> torch.Tensor:
        self._ensure_sharded()
        if self._staged_route():
            self._ensure_streamed_tail()
            self.step_count += 1
            if self._cross_driver is not None:
                return self._cross_driver.step(batch)
            handle = self.ps_exchange.exchange_ingest(
                self._ps_params, name=self._name, step=self.step_count,
                host_alloc=self._stager.host_alloc,
                sharded=self._round_view())
            loss = self._staged_backward(batch, handle)
            self._ps_step_streamed(handle=handle)
            if (self._cross_step and self._chunked.decomposable
                    and self._gates.learn()):
                # the first forward showed which modules run: engage the
                # pipeline from the next step on
                from .cross_step import CrossStepDriver
                self._cross_driver = CrossStepDriver(
                    self, [self._ps_index[p] for p in self._gates.ungated])
            return loss
        loss = self._loss_fn(self._model, batch)
        loss.backward()
        grads = self._accumulate(self._take_grads())
        if grads is not None:
            if self._apply_chunked:
                self._ps_step_streamed(grads)
            else:
                self._ps_step_mono(grads)
        return loss.detach()

    def close(self) -> None:
        """Join the tails, flush the sharded update's frames, then stop the
        PS exchange's threads (``bps.shutdown()`` does too); raises a
        tail's or the publisher's failure."""
        try:
            self._drain_pipeline()
        finally:
            st, self._sharded = getattr(self, "_sharded", None), None
            try:
                if st is not None:
                    st.close()
            finally:
                if self.ps_exchange is not None:
                    self.ps_exchange.close()

    # ---------------------------------------------------------------- step

    def step(self, batch) -> torch.Tensor:
        """One training step on this process's batch (numpy or tensors);
        returns the loss averaged over the data-parallel group (in PS mode
        this process's loss), detached and still on the device."""
        batch = _to_device(batch, self.device)
        if self._async_worker is not None:
            return self._async_ps_step(batch)
        if self.ps_exchange is not None:
            return self._ps_step(batch)
        loss = self._loss_fn(self._model, batch)
        loss.backward()
        self._tx.step()
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

