"""Process-wide runtime state (reference: BytePSGlobal, global.h:52-225).

The port's counterpart of ``byteps_tpu/common/global_state.py``. BytePS
runs one process per GPU, and so does the port: ``GlobalState.init``
resolves the env ``Config``, picks the process's device, and joins the
``torch.distributed`` process group (NCCL for a CUDA device, gloo for the
CPU). A world of one needs no process group at all.

It holds the name registry that keeps keys stable, the ``PushPullEngine``
behind ``bps.push_pull`` and, with ``BPS_TELEMETRY_ON``, the push_pull
speed window (``byteps_tpu/common/global_state.py:110-118``). With
``BPS_ENABLE_PS`` (the sync parameter-server path) it also builds the
server backend and gives the engine the recipe of its
``PSGradientExchange`` on its own device, as
``byteps_tpu/common/global_state.py:129-218`` does; the engine builds
that exchange at its first use, so a run that trains through
``DistributedTrainer`` alone holds only the trainer's. The backend is the
in-process server at world 1, or, with ``BPS_SERVER_ADDRS``, a
``RemotePSBackend`` to standalone servers (``python -m
byteps_tpu_torch.launcher.launch --server``), which any number of worker
processes share: PS mode joins no process group, the workers meet only at
the servers, and the engine divides the sums by ``BPS_NUM_WORKER``
(``engine.ps_world``). With ``BPS_ENABLE_ASYNC`` too, both backends are
async (the servers fold weight deltas into their stores, and a pull never
waits), and no ``PSGradientExchange`` is built for the eager
``push_pull``, as ``byteps_tpu/common/global_state.py:206-218`` builds
none: summing gradients into an async store would accumulate them for
good. The async path runs through ``server/ps_mode.py::AsyncPSWorker``
(the trainer's async step, the plugin's async ``DistributedOptimizer``);
``push_pull`` then reduces over this process alone and returns its own
values, as the JAX package's does. The managed server plane is not
ported yet.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .config import Config
from .naming import NameRegistry

_NOT_PORTED = "is not ported yet (see ROADMAP.md, 'Modules still to port')"


def check_ps_config(cfg: Config) -> None:
    """Refuse ``BPS_ENABLE_ASYNC`` without ``BPS_ENABLE_PS``: the async path
    runs on the PS backend, which the JAX package then does not build, so
    there its trainer ignores the knob and its plugin's async step finds
    no backend (ROADMAP.md, queue 3, 'Deliberate differences')."""
    if cfg.enable_async and not cfg.enable_ps:
        raise ValueError(
            "BPS_ENABLE_ASYNC=1 needs BPS_ENABLE_PS=1: async PS folds "
            "weight deltas on the parameter servers (see ROADMAP.md, queue "
            "3, 'Deliberate differences')")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. ``None`` means ``cuda`` and raises when no GPU is present
    — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "byteps_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev


class GlobalState:
    """Config + device + the data-parallel process group of this process,
    and with ``enable_ps`` the PS backend and the exchanges that use it."""

    _instance: Optional["GlobalState"] = None
    _lock = threading.Lock()

    def __init__(self, config: Config, device: torch.device,
                 owns_group: bool,
                 registry: Optional[NameRegistry] = None) -> None:
        self.config = config
        self.device = device
        self._owns_group = owns_group
        self.registry = registry or NameRegistry()
        from ..parallel.collectives import PushPullEngine
        from ..telemetry import PushPullSpeed
        self.telemetry = PushPullSpeed() if config.telemetry_on else None
        self.engine = PushPullEngine(
            partition_bytes=config.partition_bytes, registry=self.registry,
            telemetry=self.telemetry,
            scheduling_credit=config.scheduling_credit,
            debug_sample=config.debug_sample_tensor)
        self.ps_backend = None
        self.exchanges: list = []        # closed by shutdown()
        if config.enable_ps:
            # workers are independent processes; the cross-worker hop is
            # the server: in process at world 1, over TCP otherwise
            if config.server_addrs:
                from ..server.admission import configure_send
                from ..server.transport import RemotePSBackend
                addrs = [a.strip() for a in config.server_addrs.split(",")
                         if a.strip()]
                configure_send(config.scheduling_credit)
                self.ps_backend = RemotePSBackend(
                    addrs, async_mode=config.enable_async)
            else:
                if config.num_worker > 1:
                    raise ValueError(
                        "BPS_ENABLE_PS with BPS_NUM_WORKER>1 needs "
                        "BPS_SERVER_ADDRS (standalone servers reachable by "
                        "every worker) — a private in-process backend "
                        "would wait forever for the other workers' pushes")
                from ..server.engine import HostPSBackend
                self.ps_backend = HostPSBackend(
                    num_servers=1, num_workers=config.num_worker,
                    engine_threads=config.server_engine_threads,
                    enable_schedule=config.server_enable_schedule,
                    async_mode=config.enable_async)
        if config.enable_ps and not config.enable_async:
            self.engine.ps_world = config.num_worker
            # sync PS: the eager push_pull takes the host hop. The recipe
            # holds what it needs, not this state: a reference back would
            # keep the exchanges, and their residuals on the card, alive
            # after shutdown until the cycle collector ran
            backend, registry, exchanges = (self.ps_backend, self.registry,
                                            self.exchanges)

            def engine_exchange():
                from ..server.ps_mode import PSGradientExchange
                ex = PSGradientExchange(
                    backend, partition_bytes=config.partition_bytes,
                    registry=registry,
                    min_compress_bytes=config.min_compress_bytes,
                    watchdog_sec=config.watchdog_sec,
                    compress=config.compress, device=device)
                exchanges.append(ex)
                return ex
            self.engine.ps_factory = engine_exchange

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def init(cls, config: Optional[Config] = None, device=None,
             init_method: Optional[str] = None,
             timeout: Optional[datetime.timedelta] = None,
             registry: Optional[NameRegistry] = None) -> "GlobalState":
        """Join the process group described by ``config`` (env by default).

        ``init_method`` overrides the rendezvous (e.g. ``file://...`` for
        a FileStore); otherwise ``tcp://<coordinator_address>`` is used.
        ``registry`` carries declarations over (``resume``).
        """
        with cls._lock:
            if cls._instance is not None:
                return cls._instance
            cfg = config or Config.from_env()
            check_ps_config(cfg)
            from ..obs import flight
            flight.configure()      # re-read BPS_FLIGHT_RECORDER*
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", cfg.local_rank)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            owns = False
            if cfg.num_worker > 1 and not dist.is_initialized() \
                    and not cfg.enable_ps:
                if init_method is None:
                    if not cfg.coordinator_address:
                        raise ValueError(
                            "a world of more than one worker needs "
                            "BPS_COORDINATOR_ADDRESS (host:port of rank 0) "
                            "or an explicit init_method")
                    init_method = f"tcp://{cfg.coordinator_address}"
                kw = {} if timeout is None else {"timeout": timeout}
                dist.init_process_group(
                    backend="nccl" if dev.type == "cuda" else "gloo",
                    init_method=init_method, world_size=cfg.num_worker,
                    rank=cfg.worker_id, **kw)
                owns = True
            cls._instance = GlobalState(cfg, dev, owns, registry)
            return cls._instance

    @classmethod
    def get(cls) -> "GlobalState":
        if cls._instance is None:
            raise RuntimeError(
                "byteps_tpu_torch not initialised; call bps.init() first")
        return cls._instance

    @classmethod
    def initialized(cls) -> bool:
        return cls._instance is not None

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            if cls._instance is not None:
                cls._instance._teardown()
                cls._instance = None

    def _teardown(self) -> None:
        for ex in self.exchanges:
            ex.close()
        if self.ps_backend is not None:
            self.ps_backend.close()
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()

    @classmethod
    def suspend(cls) -> Optional[NameRegistry]:
        """Tear down, returning the registry of declarations for
        ``resume`` (reference: byteps_suspend, operations.cc:114-119)."""
        with cls._lock:
            inst = cls._instance
            if inst is None:
                return None
            inst._teardown()
            cls._instance = None
            return inst.registry

    @classmethod
    def resume(cls, registry: Optional[NameRegistry],
               config: Optional[Config] = None, device=None,
               init_method: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None
               ) -> "GlobalState":
        """Init again (new membership) with ``suspend``'s registry, its
        declarations replayed in their original order so name→key stays
        the same (reference: ReDeclareTensor, global.cc:431-436)."""
        if registry is not None:
            registry.redeclare_all()
        return cls.init(config, device=device, init_method=init_method,
                        timeout=timeout, registry=registry)
