"""Process-wide runtime state (reference: BytePSGlobal, global.h:52-225).

The port's counterpart of ``byteps_tpu/common/global_state.py``. BytePS
runs one process per GPU, and so does the port: ``GlobalState.init``
resolves the env ``Config``, picks the process's device, and joins the
``torch.distributed`` process group (NCCL for a CUDA device, gloo for the
CPU). A world of one needs no process group at all.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .config import Config


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
    """Config + device + the data-parallel process group of this process."""

    _instance: Optional["GlobalState"] = None
    _lock = threading.Lock()

    def __init__(self, config: Config, device: torch.device,
                 owns_group: bool) -> None:
        self.config = config
        self.device = device
        self._owns_group = owns_group

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def init(cls, config: Optional[Config] = None, device=None,
             init_method: Optional[str] = None,
             timeout: Optional[datetime.timedelta] = None) -> "GlobalState":
        """Join the process group described by ``config`` (env by default).

        ``init_method`` overrides the rendezvous (e.g. ``file://...`` for
        a FileStore); otherwise ``tcp://<coordinator_address>`` is used.
        """
        with cls._lock:
            if cls._instance is not None:
                return cls._instance
            cfg = config or Config.from_env()
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", cfg.local_rank)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            owns = False
            if cfg.num_worker > 1 and not dist.is_initialized():
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
            cls._instance = GlobalState(cfg, dev, owns)
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
            inst = cls._instance
            if inst is None:
                return
            if inst._owns_group and dist.is_initialized():
                dist.destroy_process_group()
            cls._instance = None
