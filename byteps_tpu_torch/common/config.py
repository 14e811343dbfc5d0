"""Environment-variable configuration (the port's copy of the fields of
``byteps_tpu/common/config.py`` that the data-parallel slice reads).

The reference framework (BytePS) is configured purely through environment
variables (reference: docs/env.md; global.cc:105-281 reads them at init).
Every knob is an env var with the same name and default as in the JAX
package, resolved once into a frozen ``Config``:

  DMLC_WORKER_ID           → BPS_WORKER_ID       (this process's rank)
  DMLC_NUM_WORKER          → BPS_NUM_WORKER      (the world size)
  BYTEPS_LOCAL_RANK/SIZE   → BPS_LOCAL_RANK/SIZE
  DMLC_PS_ROOT_URI         → BPS_COORDINATOR_ADDRESS (host:port of rank 0)
  BYTEPS_PARTITION_BYTES   → BPS_PARTITION_BYTES
  BYTEPS_ENABLE_ASYNC      → BPS_ENABLE_ASYNC    (not ported: raises)
  BYTEPS_ENABLE_PS         → BPS_ENABLE_PS       (not ported: raises)

The original ``BYTEPS_``/``DMLC_`` spellings are accepted as fallbacks so
that launch scripts written for the reference keep working.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_TRUE = {"1", "true", "yes", "on"}


def _env(name: str, legacy: Optional[str] = None, default: Optional[str] = None) -> Optional[str]:
    """Read BPS_* env var, falling back to the legacy BYTEPS_/DMLC_ name."""
    v = os.environ.get(name)
    if v is None and legacy is not None:
        v = os.environ.get(legacy)
    return v if v is not None else default


def _env_int(name: str, legacy: Optional[str], default: int) -> int:
    v = _env(name, legacy)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, legacy: Optional[str], default: bool = False) -> bool:
    v = _env(name, legacy)
    if v is None:
        return default
    return v.strip().lower() in _TRUE


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen snapshot of the runtime knobs, resolved at ``init()``."""

    worker_id: int = 0
    num_worker: int = 1
    local_rank: int = 0
    local_size: int = 1
    coordinator_address: Optional[str] = None
    partition_bytes: int = 4096000       # BYTEPS_PARTITION_BYTES default, global.cc:134
    enable_async: bool = False
    enable_ps: bool = False

    @staticmethod
    def from_env(**overrides) -> "Config":
        cfg = dict(
            worker_id=_env_int("BPS_WORKER_ID", "DMLC_WORKER_ID", 0),
            num_worker=_env_int("BPS_NUM_WORKER", "DMLC_NUM_WORKER", 1),
            local_rank=_env_int("BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", 1),
            coordinator_address=_env("BPS_COORDINATOR_ADDRESS", "DMLC_PS_ROOT_URI"),
            partition_bytes=_env_int("BPS_PARTITION_BYTES", "BYTEPS_PARTITION_BYTES", 4096000),
            enable_async=_env_bool("BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC"),
            enable_ps=_env_bool("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS"),
        )
        cfg.update(overrides)
        return Config(**cfg)
