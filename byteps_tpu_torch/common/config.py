"""Environment-variable configuration (the port's copy of the fields of
``byteps_tpu/common/config.py`` that the data-parallel and sync
parameter-server slices read).

The reference framework (BytePS) is configured purely through environment
variables (reference: docs/env.md; global.cc:105-281 reads them at init).
Every knob is an env var with the same name and default as in the JAX
package, resolved once into a frozen ``Config``:

  DMLC_WORKER_ID           → BPS_WORKER_ID       (this process's rank)
  DMLC_NUM_WORKER          → BPS_NUM_WORKER      (the world size)
  BYTEPS_LOCAL_RANK/SIZE   → BPS_LOCAL_RANK/SIZE
  DMLC_PS_ROOT_URI         → BPS_COORDINATOR_ADDRESS (host:port of rank 0)
  BYTEPS_PARTITION_BYTES   → BPS_PARTITION_BYTES
  BYTEPS_MIN_COMPRESS_BYTES → BPS_MIN_COMPRESS_BYTES (buckets below it
                             skip gradient compression)
  BYTEPS_ENABLE_ASYNC      → BPS_ENABLE_ASYNC    (async PS, with
                             BPS_ENABLE_PS: the servers fold weight
                             deltas, ``server/ps_mode.py::AsyncPSWorker``;
                             without BPS_ENABLE_PS it raises)
  BYTEPS_ENABLE_PS         → BPS_ENABLE_PS       (the sync parameter-server
                             path: the in-process server at world 1, or
                             standalone servers)
  BPS_SERVER_ADDRS         (host:port,... of standalone servers, started
                             with ``python -m byteps_tpu_torch.launcher.launch
                             --server``; the worker's ``RemotePSBackend``,
                             ``server/transport.py``; needed at
                             BPS_NUM_WORKER > 1 in PS mode)
  BYTEPS_SERVER_ENGINE_THREAD → BPS_SERVER_ENGINE_THREAD
  BYTEPS_SERVER_ENABLE_SCHEDULE → BPS_SERVER_ENABLE_SCHEDULE
  BPS_COMPRESS             (the fused compression plane: none | auto |
                             fp16 | int8 | fp8_e4m3 | fp8_e5m2 | topk)
  BPS_WATCHDOG_SEC         (the stall watchdog of the PS exchange: > 0
                             logs a wedged key after that many seconds
                             without progress; 0 = off)
  BPS_PP_STAGES            (pipeline depth: DistributedTrainer raises
                             above 1, as the JAX trainer does)
  BPS_SHARDED_UPDATE       (the sharded weight update of the PS path,
                             ``sharded_update.py``: each worker pulls and
                             applies only the bucket groups it owns and
                             fetches the others' parameters; a case it
                             cannot serve keeps the full update with one
                             INFO line)
  BPS_SHARD_RANK           (this worker's ownership rank; -1 = BPS_WORKER_ID)
  BPS_SHARD_WORLD          (the ownership degree; 0 = BPS_NUM_WORKER)
  BYTEPS_SCHEDULING_CREDIT → BPS_SCHEDULING_CREDIT (bytes of bucket
                             collectives in flight before the engine's
                             synchronous push_pull waits; 0 = no limit;
                             with standalone servers also the wire credit
                             of the transport's gradient frames,
                             ``server/admission.py::SendScheduler``)
  BYTEPS_TELEMETRY_ON      → BPS_TELEMETRY_ON    (the push_pull MB/s
                             window behind ``get_pushpull_speed``)
  BYTEPS_DEBUG_SAMPLE_TENSOR → BPS_DEBUG_SAMPLE_TENSOR (push_pull names
                             holding it log their results' mean and std)

As in the JAX package, some knobs are read where they act rather than
here: ``BPS_COMPRESS_EF``, ``BPS_COMPRESS_INTERVAL`` (rounds between the
auto controller's decisions), ``BPS_COMPRESS_MAX`` (its ladder's top
rung) and ``BPS_COMPRESS_TOPK_DIV`` by ``compress/plane.py``;
``BPS_FLIGHT_RECORDER`` and ``BPS_FLIGHT_RECORDER_SIZE`` by
``obs/flight.py`` (``bps.init()`` re-reads them); ``BPS_NATIVE_CODEC``
(the host codecs' native primitives, default on) by
``ops/compression/host.py`` and ``server/compressed.py``; the overlap
schedule of the PS step by ``training.py`` when a trainer is built, each
default 1: ``BPS_APPLY_CHUNKED`` (the streamed tail; 0 = the monolithic
one), ``BPS_BWD_STAGED`` (the staged head), ``BPS_CROSS_STEP`` (the
cross-step driver, ``cross_step.py``) and ``BPS_BWD_GROUPS`` (a cap on the
staged head's feed batches; default 0, the JAX package's cap).
``BPS_PARAM_TIMEOUT_MS`` (how long a sharded-update fetch waits for its
owner's frame before it raises, default 30000) is read by
``sharded_update.py``. ``BPS_MAX_LAG`` (the bounded-staleness bound K,
default 1: the sync path) and ``BPS_LAG_GRACE_MS`` (how long a server
lets a round wait for its stragglers before it seals the round without
them, default 0) are read by ``server/admission.py``, as in the JAX
package; the trainer hands K and ``BPS_WORKER_ID`` to its exchange.
``BPS_ASYNC_WIRE_DTYPE`` (the dtype of an async worker's weight-delta
pushes, e.g. ``bfloat16``; default the parameters') is read from
``os.environ`` by ``server/ps_mode.py`` (``async_wire_dtype``, which
``AsyncPSWorker`` and the plugin's async step call; the trainer casts its
deltas on the card to its worker's ``wire_dtype``), and
``BPS_ASYNC_PULL_DTYPE`` (the dtype the weights' pulls cross in; default
the store's) by ``server/ps_mode.py``, as the JAX package reads them.
``BPS_STAGED_CACHE`` sizes the JAX package's cache of compiled backward
segments; eager PyTorch compiles none, and the port has no such cache.
The remote transport (``server/transport.py``) reads its own knobs where
they act: ``BPS_PS_CONNS`` (pooled connections a server, default 4),
``BPS_RECONNECT_SECS`` (the redial budget of a dropped connection, default
30; 0 = fail at once), ``BPS_PULL_TIMEOUT_MS`` (a pull's deadline, default
30000) and, on the server, ``BPS_PUSH_DEDUP_TTL_SECS`` (how long a dead
incarnation's dedup record lives, default 600), and as the JAX package
reads them: ``BPS_ENABLE_SHM`` (a client's shared-memory data plane to a
colocated server, default off), ``BPS_STRIPE_MIN`` (the least bytes of a
striped op, default 0 = off; ops of at least ``max(BPS_STRIPE_MIN, 512
KiB)`` are split over the pool), ``BPS_ENABLE_IPC`` (or
``BYTEPS_ENABLE_IPC``: the server's Unix-socket listener and the client's
upgrade to it on loopback, default off) and ``BPS_IPC_DIR`` (the
listener's directory, default ``<tmp>/bps-ipc-<uid>``, which must be the
user's own at mode 0700); those it does not port raise at a non-default
value where a client, a server or the launcher would read them
(``transport.CLIENT_REFUSED``, ``SERVER_REFUSED``, ``LAUNCHER_REFUSED``).
The server process (``python -m byteps_tpu_torch.launcher.launch
--server``) builds no ``Config``: it reads ``BPS_SERVER_PORT`` (default
9090), ``BPS_NUM_WORKER``, ``BPS_SERVER_ENGINE_THREAD``,
``BPS_SERVER_ENABLE_SCHEDULE``, ``BPS_ENABLE_ASYNC``,
``BPS_SERVER_SNAPSHOT`` (the store's snapshot file: restored at start
where it exists, written every ``BPS_SERVER_SNAPSHOT_SECS``, default 60,
and at stop) itself, as the JAX launcher does.
``BPS_FUSED_HOMOG`` (default on; off is ``0``, ``off``, ``false`` or
``no``) is read from ``os.environ`` by ``server/homog.py``
(``homog_enabled``) at each fused declaration, in a worker's in-process
server and in a standalone one, as the JAX package reads it: at off the
summation engine owns the fused keys, whose pushes are decoded into it and
whose pulls are its merged rounds re-encoded.

The knobs of ``REFUSED`` select behaviour the port does not have yet:
at their defaults they change nothing, and any other value raises
``NotImplementedError`` in ``Config.from_env`` instead of running the
default path. The other fields of the JAX package's ``Config`` are read
outside this one (``BPS_LOG_LEVEL``, ``BPS_STATS``) or only tune a mode
that is refused (``tests/test_torch_hygiene.py`` holds the list).

The original ``BYTEPS_``/``DMLC_`` spellings are accepted as fallbacks so
that launch scripts written for the reference keep working.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_TRUE = {"1", "true", "yes", "on"}


def _env(name: str, legacy: Optional[str] = None, default: Optional[str] = None,
         env=None) -> Optional[str]:
    """Read BPS_* env var, falling back to the legacy BYTEPS_/DMLC_ name
    (from ``env``, default ``os.environ``)."""
    env = os.environ if env is None else env
    v = env.get(name)
    if v is None and legacy is not None:
        v = env.get(legacy)
    return v if v is not None else default


def _env_int(name: str, legacy: Optional[str], default: int) -> int:
    v = _env(name, legacy)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, legacy: Optional[str], default: bool = False,
              env=None) -> bool:
    v = _env(name, legacy, env=env)
    if v is None:
        return default
    return v.strip().lower() in _TRUE


# field of the JAX package's Config: (env var, legacy name, default, type,
# what a non-default value selects there)
REFUSED = {
    "role": ("BPS_ROLE", "DMLC_ROLE", "worker", str,
             "a server or scheduler role in a worker's Config (the port's "
             "server process is `python -m byteps_tpu_torch.launcher.launch "
             "--server`, which builds no Config; there is no scheduler)"),
    "plane_replicas": ("BPS_PLANE_REPLICAS", None, 0, int,
                       "the managed server plane (replicated shards)"),
    "emu_nic_rate": ("BPS_EMU_NIC_RATE", None, 0.0, float,
                     "the emulated NIC of a worker"),
    "host_only": ("BPS_HOST_ONLY", None, False, bool,
                  "the host-only runtime"),
    "key_hash_fn": ("BPS_KEY_HASH_FN", "BYTEPS_KEY_HASH_FN", "djb2", str,
                    "a key placement other than djb2"),
    "trace_on": ("BPS_TRACE_ON", "BYTEPS_TRACE_ON", False, bool,
                 "the step-window tracer"),
    "stats_file": ("BPS_STATS_FILE", None, "", str,
                   "the rolling StepStats dump"),
    "fleet_scrape_sec": ("BPS_FLEET_SCRAPE_SEC", None, 0.0, float,
                         "the fleet telemetry scraper"),
    "metrics_port": ("BPS_METRICS_PORT", None, 0, int,
                     "the HTTP metrics exporter"),
}


def _refused_value(env: str, legacy: Optional[str], default, kind):
    v = _env(env, legacy)
    if v is None or (kind is not str and v.strip() == ""):
        return default
    return v.strip().lower() in _TRUE if kind is bool else kind(v)


def check_refused() -> None:
    """Raise for a ``REFUSED`` knob set to another value than its
    default."""
    for env, legacy, default, kind, what in REFUSED.values():
        value = _refused_value(env, legacy, default, kind)
        if value != default:
            name = env if _env(env) is not None else legacy
            raise NotImplementedError(
                f"{name}={_env(env, legacy)!r}: {what} is not ported yet "
                "(see ROADMAP.md, 'Modules still to port'); the port "
                "refuses the knob rather than run its default path")


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen snapshot of the runtime knobs, resolved at ``init()``."""

    worker_id: int = 0
    num_worker: int = 1
    local_rank: int = 0
    local_size: int = 1
    coordinator_address: Optional[str] = None
    partition_bytes: int = 4096000       # BYTEPS_PARTITION_BYTES default, global.cc:134
    min_compress_bytes: int = 65536      # BYTEPS_MIN_COMPRESS_BYTES default 64KiB, global.cc:137-139
    enable_async: bool = False
    enable_ps: bool = False
    server_addrs: str = ""               # BPS_SERVER_ADDRS: host:port,... (empty: in-process)
    server_engine_threads: int = 4       # BYTEPS_SERVER_ENGINE_THREAD
    server_enable_schedule: bool = False  # BYTEPS_SERVER_ENABLE_SCHEDULE
    compress: str = "none"               # BPS_COMPRESS
    watchdog_sec: float = 0.0            # BPS_WATCHDOG_SEC (0 = off)
    pp_stages: int = 1                   # BPS_PP_STAGES (1 = no pipeline)
    sharded_update: bool = False         # BPS_SHARDED_UPDATE
    shard_rank: int = -1                 # BPS_SHARD_RANK (-1 = worker_id)
    shard_world: int = 0                 # BPS_SHARD_WORLD (0 = num_worker)
    scheduling_credit: int = 0           # 0 = disabled, scheduled_queue.cc:35-45
    telemetry_on: bool = False
    debug_sample_tensor: str = ""        # BYTEPS_DEBUG_SAMPLE_TENSOR

    @staticmethod
    def from_env(**overrides) -> "Config":
        check_refused()
        cfg = dict(
            worker_id=_env_int("BPS_WORKER_ID", "DMLC_WORKER_ID", 0),
            num_worker=_env_int("BPS_NUM_WORKER", "DMLC_NUM_WORKER", 1),
            local_rank=_env_int("BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", 1),
            coordinator_address=_env("BPS_COORDINATOR_ADDRESS", "DMLC_PS_ROOT_URI"),
            partition_bytes=_env_int("BPS_PARTITION_BYTES", "BYTEPS_PARTITION_BYTES", 4096000),
            min_compress_bytes=_env_int("BPS_MIN_COMPRESS_BYTES", "BYTEPS_MIN_COMPRESS_BYTES", 65536),
            enable_async=_env_bool("BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC"),
            enable_ps=_env_bool("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS"),
            server_addrs=_env("BPS_SERVER_ADDRS", None, ""),
            server_engine_threads=_env_int("BPS_SERVER_ENGINE_THREAD",
                                           "BYTEPS_SERVER_ENGINE_THREAD", 4),
            server_enable_schedule=_env_bool("BPS_SERVER_ENABLE_SCHEDULE",
                                             "BYTEPS_SERVER_ENABLE_SCHEDULE"),
            compress=(_env("BPS_COMPRESS", None, "none") or "none").lower(),
            watchdog_sec=float(_env("BPS_WATCHDOG_SEC", None, "0") or 0),
            pp_stages=_env_int("BPS_PP_STAGES", None, 1),
            sharded_update=_env_bool("BPS_SHARDED_UPDATE", None),
            shard_rank=_env_int("BPS_SHARD_RANK", None, -1),
            shard_world=_env_int("BPS_SHARD_WORLD", None, 0),
            scheduling_credit=_env_int("BPS_SCHEDULING_CREDIT",
                                       "BYTEPS_SCHEDULING_CREDIT", 0),
            telemetry_on=_env_bool("BPS_TELEMETRY_ON", "BYTEPS_TELEMETRY_ON"),
            debug_sample_tensor=_env("BPS_DEBUG_SAMPLE_TENSOR",
                                     "BYTEPS_DEBUG_SAMPLE_TENSOR", ""),
        )
        cfg.update(overrides)
        return Config(**cfg)
