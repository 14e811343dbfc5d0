"""Ground rules of the PyTorch/CUDA port, checked on the CPU.

  - ``byteps_tpu_torch`` (and ``chip_smoke.py``, which drives it) imports
    no ``jax``, no ``optax`` and nothing of ``byteps_tpu``: it keeps its
    own copies of what it needs;
  - its entry points run on the card unless asked otherwise, and raise
    where there is none;
  - what is not ported raises instead of running some other path: every
    field of the JAX package's ``Config`` is read by the port or refused
    at a non-default value;
  - no comment or docstring carries a measurement taken on a TPU.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "byteps_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "byteps_tpu")


# the port's env knobs: other tests in the same worker process may leave
# some set (BPS_NUM_WORKER, BPS_ENABLE_PS, ...), so each test here starts
# without them
_PORT_ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
             "DMLC_NUM_WORKER", "BPS_LOCAL_RANK", "BYTEPS_LOCAL_RANK",
             "BPS_LOCAL_SIZE", "BYTEPS_LOCAL_SIZE", "BPS_COORDINATOR_ADDRESS",
             "DMLC_PS_ROOT_URI", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
             "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC", "BPS_SERVER_ADDRS",
             "BPS_COMPRESS", "BPS_COMPRESS_DEVICE", "BPS_PP_STAGES",
             "BPS_SCHEDULING_CREDIT", "BYTEPS_SCHEDULING_CREDIT",
             "BPS_TELEMETRY_ON", "BYTEPS_TELEMETRY_ON",
             "BPS_DEBUG_SAMPLE_TENSOR", "BYTEPS_DEBUG_SAMPLE_TENSOR",
             "BPS_PARTITION_BYTES")


def _refused_env():
    from byteps_tpu_torch.common.config import REFUSED
    return [n for env, legacy, *_ in REFUSED.values()
            for n in (env, legacy) if n]


@pytest.fixture(autouse=True)
def _port_env_unset(monkeypatch):
    for name in _PORT_ENV + tuple(_refused_env()):
        monkeypatch.delenv(name, raising=False)


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, byteps_tpu_torch, byteps_tpu_torch.training, "
            "byteps_tpu_torch.models.bert, byteps_tpu_torch.convert, "
            "byteps_tpu_torch.ops._build, byteps_tpu_torch.models.flops, "
            "byteps_tpu_torch.models.gpt2, byteps_tpu_torch.models.t5, "
            "byteps_tpu_torch.ops.relpos, byteps_tpu_torch.ops.compression, "
            "byteps_tpu_torch.ops.compression.kernels, "
            "byteps_tpu_torch.ops._build_host, "
            "byteps_tpu_torch.server.ps_mode, byteps_tpu_torch.server.homog, "
            "byteps_tpu_torch.compress.plane, byteps_tpu_torch.compress.device, "
            "byteps_tpu_torch.compress.controller, byteps_tpu_torch.obs.flight, "
            "byteps_tpu_torch.obs.watchdog, byteps_tpu_torch.server.compressed, "
            "byteps_tpu_torch.ops.compression.host, "
            "byteps_tpu_torch.ops.compression.rng, "
            "byteps_tpu_torch.torch, byteps_tpu_torch.telemetry, "
            "byteps_tpu_torch.server.transport, "
            "byteps_tpu_torch.launcher.launch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# a TPU measurement: a time or rate figure, or the word "measured"
_MEASUREMENT = re.compile(
    r"measured|\d\s*(ms|µs|us|sps|samples/s(ec)?|TFLOP/s|GB/s)\b", re.I)


def _comments_and_docstrings(path: Path):
    src = path.read_text()
    if path.suffix == ".py":
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                doc = ast.get_docstring(node)
                if doc:
                    yield node.__class__.__name__, doc
        for i, line in enumerate(src.splitlines(), 1):
            if "#" in line:
                yield i, line[line.index("#"):]
    else:                                     # CUDA sources: // comments
        for i, line in enumerate(src.splitlines(), 1):
            if "//" in line:
                yield i, line[line.index("//"):]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted((PORT / "csrc").glob("*.cu*"))
                         + sorted((PORT / "csrc" / "host").glob("*.cc")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_tpu_measurement_in_port_comments(path):
    hits = [(where, text.strip()[:80])
            for where, text in _comments_and_docstrings(path)
            if _MEASUREMENT.search(text)]
    assert not hits, f"{path.relative_to(REPO)}: {hits}"


def test_trainer_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    model = bert.Transformer(bert.bert_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedTrainer(lambda m, b: 0, model, adamw(model.parameters(), 1e-3))
    # asked for explicitly, the CPU works
    DistributedTrainer(lambda m, b: 0, model, adamw(model.parameters(), 1e-3),
                       device="cpu")


def test_init_defaults_to_the_card_and_world_one_needs_no_group():
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bps.init()
    bps.init(device="cpu")
    try:
        assert (bps.rank(), bps.size(), bps.local_rank(), bps.local_size()) \
            == (0, 1, 0, 1)
        assert not dist.is_initialized()
    finally:
        bps.shutdown()


@pytest.mark.parametrize("kw,match", [
    ({"compression": {"compressor_type": "topk"}}, "compression"),
    ({"reducer": lambda x, g: x}, "reducer"),
    ({"compression": {"compressor_type": "onebit", "exchange": "rs"}},
     "compression"),
])
def test_trainer_refuses_unported_options(kw, match, monkeypatch):
    """Where the options that ``DistributedTrainer`` takes (topk, the rs
    exchange, a custom reducer) are refused: a custom reducer in PS mode
    is the JAX trainer's ValueError, raised before the PS path needs
    ``bps.init()``. Compression in ``ShardedTrainer``, refused until it
    was ported, now builds the compressed plan over the data axis
    (``test_torch_sp.py``, ``test_torch_sp_options_gloo.py``)."""
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.parallel.mesh import make_mesh
    from byteps_tpu_torch.training import DistributedTrainer, ShardedTrainer
    model = bert.Transformer(bert.bert_tiny())
    opt = adamw(model.parameters(), 1e-3)
    if "reducer" in kw:
        monkeypatch.setenv("BPS_ENABLE_PS", "1")
        with pytest.raises(ValueError, match=f"{match}.*PS mode"):
            DistributedTrainer(lambda m, b: 0, model, opt, device="cpu", **kw)
        return
    tr = ShardedTrainer(lambda m, b: 0, model, opt, make_mesh({"seq": 1}),
                        device="cpu", **kw)
    assert tr.tx.plan is not None and tr.tx.plan.world == 1


@pytest.mark.parametrize("env", ["BPS_ENABLE_PS", "BPS_ENABLE_ASYNC"])
def test_trainer_refuses_the_ps_paths(env, monkeypatch):
    """The sync PS path is ported, with the in-process server and with
    standalone servers (the remote transport), but not the managed server
    plane over them (``BPS_PLANE_REPLICAS``). The async path is ported (it
    builds its worker), but not under ``BPS_MAX_LAG`` > 1, which the JAX
    package's async step never reads."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    monkeypatch.setenv(env, "1")
    model = bert.Transformer(bert.bert_tiny())

    def build():
        return DistributedTrainer(lambda m, b: 0, model,
                                  adamw(model.parameters(), 1e-3),
                                  device="cpu")

    if env == "BPS_ENABLE_PS":
        monkeypatch.setenv("BPS_SERVER_ADDRS", "localhost:1,localhost:2")
        monkeypatch.setenv("BPS_PLANE_REPLICAS", "1")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build()
        return
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    bps.init(device="cpu")
    try:
        assert build()._async_worker is not None
        monkeypatch.setenv("BPS_MAX_LAG", "2")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build()
    finally:
        bps.shutdown()


@pytest.mark.parametrize("kw", [{"tp_axis": "model"},
                                {"pp_axis": "pipe"}, {"lm_head_chunk": 128},
                                {"remat_policy": "dots"}])
def test_unported_model_options_raise(kw):
    """Tensor and pipeline parallelism raise; the chunked head and the
    remat policies, refused until they were ported, now construct
    (``test_torch_model_options.py`` and ``test_torch_lm_head.py`` hold
    them against the JAX package)."""
    from byteps_tpu_torch.models import bert
    if "tp_axis" not in kw and "pp_axis" not in kw:
        cfg = bert.bert_large(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bert.bert_large(**kw)


# Fields of the JAX package's Config that the port reads outside its own
# Config: field -> (the port's module, the env var it reads)
READ_ELSEWHERE = {"log_level": ("common/logging.py", "BPS_LOG_LEVEL"),
                  "stats_on": ("obs/metrics.py", "BPS_STATS")}
# Fields that only tune a mode another knob selects: field -> that knob's
# field, which the port refuses (REFUSED, or BPS_SERVER_ADDRS and
# BPS_PP_STAGES, refused where they would act). Alone they change nothing
# in the JAX package either.
SUBORDINATE = {
    "pp_rank": "pp_stages", "pp_microbatch": "pp_stages",
    "pp_virtual": "pp_stages",
    "trace_start_step": "trace_on", "trace_end_step": "trace_on",
    "trace_dir": "trace_on", "trace_profiler": "trace_on",
    "stats_every": "stats_file",
    # the managed server plane's and the emulated NIC's tuning knobs act
    # only with the plane (BPS_PLANE_REPLICAS) or the NIC
    # (BPS_EMU_NIC_RATE), both refused
    "plane_rebalance_sec": "plane_replicas", "plane_vnodes": "plane_replicas",
    "plane_liveness": "plane_replicas",
    "emu_nic_latency": "emu_nic_rate",
}
# Knobs that need no refusal, with the reason.
EXEMPT = {
    # read by the JAX trainer outside its Config: the staged head's cache
    # of compiled segment programs per batch signature. Eager PyTorch
    # compiles no segments, so there is nothing to cache or bound
    "staged_cache": "no compiled segments in eager mode (BPS_STAGED_CACHE)",
    # jax.distributed's process count and index; the port's process group
    # is num_worker / worker_id, which fall back to the same DMLC_ names
    "num_processes": "jax.distributed only",
    "process_id": "jax.distributed only",
    # the JAX package's Config reads them and no module acts on them
    "force_distributed": "acted on nowhere",
    "reverse_layer_priority": "acted on nowhere",
}


def test_every_reference_knob_is_read_or_refused():
    """Walk the fields of both Configs: each field of the JAX package's is
    read by the port (its own Config, or a named module), refused at a
    non-default value, subordinate to a refused knob, or exempt."""
    import dataclasses

    from byteps_tpu.common.config import Config as JConfig
    from byteps_tpu_torch.common.config import REFUSED, Config
    ref = [f.name for f in dataclasses.fields(JConfig)]
    ours = {f.name for f in dataclasses.fields(Config)}
    assert ours <= set(ref), f"port fields unknown to the reference: " \
        f"{ours - set(ref)}"
    for field, (module, env) in READ_ELSEWHERE.items():
        assert env in (PORT / module).read_text(), (field, module)
    for field, selector in SUBORDINATE.items():
        assert selector in REFUSED or selector in ("pp_stages",
                                                   "server_addrs"), field
    covered = ours | set(READ_ELSEWHERE) | set(REFUSED) | set(SUBORDINATE) \
        | set(EXEMPT)
    missing = [f for f in ref if f not in covered]
    assert not missing, f"reference knobs neither read nor refused: {missing}"
    groups = [ours, set(READ_ELSEWHERE), set(REFUSED), set(SUBORDINATE),
              set(EXEMPT)]
    assert sum(map(len, groups)) == len(set().union(*groups))


# Knobs the port acts on outside its Config, where the JAX package reads
# them: env var -> the modules that read it. ``BPS_WATCHDOG_SEC``, refused
# until the watchdog was ported, is a Config field the exchange acts on.
ACTED_ON = {
    "BPS_WATCHDOG_SEC": ("common/config.py", "server/ps_mode.py"),
    "BPS_COMPRESS_INTERVAL": ("compress/plane.py",),
    "BPS_COMPRESS_MAX": ("compress/plane.py",),
    "BPS_FLIGHT_RECORDER": ("obs/flight.py",),
    "BPS_FLIGHT_RECORDER_SIZE": ("obs/flight.py",),
    "BPS_NATIVE_CODEC": ("ops/compression/host.py", "server/compressed.py"),
    # the overlap schedule of the PS step (read when a trainer is built)
    "BPS_APPLY_CHUNKED": ("training.py",),
    "BPS_CROSS_STEP": ("training.py",),
    "BPS_BWD_STAGED": ("training.py",),
    "BPS_BWD_GROUPS": ("training.py",),
    # standalone servers and the remote transport
    "BPS_SERVER_ADDRS": ("common/config.py", "common/global_state.py"),
    "BPS_PS_CONNS": ("server/transport.py",),
    "BPS_RECONNECT_SECS": ("server/transport.py",),
    "BPS_PULL_TIMEOUT_MS": ("server/transport.py",),
    "BPS_PUSH_DEDUP_TTL_SECS": ("server/transport.py",),
    # the wire credit of the transport beside the engine's collectives
    "BPS_SCHEDULING_CREDIT": ("common/config.py", "server/admission.py"),
    # the launcher's server role (it builds no Config)
    "BPS_SERVER_PORT": ("launcher/launch.py",),
    # the sharded weight update
    "BPS_SHARDED_UPDATE": ("common/config.py", "training.py"),
    "BPS_SHARD_RANK": ("common/config.py", "training.py"),
    "BPS_SHARD_WORLD": ("common/config.py", "training.py"),
    "BPS_PARAM_TIMEOUT_MS": ("sharded_update.py",),
    # bounded staleness (the JAX package reads both in its admission
    # module; no refusal is left for either)
    "BPS_MAX_LAG": ("server/admission.py",),
    "BPS_LAG_GRACE_MS": ("server/admission.py",),
    # async PS: the Config field, which the launcher's server role (no
    # Config there) reads by Config's rule, and the two knobs the JAX
    # package reads from os.environ only
    "BPS_ENABLE_ASYNC": ("common/config.py", "launcher/launch.py"),
    "BPS_ASYNC_WIRE_DTYPE": ("server/ps_mode.py",),
    "BPS_ASYNC_PULL_DTYPE": ("server/ps_mode.py",),
    # the engine-side fused route, read from os.environ where it acts
    "BPS_FUSED_HOMOG": ("server/homog.py",),
    # the transport's rest: the shm data plane, striping and the Unix
    # socket on both sides; the launcher's server snapshots
    "BPS_ENABLE_SHM": ("server/transport.py",),
    "BPS_STRIPE_MIN": ("server/transport.py",),
    "BPS_ENABLE_IPC": ("server/transport.py",),
    "BYTEPS_ENABLE_IPC": ("server/transport.py",),
    "BPS_IPC_DIR": ("server/transport.py",),
    "BPS_SERVER_SNAPSHOT": ("launcher/launch.py",),
    "BPS_SERVER_SNAPSHOT_SECS": ("launcher/launch.py",),
}


@pytest.mark.parametrize("env", sorted(ACTED_ON))
def test_knob_is_read_where_it_acts_and_listed(env):
    from byteps_tpu_torch.common import config
    from byteps_tpu_torch.common.config import REFUSED
    for module in ACTED_ON[env]:
        assert env in (PORT / module).read_text(), (env, module)
    assert env in config.__doc__
    assert env not in {e for e, *_ in REFUSED.values()}


def _refused_cases():
    from byteps_tpu_torch.common.config import REFUSED
    values = {"role": "server", "host_only": "1",
              "key_hash_fn": "naive", "trace_on": "1",
              "stats_file": "stats.json", "fleet_scrape_sec": "30",
              "metrics_port": "9100", "plane_replicas": "1",
              "emu_nic_rate": "1e9"}
    assert set(values) == set(REFUSED)
    return [pytest.param(f, REFUSED[f][0], v, id=f)
            for f, v in values.items()]


@pytest.mark.parametrize("field,env,value", _refused_cases())
def test_refused_knob_raises_at_a_non_default_value(field, env, value,
                                                     monkeypatch):
    """The value changes what the JAX package does (its Config reads
    another value than the default); the port raises rather than run its
    default path, and the default value itself still runs."""
    from byteps_tpu.common.config import Config as JConfig
    from byteps_tpu_torch.common.config import REFUSED, Config
    default = REFUSED[field][2]
    monkeypatch.setenv(env, str(default).lower() if isinstance(default, bool)
                       else str(default))
    Config.from_env()
    monkeypatch.setenv(env, value)
    assert getattr(JConfig.from_env(), field) != default
    with pytest.raises(NotImplementedError, match=f"{env}.*ROADMAP"):
        Config.from_env()


# -- the knobs the port acts on since the BytePS API came over: each acts,
# under either spelling

class _FakeWork:
    """An all-reduce of two identical ranks that completes when waited."""

    def __init__(self, buf, log):
        self.buf, self.done, self.log = buf, False, log

    def is_completed(self):
        return self.done

    def wait(self):
        if not self.done:
            self.buf.mul_(2)
            self.done = True
            self.log.append("wait")


@pytest.mark.parametrize("env", ["BPS_SCHEDULING_CREDIT",
                                 "BYTEPS_SCHEDULING_CREDIT"])
def test_scheduling_credit_bounds_the_bytes_in_flight(env, monkeypatch):
    """A world of two (collectives faked: each completes when waited on):
    with a credit, dispatch waits on the oldest buckets once their bytes
    exceed it; without one, every bucket is in flight at once."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel import collectives
    log, inflight = [], []

    def all_reduce(buf, op=None, group=None, async_op=False):
        inflight.append(sum(w.buf.nbytes for w in works if not w.done))
        works.append(_FakeWork(buf, log))
        return works[-1]

    monkeypatch.setattr(collectives.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(collectives, "data_group", lambda: "two-ranks")
    monkeypatch.setattr(collectives, "dp_size", lambda group=None: 2)
    monkeypatch.setenv("BPS_PARTITION_BYTES", "4096")
    tree = {f"t{i}": torch.full((1024,), float(i)) for i in range(8)}
    for credit in (0, 8192):
        works = []
        log.clear()
        inflight.clear()
        monkeypatch.setenv(env, str(credit))
        bps.init(device="cpu")
        try:
            waits = bps.get_metrics().stage("CREDIT_BLOCK")
            before = waits.count
            out = bps.push_pull(tree)
            for k, v in tree.items():
                assert torch.equal(out[k], v)      # the mean of two equals
            assert len(works) == 8
            if credit:
                assert max(inflight) <= credit
                assert waits.count > before
            else:
                assert inflight == [4096 * i for i in range(8)]
                assert waits.count == before
        finally:
            bps.shutdown()


@pytest.mark.parametrize("env", ["BPS_TELEMETRY_ON", "BYTEPS_TELEMETRY_ON"])
def test_telemetry_records_push_pulls(env, monkeypatch):
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.global_state import GlobalState
    bps.init(device="cpu")
    try:
        assert GlobalState.get().telemetry is None
        bps.push_pull({"x": torch.ones(4096)})
        assert bps.get_pushpull_speed() == 0.0
    finally:
        bps.shutdown()
    monkeypatch.setenv(env, "1")
    bps.init(device="cpu")
    try:
        bps.push_pull({"x": torch.ones(4096)})
        assert bps.get_pushpull_speed() > 0.0
    finally:
        bps.shutdown()


@pytest.mark.parametrize("env", ["BPS_DEBUG_SAMPLE_TENSOR",
                                 "BYTEPS_DEBUG_SAMPLE_TENSOR"])
def test_debug_sampler_logs_matching_names(env, monkeypatch):
    import logging

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.logging import get_logger
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    monkeypatch.setenv(env, "grads")
    handler = Lines()
    get_logger().addHandler(handler)
    bps.init(device="cpu")
    try:
        x = {"w": torch.tensor([1.0, 3.0])}
        bps.push_pull(x, name="other")
        assert not lines
        bps.push_pull(x, name="grads.step")
        assert lines == ["SAMPLE grads.step['w'] mean=2 std=1 first=1"]
    finally:
        bps.shutdown()
        get_logger().removeHandler(handler)


def _transport_cases():
    from byteps_tpu_torch.server import transport as t
    values = {"BPS_REDUCE_ROOTS": "0", "BYTEPS_REDUCE_ROOTS": "0",
              "BPS_KEY_LOG": "1", "PS_KEY_LOG": "1", "BPS_NIC_RATE": "1e9"}
    cases = []
    for role, table in (("client", t.CLIENT_REFUSED),
                        ("server", t.SERVER_REFUSED),
                        ("launcher", t.LAUNCHER_REFUSED)):
        for env, (legacy, *_rest) in table.items():
            for name in (env, legacy):
                if name:
                    cases.append(pytest.param(role, name, values[name],
                                              id=f"{role}-{name}"))
    assert {c.values[1] for c in cases} == set(values)
    return cases


# where the JAX package reads each of those knobs
_JAX_READERS = ("server/transport.py", "server/homog.py",
                "common/naming.py", "launcher/launch.py")


@pytest.mark.parametrize("role,env,value", _transport_cases())
def test_transport_knob_raises_at_a_non_default_value(role, env, value,
                                                      monkeypatch):
    """The knobs the JAX transport, its fused front and its launcher read
    and the port does not act on: the role that would read one raises at
    a non-default value, and runs at the default."""
    from byteps_tpu_torch.launcher import launch
    from byteps_tpu_torch.server import transport as t
    from byteps_tpu_torch.server.engine import PSServer
    jax_src = "".join((REPO / "byteps_tpu" / f).read_text()
                      for f in _JAX_READERS)
    assert f'"{env}"' in jax_src
    for name in [n for tab in (t.CLIENT_REFUSED, t.SERVER_REFUSED,
                               t.LAUNCHER_REFUSED)
                 for k, v in tab.items() for n in (k, v[0]) if n]:
        monkeypatch.delenv(name, raising=False)
    eng = PSServer(num_workers=1, engine_threads=1)
    srv = t.PSTransportServer(eng, host="127.0.0.1", port=0)
    try:
        def build():
            if role == "client":
                t.RemotePSBackend([f"127.0.0.1:{srv.port}"]).close()
            elif role == "server":
                t.PSTransportServer(PSServer(1, 1), host="127.0.0.1").close()
            else:
                stop = __import__("threading").Event()
                stop.set()
                launch.run_server(dict(os.environ, BPS_SERVER_PORT="0"),
                                  stop=stop)

        build()                                   # the default runs
        monkeypatch.setenv(env, value)
        with pytest.raises(NotImplementedError, match=f"{env}.*ROADMAP"):
            build()
    finally:
        srv.close()
        eng.close()


def test_refused_knob_raises_under_its_legacy_name(monkeypatch):
    import byteps_tpu_torch as bps
    monkeypatch.setenv("DMLC_ROLE", "server")
    with pytest.raises(NotImplementedError, match="DMLC_ROLE"):
        bps.init(device="cpu")


def test_kernel_build_needs_nvcc_and_says_so(monkeypatch, tmp_path):
    from byteps_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_every_kernel_source_has_a_c_entry_and_a_signature():
    from byteps_tpu_torch.ops import _build
    stems = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert stems == set(_build.SIGNATURES)
    for stem, (name, argtypes) in _build.SIGNATURES.items():
        src = (PORT / "csrc" / f"{stem}.cu").read_text()
        m = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', src, re.S)
        assert m, f"{stem}.cu has no entry {name}"
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _wrappers_calling_plain(path: Path):
    """(wrapper, the ``*_plain`` calls outside its CPU branch) for every
    function of ``path`` that calls a plain version."""
    tree = ast.parse(path.read_text())
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name.endswith("_plain"):
            continue
        guarded = set()
        for node in ast.walk(fn):
            # the one place a plain version may run: the body of
            # ``if device_type(x, ...) == "cpu":``
            if (isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)
                    and isinstance(node.test.left, ast.Call)
                    and getattr(node.test.left.func, "id", "") == "device_type"
                    and [getattr(c, "value", None)
                         for c in node.test.comparators] == ["cpu"]):
                for stmt in node.body:
                    guarded.update(id(n) for n in ast.walk(stmt))
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", "").endswith("_plain")]
        if calls:
            yield fn.name, [n.func.id for n in calls if id(n) not in guarded]


@pytest.mark.parametrize("module", ["ops/compression/kernels.py",
                                    "ops/flash_attention.py"])
def test_a_cuda_tensor_never_reaches_a_plain_version(module):
    """A wrapper takes its plain version only inside its
    ``device_type(...) == "cpu"`` branch: a CUDA tensor launches the
    kernel or raises."""
    found = dict(_wrappers_calling_plain(PORT / module))
    assert found, f"{module} has no wrapper of a plain version"
    bad = {k: v for k, v in found.items() if v}
    assert not bad, f"{module}: plain versions outside the CPU branch {bad}"


def test_the_server_is_built_from_the_ports_own_source():
    from byteps_tpu_torch.ops import _build_host
    assert _build_host.SOURCE == PORT / "csrc" / "host" / "bps_server.cc"
    assert _build_host.SOURCE.is_file()
    path = _build_host.build()
    assert path.parent == PORT / "_build"
    lib = _build_host.load()
    assert Path(lib._name).resolve() == path.resolve()


# -- async PS, refused at three sites until it was ported

@pytest.mark.parametrize("site", ["init", "trainer", "launcher"])
def test_async_ps_constructs_at_each_site(site, monkeypatch):
    """``BPS_ENABLE_ASYNC=1`` builds the async path at each of the three
    sites that refused it (``bps.init``, the trainer, the launcher's server
    role); ``BPS_MAX_LAG`` > 1 raises nowhere but in the async trainer."""
    import threading

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common import config
    from byteps_tpu_torch.common.global_state import GlobalState
    from byteps_tpu_torch.launcher import launch
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.server import engine
    from byteps_tpu_torch.training import DistributedTrainer
    for name in ("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS", "BPS_SERVER_ADDRS",
                 "BPS_NUM_WORKER", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(name, raising=False)
    assert "BPS_MAX_LAG" not in {e for e, *_ in config.REFUSED.values()}
    monkeypatch.setenv("BPS_ENABLE_ASYNC", "1")
    if site == "launcher":
        made, real = [], engine.PSServer
        monkeypatch.setattr(engine, "PSServer", lambda *a, **kw: made.append(
            real(*a, **kw)) or made[-1])
        stop = threading.Event()
        stop.set()                  # serve, then stop at the first wake-up
        th = threading.Thread(target=launch.run_server, args=(
            {"BPS_ENABLE_ASYNC": "1", "BPS_SERVER_PORT": "0"}, stop))
        th.start()
        th.join(60)
        assert not th.is_alive() and made[0].async_mode is True
        return
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    bps.init(device="cpu")
    try:
        gs = GlobalState.get()
        assert gs.ps_backend.async_mode and gs.engine.ps_factory is None
        if site == "trainer":
            model = bert.Transformer(bert.bert_tiny())
            tr = DistributedTrainer(lambda m, b: 0, model,
                                    adamw(model.parameters(), 1e-3),
                                    device="cpu")
            assert tr._async_worker is not None and tr.ps_exchange is None
    finally:
        bps.shutdown()
