"""Ground rules of the PyTorch/CUDA port, checked on the CPU.

  - ``byteps_tpu_torch`` (and ``chip_smoke.py``, which drives it) imports
    no ``jax``, no ``optax`` and nothing of ``byteps_tpu``: it keeps its
    own copies of what it needs;
  - its entry points run on the card unless asked otherwise, and raise
    where there is none;
  - what is not ported raises instead of running some other path;
  - no comment or docstring carries a measurement taken on a TPU.
"""

import ast
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
             "BPS_ENABLE_ASYNC", "BYTEPS_ENABLE_ASYNC")


@pytest.fixture(autouse=True)
def _port_env_unset(monkeypatch):
    for name in _PORT_ENV:
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
            "byteps_tpu_torch.ops._build, byteps_tpu_torch.models.flops; "
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
                         + sorted((PORT / "csrc").glob("*.cu*")),
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
    ({"compression": {"compressor_type": "onebit"}}, "compression"),
    ({"reducer": lambda x, g: x}, "reducer"),
])
def test_trainer_refuses_unported_options(kw, match):
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    model = bert.Transformer(bert.bert_tiny())
    with pytest.raises(NotImplementedError, match=match):
        DistributedTrainer(lambda m, b: 0, model,
                           adamw(model.parameters(), 1e-3), device="cpu", **kw)


@pytest.mark.parametrize("env", ["BPS_ENABLE_PS", "BPS_ENABLE_ASYNC"])
def test_trainer_refuses_the_ps_paths(env, monkeypatch):
    from byteps_tpu_torch.models import bert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    monkeypatch.setenv(env, "1")
    model = bert.Transformer(bert.bert_tiny())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DistributedTrainer(lambda m, b: 0, model,
                           adamw(model.parameters(), 1e-3), device="cpu")


@pytest.mark.parametrize("kw", [{"tp_axis": "model"}, {"sp_axis": "seq"},
                                {"pp_axis": "pipe"}, {"lm_head_chunk": 128},
                                {"remat_policy": "dots"}])
def test_unported_model_options_raise(kw):
    from byteps_tpu_torch.models import bert
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bert.bert_large(**kw)


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
