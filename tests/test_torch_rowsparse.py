"""The port's row-sparse push_pull (``byteps_tpu_torch/server/rowsparse.py``,
``HostPSBackend.push_rowsparse``, ``ps_mode.RowSparseExchange``,
``bps.push_pull_rowsparse``) against the JAX package's on the same numpy
inputs: the wire bytes, the scatter-add, the two-worker sums, the empty
push, the errors, and the public call over three rounds of one table, at
world 1 and at world 2 (a port worker and a JAX worker on one server).

Tolerance: none. The wire is bytes, the scatter-add is ``np.add.at`` in
index order on both sides, and the sums are the engine's.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import rowsparse as jrs
import byteps_tpu_torch as bps
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import rowsparse as prs
from byteps_tpu_torch.server import transport as ptransport

ROWS, COLS = 50, 8
_ENV = ("BPS_ENABLE_PS", "BYTEPS_ENABLE_PS", "BPS_ENABLE_ASYNC",
        "BYTEPS_ENABLE_ASYNC", "BPS_NUM_WORKER", "DMLC_NUM_WORKER",
        "BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_SERVER_ADDRS",
        "BPS_COMPRESS", "BPS_MAX_LAG", "BPS_SHARDED_UPDATE")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    bps.shutdown()
    jbps.shutdown()
    torch.set_num_threads(n)


def _rows(seed, n, cols=COLS, dtype=np.float32):
    return np.random.RandomState(seed).randn(n, cols).astype(dtype)


# (idx, rows) cases: duplicates, n = 0, int64 indices over float64 rows,
# float16 rows
CASES = {
    "duplicates": (np.array([3, 7, 3, 49], np.int32), _rows(0, 4)),
    "empty": (np.zeros(0, np.int32), np.zeros((0, COLS), np.float32)),
    "int64_f64": (np.array([0, 1, 1, 1, 48], np.int64),
                  _rows(1, 5, dtype=np.float64)),
    "f16": (np.array([9, 2], np.int32), _rows(2, 2, dtype=np.float16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_and_unpack_are_the_references_byte_for_byte(case):
    idx, rows = CASES[case]
    wire = prs.pack_rows(idx, rows)
    assert wire == jrs.pack_rows(idx, rows)
    assert len(wire) == 4 + 4 * idx.size + rows.nbytes
    dt = str(rows.dtype)
    (i1, r1), (i2, r2) = prs.unpack_rows(wire, dt), jrs.unpack_rows(wire, dt)
    assert i1.tobytes() == i2.tobytes() and r1.tobytes() == r2.tobytes()
    assert (i1.dtype, r1.dtype, r1.shape) == (i2.dtype, r2.dtype, r2.shape)
    # from a memoryview too, without a copy
    i3, r3 = prs.unpack_rows(memoryview(wire), dt)
    assert r3.tobytes() == r1.tobytes() and not r3.flags.owndata


def test_scatter_dense_sums_duplicates_in_index_order():
    """Many repeats of few rows at magnitudes where the order of the fp32
    adds shows in the bits: the reference's, bit for bit."""
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 6, 400).astype(np.int32)
    rows = (rng.randn(400, COLS) * 10.0 ** rng.randint(-4, 4, (400, 1))
            ).astype(np.float32)
    got = prs.scatter_dense(idx, rows, ROWS, "float32")
    want = jrs.scatter_dense(idx, rows, ROWS, "float32")
    assert got.tobytes() == want.tobytes()
    assert got.shape == (ROWS, COLS)
    loop = np.zeros((ROWS, COLS), np.float32)
    for i, r in zip(idx, rows):
        loop[i] += r
    assert got.tobytes() == loop.tobytes()


def _two_worker_rounds(eng, pushes, rounds=2):
    be = eng.HostPSBackend(num_servers=1, num_workers=2, engine_threads=1)
    try:
        nbytes = ROWS * COLS * 4
        be.init_key(5, nbytes, "float32")
        outs = []
        for rnd in range(1, rounds + 1):
            for idx, rows in pushes:
                be.push_rowsparse(5, idx, rows * rnd, nbytes)
            out = np.empty(ROWS * COLS, np.float32)
            be.pull(5, out, round=rnd, timeout_ms=5000)
            outs.append(out)
        return outs
    finally:
        be.close()


def test_two_worker_backend_sum_is_the_jax_backends():
    pushes = [(np.array([0, 10, 10], np.int32), _rows(1, 3)),
              (np.array([10, 49], np.int32), _rows(2, 2))]
    ctr = get_registry().counter("server/rowsparse_pushes")
    before = ctr.value
    mine = _two_worker_rounds(pengine, pushes)
    ref = _two_worker_rounds(jengine, pushes)
    assert ctr.value - before == 4
    for rnd, (a, b) in enumerate(zip(mine, ref), 1):
        assert a.tobytes() == b.tobytes()
        want = sum(jrs.scatter_dense(i, r * rnd, ROWS, "float32")
                   for i, r in pushes)
        assert a.tobytes() == want.reshape(-1).tobytes()


@pytest.mark.parametrize("eng", [pengine, jengine], ids=["port", "jax"])
def test_an_empty_push_joins_the_round(eng):
    be = eng.HostPSBackend(num_servers=1, num_workers=2, engine_threads=1)
    try:
        nbytes = ROWS * COLS * 4
        be.init_key(6, nbytes, "float32")
        r = np.full((1, COLS), 2.0, np.float32)
        be.push_rowsparse(6, np.array([7], np.int32), r, nbytes)
        be.push_rowsparse(6, np.zeros(0, np.int32),
                          np.zeros((0, COLS), np.float32), nbytes)
        out = np.empty(ROWS * COLS, np.float32)
        be.pull(6, out, round=1, timeout_ms=5000)
        want = np.zeros((ROWS, COLS), np.float32)
        want[7] = 2.0
        assert out.tobytes() == want.reshape(-1).tobytes()
        assert be.round(6) == 1
    finally:
        be.close()


class _Recorder:
    """A backend that keeps what ``rowsparse_push`` hands its engine."""

    def __init__(self):
        self.pushed = []

    def push(self, key, data):
        self.pushed.append((key, np.array(data)))


# (idx, rows, dense_nbytes, dtype, a push before it with other cols)
ERRORS = {
    "cols_mismatch": (np.array([0]), np.ones((1, COLS // 2)), ROWS * COLS * 8,
                      None, True),
    "index_high": (np.array([ROWS]), np.ones((1, COLS)), ROWS * COLS * 8,
                   None, False),
    "index_negative": (np.array([-1]), np.ones((1, COLS)), ROWS * COLS * 8,
                       None, False),
    "size_not_elements": (np.array([0]), np.ones((1, COLS)),
                          ROWS * COLS * 8 + 3, None, False),
    "cols_not_table": (np.array([0]), np.ones((1, 7)), ROWS * COLS * 8,
                       None, False),
    "rows_not_idx": (np.array([0, 1]), np.ones((3, COLS)), ROWS * COLS * 8,
                     None, False),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_are_the_references(case):
    idx, rows, nbytes, dtype, first = ERRORS[case]
    got = []
    for mod in (prs, jrs):
        be, meta = _Recorder(), {}
        if first:
            mod.rowsparse_push(be, 3, np.array([1]), np.ones((1, COLS)),
                               nbytes, meta=meta)
        with pytest.raises(ValueError) as e:
            mod.rowsparse_push(be, 3, idx, rows, nbytes, dtype, meta=meta)
        got.append((str(e.value), len(be.pushed)))
    assert got[0] == got[1]
    assert got[0][1] == (1 if first else 0)      # nothing landed


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
def test_the_table_dtype_is_derived_as_the_reference_derives_it(dtype):
    idx, rows = np.array([3, 3, 9]), _rows(4, 3, dtype=np.float64)
    got = []
    for mod in (prs, jrs):
        be = _Recorder()
        itemsize = np.dtype(dtype or rows.dtype).itemsize
        mod.rowsparse_push(be, 1, idx, rows, ROWS * COLS * itemsize, dtype)
        (_, arr), = be.pushed
        got.append((arr.dtype, arr.shape, arr.tobytes()))
    assert got[0] == got[1]


def _mesh1():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


def _rounds(seed):
    """Three rounds of one worker's (indices, rows), duplicates kept."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, ROWS, 12), rng.randn(12, COLS).astype(np.float32))
            for _ in range(3)]


def test_push_pull_rowsparse_is_the_jax_packages_at_world_one(monkeypatch):
    """Three rounds under one name, ``average`` on the last: the port's
    tensor on the CPU (int64 indices) is the JAX package's array bit for
    bit, each round's table its own; a shape change is refused."""
    monkeypatch.setenv("BPS_ENABLE_PS", "1")
    bps.init(device="cpu")
    jbps.init(mesh=_mesh1())
    reg = get_registry()
    push0, pull0 = (reg.counter("ps/push_bytes").value,
                    reg.counter("ps/pull_bytes").value)
    prev = None
    for rnd, (idx, rows) in enumerate(_rounds(0)):
        avg = rnd == 2
        out = bps.push_pull_rowsparse(torch.from_numpy(idx),
                                      torch.from_numpy(rows), ROWS,
                                      average=avg, name="emb")
        ref = jbps.push_pull_rowsparse(idx.astype(np.int32), rows, ROWS,
                                       average=avg, name="emb")
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        assert tuple(out.shape) == (ROWS, COLS) and out.dtype == torch.float32
        assert out.numpy().tobytes() == np.asarray(ref).tobytes()
        assert out.numpy().tobytes() == jrs.scatter_dense(
            idx.astype(np.int32), rows, ROWS, "float32").tobytes()
        assert prev is None or not torch.equal(out, prev)
        prev = out
    assert reg.counter("ps/push_bytes").value - push0 == 3 * (
        4 + 12 * 4 + 12 * COLS * 4)
    assert reg.counter("ps/pull_bytes").value - pull0 == 3 * ROWS * COLS * 4
    for mod in (bps, jbps):
        with pytest.raises(ValueError, match="shape must be stable"):
            mod.push_pull_rowsparse(np.array([0], np.int32) if mod is jbps
                                    else torch.tensor([0]),
                                    np.ones((1, COLS), np.float32)
                                    if mod is jbps else torch.ones(1, COLS),
                                    ROWS + 1, name="emb")


def test_push_pull_rowsparse_at_world_two_is_the_jax_workers(monkeypatch):
    """A port worker and a JAX worker push their own rows of one table to
    one port server over TCP, three rounds, ``average`` on the last: both
    return the same table bit for bit, the numpy scatter-adds summed (and
    halved in round 3)."""
    eng = pengine.PSServer(num_workers=2, engine_threads=1)
    srv = ptransport.PSTransportServer(eng, host="127.0.0.1", port=0)
    try:
        monkeypatch.setenv("BPS_ENABLE_PS", "1")
        monkeypatch.setenv("BPS_NUM_WORKER", "2")
        monkeypatch.setenv("BPS_SERVER_ADDRS", f"127.0.0.1:{srv.port}")
        bps.init(device="cpu")
        jbps.init(mesh=_mesh1())
        rounds = {0: _rounds(1), 1: _rounds(2)}
        outs = {0: [], 1: []}

        def worker(wid):
            for rnd, (idx, rows) in enumerate(rounds[wid]):
                if wid == 0:
                    o = bps.push_pull_rowsparse(
                        torch.from_numpy(idx), torch.from_numpy(rows), ROWS,
                        average=rnd == 2, name="emb").numpy()
                else:
                    o = np.asarray(jbps.push_pull_rowsparse(
                        idx, rows, ROWS, average=rnd == 2, name="emb"))
                outs[wid].append(o)

        ts = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts), "a worker hung"
        for rnd in range(3):
            want = (jrs.scatter_dense(rounds[0][rnd][0].astype(np.int32),
                                      rounds[0][rnd][1], ROWS, "float32")
                    + jrs.scatter_dense(rounds[1][rnd][0].astype(np.int32),
                                        rounds[1][rnd][1], ROWS, "float32"))
            if rnd == 2:
                want = want / 2
            assert outs[0][rnd].tobytes() == outs[1][rnd].tobytes()
            assert outs[0][rnd].tobytes() == want.tobytes()
    finally:
        bps.shutdown()
        jbps.shutdown()
        srv.close()
        eng.close()


def test_the_refusals_are_the_references(monkeypatch):
    """Without PS, and under async PS, both packages refuse with the same
    reason; bfloat16 rows are refused in the port."""
    idx, rows = np.array([0], np.int32), np.ones((1, COLS), np.float32)
    for env, match in (({}, "rides the PS path"),
                       ({"BPS_ENABLE_PS": "1", "BPS_ENABLE_ASYNC": "1"},
                        "needs SYNC PS mode")):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        bps.init(device="cpu")
        jbps.init(mesh=_mesh1())
        with pytest.raises(NotImplementedError, match=match):
            bps.push_pull_rowsparse(torch.from_numpy(idx),
                                    torch.from_numpy(rows), ROWS)
        with pytest.raises(NotImplementedError, match=match):
            jbps.push_pull_rowsparse(idx, rows, ROWS)
        bps.shutdown()
        jbps.shutdown()
    monkeypatch.delenv("BPS_ENABLE_ASYNC")
    bps.init(device="cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        bps.push_pull_rowsparse(torch.tensor([0]),
                                torch.ones(1, COLS, dtype=torch.bfloat16),
                                ROWS)
