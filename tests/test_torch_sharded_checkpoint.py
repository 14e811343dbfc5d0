"""The port's sharded checkpoints (``byteps_tpu_torch/checkpoint.py``:
``save_sharded_checkpoint``, ``restore_sharded_checkpoint``;
``DistributedTrainer.restore_sharded``) against the JAX package's, on the
CPU.

  - A save after 3 steps at dp 2 and a restore into fresh trainers (built
    from other weights) continue bit for bit the uninterrupted 6 steps on
    both replicas and both routes (the JAX package's
    ``test_sharded_checkpoint_roundtrip_no_fallback``), without the
    full-tree fallback: the optimizer is untouched until the first step
    installs the owned slices, and state exists for the owned groups only.
  - The meta's keys and values are the JAX saver's for the same plan, and
    a slice of either package restores into the other's group.
  - A save taken after a reshard restores its owner map and member epoch
    (``adopt_membership``), and the run continues bit for bit.
  - Refusals: a restore after the first step, a meta without ``sharded``,
    ``embed=``, a save without an engaged sharded update; a missing slice
    warns; a re-save cut short leaves the committed checkpoint readable.

Tolerance: none (the same fp32 state into the same computation).
"""

import json
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu import checkpoint as jckpt
from byteps_tpu import sharded_update as jsu
from byteps_tpu_torch import checkpoint as ckpt
from byteps_tpu_torch import sharded_update as psu
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.optim import ChunkedApply

import _torch_sharded as h


@pytest.fixture(autouse=True)
def _torch_env():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    with h.env():
        yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


P0 = h.chain_params(depth=3, dim=64)
ZERO = {k: np.zeros_like(v) for k, v in P0.items()}
WB = [h.chain_batches(64, 20 + w, 8, bs=16) for w in range(2)]


def _rig(phases, name, **kw):
    start = kw.pop("start", 0)
    fresh = kw.pop("fresh", False)
    return h.run_phased(lambda: h.Chain(ZERO if fresh else P0), h.chain_loss,
                        WB, phases, name=name, start=start, **kw)


def _same_finals(a, b):
    for f in (a["finals"][1], b["finals"][0], b["finals"][1]):
        for x, y in zip(a["finals"][0], f):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cross", ["0", "1"])
def test_a_save_and_restore_continues_bit_for_bit(cross, tmp_path):
    ck = str(tmp_path / "ck")
    ref = _rig([(6, None)], f"ckref{cross}", cross=cross)
    saved = _rig([(3, None)], f"cksave{cross}", cross=cross, save=ck)
    # the restore leaves the optimizer alone until the first step: record
    # what the trainers' optimizers hold just after it
    from byteps_tpu_torch.training import DistributedTrainer
    seen = []
    orig = DistributedTrainer.restore_sharded

    def spy(self, path):
        meta = orig(self, path)
        seen.append((len(self._tx.state), self.step_count))
        return meta

    DistributedTrainer.restore_sharded = spy
    try:
        got = _rig([(3, None)], f"ckrest{cross}", cross=cross, restore=ck,
                   start=3, fresh=True)
    finally:
        DistributedTrainer.restore_sharded = orig
    assert seen == [(0, 3), (0, 3)]
    assert all(m["step"] == 3 for m in got["metas"])
    _same_finals(ref, got)
    assert got["owned"] == saved["owned"]
    assert got["with_state"] == got["owned"]
    assert sorted(os.listdir(f"{ck}/opt_shard/s3")) == \
        [f"g{gi}.bin" for gi in range(len(saved["owner"][0]))]


def _plans():
    import test_torch_sharded_update as tsu
    tree, partition = tsu._trees()["leaves"]
    (jk, jg, jm), (pk, pg, pm) = tsu._both_plans(tree, partition)
    return tree, (jk, jg, jm), (pk, pg, pm)


def _both_saves(tmp_path, owner_map, epoch=2, step=3):
    """The JAX saver and the port's on the same plan and the same owned
    groups' Adam states (each framework's own, 2 steps on the same
    gradients), through stand-in trainers; returns the two directories and
    the port's ChunkedApply."""
    tree, (jk, jg, jm), (pk, pg, pm) = _plans()
    jplan = jsu.ShardedUpdatePlan(jk, jg, jm, 0, 2).with_owner_map(owner_map)
    pplan = psu.ShardedUpdatePlan(pk, pg, pm, 0, 2).with_owner_map(owner_map)
    names = sorted(tree)
    rng = np.random.RandomState(3)
    grads = [[rng.randn(*tree[n].shape).astype(np.float32) for n in names]
             for _ in range(2)]
    # JAX: optax.adam per group on the flat leaves
    tx = optax.adam(1e-3)
    jstates = []
    for g in jg:
        ps = [jnp.asarray(tree[names[li]]) for li in g]
        s = tx.init(ps)
        for step_g in grads:
            upd, s = tx.update([jnp.asarray(step_g[li]) for li in g], s, ps)
            ps = optax.apply_updates(ps, upd)
        jstates.append(s)
    jtrainer = types.SimpleNamespace(
        _sharded=types.SimpleNamespace(plan=jplan, member_epoch=epoch,
                                       name="meta"),
        _chunked=types.SimpleNamespace(decomposable=True, states=jstates),
        params={n: jnp.asarray(tree[n]) for n in names}, step_count=step)
    jdir = str(tmp_path / "jax")
    jckpt.save_sharded_checkpoint(jdir, jtrainer)
    # the port: torch.optim.Adam stepped per group on the same gradients
    model = torch.nn.ParameterDict({n: torch.nn.Parameter(
        torch.from_numpy(tree[n].copy())) for n in names})
    params = [model[n] for n in names]
    ca = ChunkedApply(torch.optim.Adam(params, lr=1e-3), params, pg)
    for step_g in grads:
        for gi, g in enumerate(pg):
            ca.apply_group(gi, [torch.from_numpy(step_g[li]) for li in g],
                           ca.hyper())
    ptrainer = types.SimpleNamespace(
        _sharded=types.SimpleNamespace(plan=pplan, member_epoch=epoch,
                                       name="meta"),
        _chunked=ca, _model=model, step_count=step, drain=lambda: None)
    pdir = str(tmp_path / "port")
    ckpt.save_sharded_checkpoint(pdir, ptrainer)
    return jdir, pdir, ca, jstates, pg


def test_the_meta_is_the_jax_meta(tmp_path):
    owner = [gi % 2 for gi in range(len(_plans()[2][1]))]
    jdir, pdir, _, _, _ = _both_saves(tmp_path, owner)
    with open(f"{jdir}/bps_meta.json") as f:
        jmeta = json.load(f)
    with open(f"{pdir}/bps_meta.json") as f:
        pmeta = json.load(f)
    assert pmeta == jmeta
    assert list(pmeta) == list(jmeta)
    assert list(pmeta["sharded"]) == list(jmeta["sharded"])
    assert pmeta["sharded"]["member_epoch"] == 2
    # rank 0's owned slices, in the same files
    want = sorted(f"g{gi}.bin" for gi, o in enumerate(owner) if o == 0)
    for d in (jdir, pdir):
        assert sorted(os.listdir(f"{d}/opt_shard/s3")) == want


def test_a_slice_of_either_package_restores_into_the_other(tmp_path):
    n = len(_plans()[2][1])
    jdir, pdir, ca, jstates, groups = _both_saves(tmp_path, [0] * n)
    for gi in range(n):
        with open(f"{jdir}/opt_shard/s3/g{gi}.bin", "rb") as f:
            jslice = f.read()
        with open(f"{pdir}/opt_shard/s3/g{gi}.bin", "rb") as f:
            pslice = f.read()
        # the JAX slice into the port's group: the JAX arrays
        got = psu.unpack_opt_state(jslice, ca.init_group(gi))
        leaves = [np.asarray(x)
                  for x in jax.tree_util.tree_leaves(jstates[gi])]
        k = len(groups[gi])
        for j, s in enumerate(got.state):
            assert s["step"].item() == float(leaves[0]) == 2.0
            np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                          leaves[1 + j])
            np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                          leaves[1 + k + j])
        # the port's slice into the JAX group: the port's arrays
        back = jax.tree_util.tree_leaves(jsu.unpack_opt_state(
            pslice, optax.adam(1e-3).init(
                [jnp.zeros(ca.params[li].shape) for li in groups[gi]])))
        st = ca.group_state(gi).state
        want = ([np.int32(2)] + [s["exp_avg"].numpy() for s in st]
                + [s["exp_avg_sq"].numpy() for s in st])
        for a, b in zip(back, want):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_a_save_after_a_reshard_restores_its_owner_map(tmp_path):
    ck = str(tmp_path / "ck")
    ref = _rig([(2, None), (1, frozenset({0})), (2, None)], "rmref")
    saved = _rig([(2, None), (1, frozenset({0}))], "rmsave", save=ck)
    with open(f"{ck}/bps_meta.json") as f:
        meta = json.load(f)
    assert meta["step"] == 3
    assert meta["sharded"]["member_epoch"] == 2
    assert meta["sharded"]["live"] == [0]
    assert meta["sharded"]["owner"] == saved["owner"][0] == \
        [0] * len(saved["owner"][0])
    got = _rig([(2, None)], "rmrest", restore=ck, start=3, fresh=True)
    assert got["owner"] == [meta["sharded"]["owner"]] * 2
    assert got["member_epoch"] == [2, 2]
    assert got["owned"][1] == set() and got["state_bytes"][1] == 0
    assert got["with_state"] == got["owned"]
    _same_finals(ref, got)


def test_the_refusals(tmp_path):
    ck = str(tmp_path / "ck")
    _rig([(1, None)], "refsave", save=ck)
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        ckpt.save_sharded_checkpoint(ck, None, embed=object())
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        ckpt.restore_sharded_checkpoint(ck, {}, embed=object())
    with pytest.raises(RuntimeError, match="engaged sharded update"):
        ckpt.save_sharded_checkpoint(ck, types.SimpleNamespace())
    full = str(tmp_path / "full")
    ckpt.save_checkpoint(full, {"w": torch.zeros(2)}, step=1)
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        ckpt.restore_sharded_checkpoint(full, {"w": torch.zeros(2)})
    # a restore after the first step
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.training import DistributedTrainer
    with h.env(BPS_ENABLE_PS=1):
        bps.init(device="cpu")
        try:
            m = h.Chain(P0)
            tr = DistributedTrainer(h.chain_loss, m, h.adam(m.parameters()),
                                    device="cpu", name="refrest")
            tr.step(WB[0][0])
            with pytest.raises(RuntimeError, match="before the first step"):
                tr.restore_sharded(ck)
            tr.close()
        finally:
            bps.shutdown()


def test_a_missing_slice_warns(tmp_path):
    ck = str(tmp_path / "ck")
    saved = _rig([(2, None)], "missave", save=ck)
    gone = min(saved["owned"][1])
    os.remove(f"{ck}/opt_shard/s2/g{gone}.bin")
    lines = _Lines()
    get_logger().addHandler(lines)
    try:
        got = _rig([(1, None)], "misrest", restore=ck, start=2)
    finally:
        get_logger().removeHandler(lines)
    warned = [m for m in lines.lines if "no slice for owned group" in m]
    assert len(warned) == 1 and f"[{gone}]" in warned[0], lines.lines
    assert got["with_state"] == got["owned"]


def test_an_interrupted_resave_leaves_the_committed_checkpoint(tmp_path,
                                                               monkeypatch):
    """A re-save to the same path cut short at worker 0's parameters: its
    slices landed in their own step directory, but the committed meta
    (step 2), its ``state.pt`` and its slices are read back as they were,
    and a restore continues bit for bit."""
    ck = str(tmp_path / "ck")
    _rig([(2, None)], "irsave", save=ck)
    with open(f"{ck}/bps_meta.json") as f:
        before = f.read()

    def cut(*a, **k):
        raise OSError("disk gone")

    real_save = torch.save
    monkeypatch.setattr(torch, "save", cut)
    with pytest.raises(OSError, match="disk gone"):
        _rig([(4, None)], "irresave", save=ck)
    monkeypatch.setattr(torch, "save", real_save)
    with open(f"{ck}/bps_meta.json") as f:
        assert f.read() == before
    assert os.path.isdir(f"{ck}/opt_shard/s4")        # the cut save's
    params, blobs, step, meta = ckpt.restore_sharded_checkpoint(
        ck, h.Chain(ZERO).state_dict())
    assert step == 2 and len(blobs) == len(meta["sharded"]["owner"])
    np.testing.assert_array_equal(params["w0"].numpy(),
                                  _rig([(2, None)], "irref")["finals"][0][0])
    ref = _rig([(4, None)], "irref4")
    got = _rig([(2, None)], "irrest", restore=ck, start=2, fresh=True)
    _same_finals(ref, got)
