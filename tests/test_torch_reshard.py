"""The sharded update's live membership change in the port
(``byteps_tpu_torch/sharded_update.py``: ``reshard``, ``pack_opt_state`` /
``unpack_opt_state``, ``live_group_weights``; ``optim.ChunkedApply``'s
``init_group``, ``adopt_group``, ``release_group``, ``set_owned``;
``DistributedTrainer.reshard``) against the JAX package's, on the CPU.

  - Frames: an Adam or AdamW group's frame holds the JAX package's arrays
    (count, mu, nu), so a port frame unpacks in the JAX package against an
    ``optax`` template and a JAX frame in the port, to the same arrays; a
    frame of another plan raises the same ``ValueError`` in both. Other
    optimizers take the port's own layout, which round-trips bit for bit.
  - ``live_group_weights`` is the JAX function on the same counters.
  - A crashed owner (the JAX package's
    ``test_reshard_crashed_owner_falls_back_loud``): the gaining rank logs
    the warning and restarts the group from ``init_group``, which steps
    bit for bit as a fresh optimizer.
  - LEAVE and JOIN (the JAX package's ``_phased_rig``): dp 2 over a port
    server, phases [(3, all), (3, {0}), (2, {0, 1})], bit for bit the
    uninterrupted 8 steps on both replicas, on both routes, and within
    ``test_torch_sharded_update_jax.py``'s tolerance of the JAX rig.
"""

import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu import sharded_update as jsu
from byteps_tpu.obs import metrics as jmetrics
from byteps_tpu_torch import sharded_update as psu
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.obs import flight
from byteps_tpu_torch.obs import metrics as pmetrics
from byteps_tpu_torch.optim import ChunkedApply
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import ps_mode as pps

import _torch_sharded as h

# test_torch_sharded_update_jax.py's tolerance against the JAX trainer
PARAM_ATOL = 1e-5
SHAPES = [(4, 3), (5,), (7,), (2, 2)]
GROUPS = [[0, 1], [2, 3]]


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


OPTS = {
    "adam": (lambda ps: torch.optim.Adam(ps, lr=1e-2),
             lambda: optax.adam(1e-2)),
    "adamw": (lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4),
              lambda: optax.adamw(1e-2, weight_decay=1e-4)),
}
PORT_LAYOUT = {
    "sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    "adagrad": lambda ps: torch.optim.Adagrad(ps, lr=0.1),
    "adam_amsgrad": lambda ps: torch.optim.Adam(ps, lr=1e-2, amsgrad=True),
}


def _arrays(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(dtype) for s in SHAPES]


def _grads(seed, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in _arrays(seed)]


def _chunked(make_opt, steps=2, dtype=torch.float32):
    """A ChunkedApply over four leaves in two groups, every group stepped
    ``steps`` times on seeded gradients."""
    params = [torch.nn.Parameter(torch.from_numpy(a).to(dtype))
              for a in _arrays()]
    ca = ChunkedApply(make_opt(params), params, GROUPS)
    assert ca.decomposable
    for s in range(steps):
        g = _grads(10 + s, dtype)
        for gi, grp in enumerate(GROUPS):
            ca.apply_group(gi, [g[li] for li in grp], ca.hyper())
    return ca


def _same_state(a, b):
    """Two GroupStates hold the same tensors bit for bit, with the same
    dtypes and devices."""
    assert len(a.state) == len(b.state)
    for x, y in zip(a.state, b.state):
        assert list(x) == list(y)
        for k in x:
            if not torch.is_tensor(x[k]):
                assert x[k] == y[k]
                continue
            assert x[k].dtype == y[k].dtype and x[k].device == y[k].device
            assert torch.equal(x[k], y[k]), k


# -- frames -------------------------------------------------------------------

@pytest.mark.parametrize("opt", sorted(OPTS))
def test_a_port_adam_frame_unpacks_in_jax(opt):
    ca = _chunked(OPTS[opt][0])
    for gi, grp in enumerate(GROUPS):
        frame = psu.pack_opt_state(ca.group_state(gi))
        template = OPTS[opt][1]().init([jnp.zeros(SHAPES[li])
                                        for li in grp])
        leaves = jax.tree_util.tree_leaves(jsu.unpack_opt_state(frame,
                                                                template))
        st = ca.group_state(gi).state
        want = ([np.int32(2)] + [s["exp_avg"].numpy() for s in st]
                + [s["exp_avg_sq"].numpy() for s in st])
        assert len(leaves) == len(want)
        assert np.asarray(leaves[0]).dtype == np.int32
        for a, b in zip(leaves, want):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_a_jax_adam_frame_unpacks_in_the_port(opt):
    tx = OPTS[opt][1]()
    ca = _chunked(OPTS[opt][0], steps=0)
    for gi, grp in enumerate(GROUPS):
        ps = [jnp.asarray(_arrays()[li]) for li in grp]
        state = tx.init(ps)
        for s in range(3):
            g = [jnp.asarray(_arrays(10 + s)[li]) for li in grp]
            upd, state = tx.update(g, state, ps)
            ps = optax.apply_updates(ps, upd)
        frame = jsu.pack_opt_state(state)
        got = psu.unpack_opt_state(frame, ca.init_group(gi))
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
        n = len(grp)
        fresh = ca.init_group(gi).state
        for j, s in enumerate(got.state):
            assert s["step"].item() == 3.0 == leaves[0]
            assert s["step"].dtype == fresh[j]["step"].dtype
            assert s["step"].device == fresh[j]["step"].device
            np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                          leaves[1 + j])
            np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                          leaves[1 + n + j])
        # the port's frame of the unpacked state holds the same arrays
        back = np.load(io.BytesIO(psu.pack_opt_state(got)))
        for i, a in enumerate(leaves):
            np.testing.assert_array_equal(back[f"a{i}"], a)


@pytest.mark.parametrize("case", ["leaf_count", "shape"])
def test_a_frame_of_another_plan_raises_alike_in_both(case):
    params = [torch.nn.Parameter(torch.from_numpy(a)) for a in _arrays()]
    groups = [[0, 1, 2], [3]] if case == "leaf_count" else GROUPS
    ca = ChunkedApply(OPTS["adam"][0](params), params, groups)
    frame = psu.pack_opt_state(ca.init_group(0))
    other = groups[1]
    with pytest.raises(ValueError) as pe:
        psu.unpack_opt_state(frame, ca.init_group(1))
    with pytest.raises(ValueError) as je:
        jsu.unpack_opt_state(frame, optax.adam(1e-2).init(
            [jnp.zeros(SHAPES[li]) for li in other]))
    assert str(pe.value) == str(je.value)
    assert ("leaves" if case == "leaf_count" else "leaf 1 is") \
        in str(pe.value)


@pytest.mark.parametrize("opt", sorted(PORT_LAYOUT))
def test_other_optimizers_round_trip_in_the_port_layout(opt):
    """The port's own layout: an unpacked state is the packed one bit for
    bit, and the group then steps as the original does."""
    a, b = _chunked(PORT_LAYOUT[opt]), _chunked(PORT_LAYOUT[opt], steps=0)
    for gi in range(len(GROUPS)):
        frame = psu.pack_opt_state(a.group_state(gi))
        assert "keys" in np.load(io.BytesIO(frame)).files
        got = psu.unpack_opt_state(frame, b.init_group(gi))
        _same_state(got, a.group_state(gi))
        b.adopt_group(gi, got)
    with torch.no_grad():
        for pa, pb in zip(a.params, b.params):
            pb.copy_(pa)
    g = _grads(20)
    for ca in (a, b):
        for gi, grp in enumerate(GROUPS):
            ca.apply_group(gi, [g[li].clone() for li in grp], ca.hyper())
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)
    for gi in range(len(GROUPS)):
        _same_state(a.group_state(gi), b.group_state(gi))


def test_a_frame_of_another_optimizer_raises():
    adam, sgd = _chunked(OPTS["adam"][0]), _chunked(PORT_LAYOUT["sgd_momentum"])
    with pytest.raises(ValueError, match="optimizer recipes"):
        psu.unpack_opt_state(psu.pack_opt_state(adam.group_state(0)),
                             sgd.init_group(0))
    with pytest.raises(ValueError, match="optimizer recipes"):
        psu.unpack_opt_state(psu.pack_opt_state(sgd.group_state(0)),
                             adam.init_group(0))
    with pytest.raises(ValueError, match="leaf 0 is"):
        psu.unpack_opt_state(psu.pack_opt_state(sgd.group_state(0)),
                             sgd.group_state(1))
    ag = _chunked(PORT_LAYOUT["adagrad"])       # two tensors a parameter
    with pytest.raises(ValueError, match="has 2 leaves, template expects 4"):
        psu.unpack_opt_state(psu.pack_opt_state(sgd.group_state(0)),
                             ag.group_state(0))


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_init_group_is_the_state_torch_makes(opt):
    """``init_group`` is what torch's lazy init makes (dtypes, devices,
    shapes, zeros), and a group adopting it steps bit for bit as one
    that never had state."""
    fresh = _chunked(OPTS[opt][0], steps=0)
    tmpl = [fresh.init_group(gi) for gi in range(len(GROUPS))]
    lazy = _chunked(OPTS[opt][0], steps=1)     # torch made its state
    for gi, t in enumerate(tmpl):
        assert t.adam
        for x, y in zip(t.state, lazy.group_state(gi).state):
            assert list(x) == list(y)
            for k in x:
                assert (x[k].dtype, x[k].device, x[k].shape) == \
                    (y[k].dtype, y[k].device, y[k].shape)
                assert not x[k].any()
    adopted = _chunked(OPTS[opt][0], steps=0)
    for gi, t in enumerate(tmpl):
        adopted.adopt_group(gi, t)
    assert adopted.groups_with_state() == [0, 1]
    g = _grads(10)
    for gi, grp in enumerate(GROUPS):
        adopted.apply_group(gi, [g[li] for li in grp], adopted.hyper())
    for pa, pb in zip(adopted.params, lazy.params):
        assert torch.equal(pa, pb)
    for gi in range(len(GROUPS)):
        _same_state(adopted.group_state(gi), lazy.group_state(gi))


def test_bfloat16_state_round_trips():
    ca = _chunked(OPTS["adamw"][0], dtype=torch.bfloat16)
    for gi in range(len(GROUPS)):
        got = psu.unpack_opt_state(psu.pack_opt_state(ca.group_state(gi)),
                                   ca.init_group(gi))
        assert got.state[0]["exp_avg"].dtype == torch.bfloat16
        _same_state(got, ca.group_state(gi))


def test_release_group_frees_the_state_and_set_owned_gates_the_apply():
    ca = _chunked(OPTS["adam"][0])
    assert ca.groups_with_state() == [0, 1]
    ca.release_group(1)
    assert ca.groups_with_state() == [0] and ca.states[1] is None
    assert not any(ca.opt.state.get(ca.params[li]) for li in GROUPS[1])
    ca.set_owned({0})
    with pytest.raises(RuntimeError, match="non-owned group"):
        ca.apply_group(1, _grads(3)[2:], ca.hyper())
    ca.set_owned({0, 1})
    ca.apply_group(1, _grads(3)[2:], ca.hyper())
    assert ca.groups_with_state() == [0, 1]


# -- weights ------------------------------------------------------------------

def test_counters_with_prefix_is_the_jax_registrys():
    regs = (pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("ps/push_bytes/a.0").inc(5)
        reg.counter("ps/push_bytes/a.1").inc(7)
        reg.counter("ps/pull_bytes/a.0").inc(3)
        reg.gauge("ps/push_bytes/gauge").set(1.0)
    for pre in (("ps/push_bytes/",), ("ps/push_bytes/", "ps/pull_bytes/"),
                ("nothing/",)):
        assert regs[0].counters_with_prefix(pre) == \
            regs[1].counters_with_prefix(pre)


@pytest.mark.parametrize("tree", ["leaves", "bert_tiny"])
def test_live_group_weights_are_the_jax_ones(tree):
    import test_torch_sharded_update as tsu
    (jk, jg, jm), (pk, pg, pm) = tsu._both_plans(*tsu._trees()[tree])
    p = psu.ShardedUpdatePlan(pk, pg, pm, 0, 2)
    j = jsu.ShardedUpdatePlan(jk, jg, jm, 0, 2)
    preg, jreg = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    assert psu.live_group_weights(p, "w", registry=preg) is None
    assert jsu.live_group_weights(j, "w", registry=jreg) is None
    rng = np.random.RandomState(1)
    for bi, label in enumerate(p.bucket_labels):
        if bi % 3 == 2:
            continue                  # a bucket without traffic
        n = int(rng.randint(1, 1 << 20))
        for reg in (preg, jreg):
            reg.counter(f"ps/push_bytes/w.{label}").inc(n)
    got = psu.live_group_weights(p, "w", registry=preg)
    assert got == jsu.live_group_weights(j, "w", registry=jreg)
    assert len(got) == len(pg) and min(got) >= 1 and max(got) == 64
    assert p.reshard([0, 1], weights=got).owner == \
        j.reshard([0, 1], weights=got).owner


# -- a crashed owner ----------------------------------------------------------

def test_a_crashed_owner_restarts_its_groups_from_init():
    rng = np.random.RandomState(1)
    params = [(f"k{i}", torch.nn.Parameter(torch.from_numpy(
        rng.randn(3000 + 64 * i).astype(np.float32)))) for i in range(5)]
    be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                               engine_threads=1)
    ex = pps.PSGradientExchange(be, partition_bytes=4 << 10)
    lines = _Lines()
    get_logger().addHandler(lines)
    try:
        opt = OPTS["adam"][0]([p for _, p in params])
        st = psu.build_sharded_state(ex, params, opt, "crash", 0, 2)
        assert st is not None
        plan = st.plan
        victims = [gi for gi, o in enumerate(plan.owner) if o == 1]
        assert victims, "rank 1 owned nothing"
        ca = ChunkedApply(opt, [p for _, p in params], plan.groups,
                          owned=plan.owned_set)
        out = st.reshard(ca, {0}, handoff_timeout_ms=200)
        assert out["member_epoch"] == 2 == st.member_epoch
        assert set(out["gained"]) == set(victims) and out["lost"] == ()
        assert any("never published" in m for m in lines.lines), lines.lines
        assert ca.owned == frozenset(range(len(plan.groups)))
        assert set(ca.groups_with_state()) == set(victims)
        # the restarted groups step as a fresh optimizer does
        ref = [torch.nn.Parameter(p.detach().clone()) for _, p in params]
        fresh = OPTS["adam"][0](ref)
        g = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
             for _, p in params]
        for gi in victims:
            ca.apply_group(gi, [g[li] for li in plan.groups[gi]], ca.hyper())
        for li in (li for gi in victims for li in plan.groups[gi]):
            ref[li].grad = g[li]
        fresh.step()
        for gi in victims:
            for li in plan.groups[gi]:
                assert torch.equal(params[li][1], ref[li])
                for k, v in opt.state[params[li][1]].items():
                    assert torch.equal(v, fresh.state[ref[li]][k])
        st.close()
    finally:
        get_logger().removeHandler(lines)
        ex.close()
        be.close()


def test_the_round_view_and_the_watchdog_names_follow_a_leave():
    """Both ranks reshard to {0} at once over one in-process server: the
    leaver's next round pulls no bucket and names rank 0 as every skipped
    bucket's owner (the watchdog's ``await_param``), rank 0's pulls them
    all; the leaver's state went to rank 0, bit for bit."""
    import threading
    be = pengine.HostPSBackend(num_servers=1, num_workers=2,
                               engine_threads=1)
    exs = [pps.PSGradientExchange(be, partition_bytes=4 << 10)
           for _ in range(2)]
    try:
        sts, cas = [], []
        for r in range(2):
            params = [(f"k{i}", torch.nn.Parameter(torch.from_numpy(
                np.random.RandomState(i).randn(3000).astype(np.float32))))
                for i in range(4)]
            opt = OPTS["adamw"][0]([p for _, p in params])
            st = psu.build_sharded_state(exs[r], params, opt, "view", r, 2)
            ca = ChunkedApply(opt, [p for _, p in params], st.plan.groups,
                              owned=st.plan.owned_set)
            g = [torch.from_numpy(np.random.RandomState(9 + li).randn(
                3000).astype(np.float32)) for li in range(4)]
            for gi in st.plan.owned:
                ca.apply_group(gi, [g[li] for li in st.plan.groups[gi]],
                               ca.hyper())
            sts.append(st)
            cas.append(ca)
        lost = list(sts[1].plan.owned)
        assert lost, "rank 1 owned nothing"
        sent = {gi: cas[1].group_state(gi) for gi in lost}
        outs = [None, None]

        def rs(r):
            outs[r] = sts[r].reshard(cas[r], {0}, handoff_timeout_ms=5000)
        ts = [threading.Thread(target=rs, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(h.WAIT)
        assert not any(t.is_alive() for t in ts) and None not in outs
        n = len(sts[0].plan.groups)
        v1, v0 = sts[1].plan.round_view(), sts[0].plan.round_view()
        assert v1.pull_buckets == frozenset() and not v1.stream_leaves
        assert set(v1.skip_owner.values()) == {(0,)}
        assert len(v1.skip_owner) == len(sts[1].plan.bucket_labels)
        assert v0.skip_owner == {} and len(v0.pull_buckets) == \
            len(sts[0].plan.bucket_labels)
        assert cas[1].groups_with_state() == [] and cas[1].owned == set()
        assert cas[0].groups_with_state() == list(range(n))
        for gi, want in sent.items():
            _same_state(cas[0].group_state(gi), want)
        for st in sts:
            st.close()
    finally:
        for ex in exs:
            ex.close()
        be.close()


def test_reshard_refusals_and_the_unchanged_membership():
    params = [(f"k{i}", torch.nn.Parameter(torch.zeros(3000)))
              for i in range(4)]
    be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                               engine_threads=1)
    ex = pps.PSGradientExchange(be, partition_bytes=4 << 10)
    try:
        opt = OPTS["adam"][0]([p for _, p in params])
        st = psu.build_sharded_state(ex, params, opt, "refuse", 0, 2)
        with pytest.raises(RuntimeError, match="engaged chunked"):
            st.reshard(None, {0})
        assert st.reshard(None, {0, 1}) == {
            "member_epoch": 1, "gained": (), "lost": (), "live": [0, 1]}
        st.close()
    finally:
        ex.close()
        be.close()


# -- LEAVE and JOIN -----------------------------------------------------------

def _chain():
    p0 = h.chain_params(depth=3, dim=64)
    wb = [h.chain_batches(64, 10 + w, 8, bs=16) for w in range(2)]
    return p0, wb


PHASES = [(3, None), (3, frozenset({0})), (2, frozenset({0, 1}))]


@pytest.mark.parametrize("cross", ["0", "1"])
def test_leave_and_join_are_the_uninterrupted_run(cross):
    p0, wb = _chain()
    flight.get_recorder().clear()
    ref = h.run_phased(lambda: h.Chain(p0), h.chain_loss, wb, [(8, None)],
                       name=f"rsref{cross}", cross=cross)
    got = h.run_phased(lambda: h.Chain(p0), h.chain_loss, wb, PHASES,
                       name=f"rsgot{cross}", cross=cross)
    for f in (got["finals"][1], ref["finals"][0]):
        for a, b in zip(got["finals"][0], f):
            np.testing.assert_array_equal(a, b)
    leave, join = got["reshards"]
    assert [r["member_epoch"] for r in leave + join] == [2, 2, 3, 3]
    assert leave[1]["gained"] == () and leave[0]["lost"] == ()
    assert set(leave[0]["gained"]) == set(leave[1]["lost"]) != set()
    assert set(join[0]["lost"]) == set(join[1]["gained"]) != set()
    # the 1/dp memory holds through the changes: state for the owned
    # groups only
    assert got["with_state"] == got["owned"]
    assert got["member_epoch"] == [3, 3]
    assert sum(got["state_bytes"]) == sum(ref["state_bytes"])
    kinds = {e["kind"] for e in flight.get_recorder().events(keys=[12345])}
    assert {"reshard", "member_leave", "member_join",
            "state_put"} <= kinds, kinds


def test_leave_and_join_against_the_jax_rig():
    import test_sharded_update as ref
    p0, wb = _chain()
    got = h.run_phased(lambda: h.Chain(p0), h.chain_loss, wb, PHASES,
                       name="rsport", cross="1")
    with h.env(BPS_BWD_STAGED=0):
        jx = ref._phased_rig(PHASES, dict(p0), wb, "rsjax")
    for a, b in zip(jx[0], jx[1]):
        np.testing.assert_array_equal(a, b)
    assert len(jx[0]) == len(got["finals"][0])
    for a, b in zip(got["finals"][0], jx[0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_trainer_reshard_before_the_sharded_update_raises():
    p0, wb = _chain()
    with h.env(BPS_ENABLE_PS=1, BPS_SHARDED_UPDATE=1):
        import byteps_tpu_torch as bps
        from byteps_tpu_torch.training import DistributedTrainer
        bps.init(device="cpu")
        try:
            m = h.Chain(p0)
            tr = DistributedTrainer(h.chain_loss, m, h.adam(m.parameters()),
                                    device="cpu", name="rsnone")
            with pytest.raises(RuntimeError, match="engaged sharded"):
                tr.reshard([0])
            tr.close()
        finally:
            bps.shutdown()
