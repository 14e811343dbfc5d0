"""The port's sharded weight update (``byteps_tpu_torch/sharded_update.py``)
against the JAX package's (``byteps_tpu/sharded_update.py``) on the CPU.

  - The ownership plan: on the same bucket plan the port's owner map, its
    pull and skip sets, fetch order and param keys are the JAX plan's, at
    world 2, 3 and 4, for three trees; ``reshard`` and ``with_owner_map``
    too; the ring under it hashes alike (``server/plane/placement.py``).
  - Param frames: ``pack_group`` writes the JAX bytes and ``unpack_group``
    reads them; the mailbox keeps its contract (last-wins, reads that do
    not consume, retention, a loud timeout) in process and over the wire,
    in the four {port, JAX} client x server pairings, the frames of ops
    21, 22 and 24 byte for byte; a PUT frame rides the wire credit's
    latency class.
  - Training: ``dp`` port trainers in threads over one port server, each
    with its own connection pool. Sharded against unsharded: bit for bit
    at dp 2 (a sum of two arrivals is the same in either order) and
    within the JAX test's rtol 1e-4 / atol 1e-6 at dp 4 (the server adds
    four arrivals in arrival order); the replicas of an arm end bit for
    bit equal; a replica's gradient pulls drop to about 1/dp; optimizer
    state exists for the owned groups only. The cross-step route with
    two rounds in flight and int8 with error feedback are bit for bit the
    unsharded run's (a missed residual commit on a non-owner would change
    its next push, and so the sum).
  - Each fallback keeps the full update with the JAX package's INFO line;
    an owner that dies before it publishes raises the loud per-key
    diagnostic, and the watchdog names it while the fetch waits.

The trainers against the JAX trainer are in
``test_torch_sharded_update_jax.py``.
"""

import logging
import os
import re
import socket
import struct
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from byteps_tpu import sharded_update as jsu
from byteps_tpu.common.logging import get_logger as jlog
from byteps_tpu.models import bert as jbert
from byteps_tpu.models import transformer as jtr
from byteps_tpu.server import engine as jengine
from byteps_tpu.server import ps_mode as jps
from byteps_tpu.server import transport as jtransport
from byteps_tpu.server.plane import placement as jplace
from byteps_tpu_torch import sharded_update as psu
from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.common.naming import NameRegistry
from byteps_tpu_torch.obs.watchdog import StallWatchdog, format_dump
from byteps_tpu_torch.optim import ChunkedApply
from byteps_tpu_torch.server import admission
from byteps_tpu_torch.server import engine as pengine
from byteps_tpu_torch.server import ps_mode as pps
from byteps_tpu_torch.server import transport as ptransport
from byteps_tpu_torch.server.plane import placement as pplace

import _torch_sharded as h

_ENGINE = {"port": pengine, "jax": jengine}
_TRANSPORT = {"port": ptransport, "jax": jtransport}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax")]
pairs = pytest.mark.parametrize("client,server", PAIRS,
                                ids=[f"{c}-client-{s}-server"
                                     for c, s in PAIRS])


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


@pytest.fixture
def port_log():
    lines = _Lines()
    get_logger().addHandler(lines)
    yield lines.lines
    get_logger().removeHandler(lines)


# -- the plan ----------------------------------------------------------------

def _trees():
    rng = np.random.RandomState(0)
    leaves = {f"k{i}": rng.randn(3000 + 64 * i).astype(np.float32)
              for i in range(5)}
    jp = jtr.init_params(jax.random.PRNGKey(0), jbert.bert_tiny())
    bert = {f"{i:03d}": np.asarray(a)
            for i, a in enumerate(jax.tree_util.tree_leaves(jp))}
    return {"leaves": (leaves, 4 << 10), "bert_tiny": (bert, 64 << 10),
            "chain": (h.chain_params(), 96 * 96 * 4)}


def _both_plans(tree, partition):
    """The bucket plan of ``tree`` (a dict, flattened in key order) by the
    JAX exchange and by the port's: (jax keyed, groups, meta), (port ...)."""
    jbe = jengine.HostPSBackend(num_servers=1, num_workers=1,
                                engine_threads=1)
    jex = jps.PSGradientExchange(jbe, partition_bytes=partition)
    _, _, jkeyed = jex._plan(tree, "plan")
    jgroups = jex.leaf_groups(tree, name="plan")
    jmeta = jsu.ShardedUpdatePlan.leaf_meta_of(tree)
    pbe = pengine.HostPSBackend(num_servers=1, num_workers=1,
                                engine_threads=1)
    pex = pps.PSGradientExchange(pbe, partition_bytes=partition)
    pairs_ = [(k, torch.from_numpy(np.array(v)))
              for k, v in sorted(tree.items())]
    _, pkeyed = pex._plan(pairs_, "plan")
    pgroups = pex.leaf_groups(pairs_, name="plan")
    pmeta = psu.ShardedUpdatePlan.leaf_meta_of(pairs_)
    for x in (jex, pex, jbe, pbe):
        x.close()
    assert [k for k, _ in pkeyed] == [k for k, _ in jkeyed]
    assert pgroups == jgroups and pmeta == jmeta
    return (jkeyed, jgroups, jmeta), (pkeyed, pgroups, pmeta)


_PLAN_FIELDS = ("owner", "load", "owned", "needed", "group_bytes",
                "group_bucket", "pull_buckets", "stream_leaves",
                "skip_groups", "skip_owner", "fetch_order", "param_keys",
                "state_keys", "live", "weights", "bucket_labels")


def _same_plan(p, j):
    for f in _PLAN_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    assert p.balance_ratio() == j.balance_ratio()
    assert p.round_view().pull_buckets == j.round_view().pull_buckets
    assert p.round_view().stream_leaves == j.round_view().stream_leaves
    assert p.round_view().skip_owner == j.round_view().skip_owner


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_hash_ring_is_the_jax_ring(shards):
    pr, jr = pplace.HashRing(shards), jplace.HashRing(shards)
    keys = [k << 16 | b for k in range(4) for b in range(40)] + [2 ** 60 + 5]
    for key in keys:
        assert pr.lookup(key) == jr.lookup(key)
        assert pr.successors(key, shards) == jr.successors(key, shards)
        assert pr.successors(key, 2, skip={0}) == \
            jr.successors(key, 2, skip={0})
    w = [1.0 + i for i in range(shards)]
    assert pplace.HashRing(shards, 8, w)._owners == \
        jplace.HashRing(shards, 8, w)._owners


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("tree", ["leaves", "bert_tiny", "chain"])
def test_plan_is_the_jax_plan(tree, world):
    (jk, jg, jm), (pk, pg, pm) = _both_plans(*_trees()[tree])
    owned = set()
    for r in range(world):
        p = psu.ShardedUpdatePlan(pk, pg, pm, r, world)
        j = jsu.ShardedUpdatePlan(jk, jg, jm, r, world)
        _same_plan(p, j)
        assert not owned & set(p.owned)
        owned |= set(p.owned)
        assert p.pull_buckets | set(p.skip_groups) == set(range(len(pk)))
    assert owned == set(range(len(pg)))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_reshard_and_owner_map_are_the_jax_ones(world):
    (jk, jg, jm), (pk, pg, pm) = _both_plans(*_trees()["bert_tiny"])
    p = psu.ShardedUpdatePlan(pk, pg, pm, 0, world)
    j = jsu.ShardedUpdatePlan(jk, jg, jm, 0, world)
    weights = [1 + (7 * gi) % 5 for gi in range(len(pg))]
    for live in ([0], list(range(1, world)), list(range(world))):
        _same_plan(p.reshard(live), j.reshard(live))
        _same_plan(p.reshard(live, weights=weights),
                   j.reshard(live, weights=weights))
        # a join after a leave levels the joiner up alike
        _same_plan(p.reshard(live).reshard(range(world)),
                   j.reshard(live).reshard(range(world)))
    owner_map = [gi % world for gi in range(len(pg))]
    _same_plan(p.with_owner_map(owner_map), j.with_owner_map(owner_map))
    for bad in (owner_map[:-1], [world] * len(pg)):
        with pytest.raises(ValueError) as pe:
            p.with_owner_map(bad)
        with pytest.raises(ValueError) as je:
            j.with_owner_map(bad)
        assert str(pe.value) == str(je.value)


def test_param_frames_are_the_jax_bytes():
    (jk, jg, jm), (pk, pg, pm) = _both_plans(*_trees()["bert_tiny"])
    p = psu.ShardedUpdatePlan(pk, pg, pm, 1, 2)
    j = jsu.ShardedUpdatePlan(jk, jg, jm, 1, 2)
    rng = np.random.RandomState(1)
    for gi in range(len(pg)):
        leaves = [rng.randn(*pm[li][0]).astype(pm[li][1]) for li in pg[gi]]
        frame = p.pack_group(gi, leaves)
        assert frame == j.pack_group(gi, leaves)
        for a, b, c in zip(leaves, p.unpack_group(gi, frame),
                           j.unpack_group(gi, frame)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)
        # a frame of the wrong size: different bucket plans, loudly
        with pytest.raises(ValueError, match="different bucket plans"):
            p.unpack_group(gi, frame + b"\0")
        with pytest.raises(ValueError, match="plan expects"):
            p.pack_group(gi, [a.astype(np.float64) for a in leaves])


def test_plan_refuses_what_the_jax_plan_refuses():
    (jk, jg, jm), (pk, pg, pm) = _both_plans(*_trees()["leaves"])
    for args, kw in (((0, 1), {}), ((2, 2), {}), ((0, 2), {"live": []}),
                     ((0, 2), {"weights": [1]})):
        with pytest.raises(ValueError) as pe:
            psu.ShardedUpdatePlan(pk, pg, pm, *args, **kw)
        with pytest.raises(ValueError) as je:
            jsu.ShardedUpdatePlan(jk, jg, jm, *args, **kw)
        assert str(pe.value) == str(je.value)


# -- the mailbox --------------------------------------------------------------

@pytest.mark.parametrize("store", ["ParamStore", "HostPSBackend"])
def test_param_mailbox_contract(store):
    """Last-wins per (key, seq), reads that leave the frame, ``retain``
    seqs a key, a loud timeout, a blocked read woken by the put."""
    be = None
    if store == "ParamStore":
        st = psu.ParamStore(retain=2)
        put, get, latest = st.put, st.get, st.latest
    else:
        be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                                   engine_threads=1)
        be.param_store().retain = 2
        put, get, latest = be.param_put, be.param_get, be.param_latest
    try:
        assert latest(7) == 0
        put(7, 1, b"one")
        assert get(7, 1, timeout_ms=100) == b"one"
        assert get(7, 1, timeout_ms=100) == b"one"
        put(7, 1, b"one")
        put(7, 2, b"two")
        put(7, 3, b"three")             # retain 2: seq 1 goes
        assert latest(7) == 3
        assert get(7, 2, timeout_ms=100) == b"two"
        with pytest.raises(TimeoutError, match="owner never published"):
            get(7, 1, timeout_ms=50)
        got = {}
        t = threading.Thread(target=lambda: got.update(
            v=get(9, 5, timeout_ms=5000)))
        t.start()
        time.sleep(0.05)
        put(9, 5, b"late")
        t.join(5)
        assert got.get("v") == b"late"
    finally:
        if be is not None:
            be.close()


class _Srv:
    def __init__(self, kind):
        self.engine = _ENGINE[kind].PSServer(num_workers=1, engine_threads=1)
        self.srv = _TRANSPORT[kind].PSTransportServer(
            self.engine, host="127.0.0.1", port=0)
        self.addr = f"127.0.0.1:{self.srv.port}"

    def close(self):
        self.srv.close()
        self.engine.close()


@pairs
def test_param_ops_in_every_pairing(client, server):
    """Ops 21 (PUT), 22 (GET) and 24 (SEQ) between either side's client and
    either side's server: a put read twice, a blocked get resolved by a
    later put, the newest seq, a timeout on a frame never published."""
    s = _Srv(server)
    cli = _TRANSPORT[client].RemotePSBackend([s.addr])
    try:
        key = psu.PARAM_KEY_BASE | (2 << 16) | 3
        payload = np.arange(5000, dtype=np.float32).tobytes()
        assert cli.param_latest(key) == 0
        cli.param_put(key, 1, payload)
        assert cli.param_get(key, 1, timeout_ms=2000) == payload
        assert cli.param_get(key, 1, timeout_ms=2000) == payload
        got = {}
        t = threading.Thread(target=lambda: got.update(
            v=cli.param_get(key, 2, timeout_ms=10000)))
        t.start()
        time.sleep(0.1)
        cli.param_put(key, 2, b"x" * 1000)
        t.join(10)
        assert got.get("v") == b"x" * 1000
        assert cli.param_latest(key) == 2
        with pytest.raises(TimeoutError):
            cli.param_get(key, 99, timeout_ms=300)
        # the connection still serves the mailbox
        assert cli.param_get(key, 2, timeout_ms=2000) == b"x" * 1000
    finally:
        cli.close()
        s.close()


class _Capture:
    """A server that records each request frame whole (but CLOSE) and
    answers with a canned reply by op, on every connection it accepts."""

    def __init__(self, replies):
        self.replies, self.frames = replies, []
        self.lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        with conn:
            while True:
                try:
                    hdr = ptransport._recv_exact(conn, ptransport._HDR.size)
                except ConnectionError:
                    return
                op, *_, plen, _ = ptransport._HDR.unpack(hdr)
                body = ptransport._recv_exact(conn, plen) if plen else b""
                if op != ptransport.OP_CLOSE:
                    with self.lock:
                        self.frames.append(bytes(hdr) + bytes(body))
                conn.sendall(self.replies[op])
                if op == ptransport.OP_CLOSE:
                    return

    def close(self):
        self.sock.close()


def test_param_frames_byte_for_byte():
    """The requests each client writes for ops 21, 22 and 24 are the same
    bytes, and either server answers a request with the same bytes."""
    key, frame = psu.PARAM_KEY_BASE | (1 << 16) | 2, bytes(range(256)) * 40
    rsp = ptransport._RSP
    replies = {ptransport.OP_PARAM_PUT: rsp.pack(0, 0),
               ptransport.OP_PARAM_GET: rsp.pack(0, len(frame)) + frame,
               ptransport.OP_PARAM_SEQ: rsp.pack(0, 8)
               + struct.pack("!Q", 7),
               ptransport.OP_CLOSE: rsp.pack(0, 0)}
    assert (ptransport.OP_PARAM_PUT, ptransport.OP_PARAM_GET,
            ptransport.OP_PARAM_SEQ) == (jtransport.OP_PARAM_PUT,
                                         jtransport.OP_PARAM_GET,
                                         jtransport.OP_PARAM_SEQ)
    written = {}
    for kind in ("port", "jax"):
        cap = _Capture(replies)
        cli = _TRANSPORT[kind].RemotePSBackend([cap.addr],
                                               conns_per_shard=1)
        got = {}

        def ops():
            cli.param_put(key, 3, frame)
            got["frame"] = cli.param_get(key, 3, timeout_ms=30000)
            got["seq"] = cli.param_latest(key)

        t = threading.Thread(target=ops, daemon=True)
        t.start()
        t.join(30)
        assert not t.is_alive(), f"the {kind} client hung"
        assert got == {"frame": frame, "seq": 7}
        cli.close()
        cap.close()
        written[kind] = cap.frames
    assert written["port"] == written["jax"]
    assert len(written["port"]) == 3
    answers = {}
    for kind in ("port", "jax"):
        s = _Srv(kind)
        conn = socket.create_connection(("127.0.0.1", s.srv.port))
        got = []
        for req in written["port"] + [
                ptransport._HDR.pack(ptransport.OP_PARAM_GET, key, 9, 0,
                                     50, 0, b"uint8".ljust(8, b"\0"))]:
            conn.sendall(req)
            st, n = rsp.unpack(ptransport._recv_exact(conn, rsp.size))
            got.append((st, bytes(ptransport._recv_exact(conn, n))
                        if n else b""))
        conn.close()
        s.close()
        answers[kind] = got
    assert answers["port"] == answers["jax"]
    assert answers["port"][1] == (ptransport.ST_OK, frame)
    assert answers["port"][3][0] == ptransport.ST_TIMEOUT


def test_param_put_rides_the_latency_class():
    """With a wire credit, a PUT frame is admitted in the latency class at
    its next-step first-use priority; a gradient push in the gradient
    class."""
    admission.configure_send(64 << 10)
    s = _Srv("port")
    cli = ptransport.RemotePSBackend([s.addr])
    try:
        key = psu.PARAM_KEY_BASE | 5
        cli.set_send_priority(key, 100)
        cli.param_put(key, 1, b"p" * (16 << 10))
        cli.init_key(3, 32 << 10)
        cli.push(3, np.ones(8 << 10, np.float32))
        tr = admission.send_scheduler().trace()
        assert [(e["class"], e["key"], e["prio"]) for e in tr] == \
            [("act", key, 100), ("grad", 3, 0)]
        assert s.srv.param_store().get(key, 1, timeout_ms=100) == \
            b"p" * (16 << 10)
    finally:
        admission.configure_send(0)
        cli.close()
        s.close()


# -- the chunked apply --------------------------------------------------------

def test_chunked_apply_keeps_state_for_owned_groups_only():
    torch.manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(5)) for _ in range(4)]
    opt = torch.optim.Adam(ps, lr=1e-2)
    ca = ChunkedApply(opt, ps, [[0, 1], [2], [3]], owned={0, 2})
    assert ca.decomposable
    hyper = ca.hyper()
    ca.apply_group(0, [torch.ones(5), torch.ones(5)], hyper)
    ca.apply_group(2, [torch.ones(5)], hyper)
    with pytest.raises(RuntimeError, match="non-owned group"):
        ca.apply_group(1, [torch.ones(5)], hyper)
    assert ca.groups_with_state() == [0, 2]
    assert set(opt.state) == {ps[0], ps[1], ps[3]}


# -- training: sharded against unsharded ------------------------------------

DIM = 96


def _chain_run(dp, sharded, steps, seed, **kw):
    p0 = h.chain_params(dim=DIM)
    batches = [h.chain_batches(DIM, seed + w, steps) for w in range(dp)]
    return h.run_port_arm(lambda: h.Chain(p0), h.chain_loss, batches,
                          dp=dp, sharded=sharded, steps=steps,
                          partition_bytes=DIM * DIM * 4, **kw)


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_against_unsharded(dp):
    finals, pulls = {}, {}
    for mode in ("1", "0"):
        f, losses, snap, owned = _chain_run(dp, mode, 4, 10,
                                            name=f"zx{dp}-{mode}")
        for other in f[1:]:             # replicas agree bit for bit
            for a, b in zip(f[0], other):
                np.testing.assert_array_equal(a, b)
        finals[mode], pulls[mode] = f[0], snap
        if mode == "1":
            # optimizer state for the owned groups only, and the owned
            # sets partition the groups
            union = set()
            for mine, with_state in owned:
                assert mine == with_state and not union & mine
                union |= mine
            assert union == set(range(4))
    for a, b in zip(finals["1"], finals["0"]):
        if dp == 2:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    full, shard = pulls["0"]["ps/pull_bytes"], pulls["1"]["ps/pull_bytes"]
    assert shard < full * (1.0 / dp + 0.2), (shard, full, dp)
    # every worker fetches what the others published, once a step
    nbytes = 4 * DIM * DIM * 4
    assert pulls["1"]["ps/param_put_bytes"] == 4 * nbytes
    assert pulls["1"]["ps/param_fetch_bytes"] == 4 * nbytes * (dp - 1)
    assert pulls["0"]["ps/param_put_bytes"] == 0
    per_layer = [k for k, v in pulls["1"].items()
                 if k.startswith("ps/pull_bytes/") and v]
    assert per_layer


def test_cross_step_two_rounds_in_flight_is_the_draining_run():
    """``BPS_CROSS_STEP=1`` with slowed pulls (two rounds in flight a key)
    is bit for bit the sharded draining run, the unsharded cross-step run
    and the sharded run without the staged head."""
    finals = {}
    for mode, cross, staged in (("1", "1", "1"), ("1", "0", "1"),
                                ("0", "1", "1"), ("1", "0", "0")):
        f, _, _, _ = _chain_run(
            2, mode, 5, 20, cross=cross, staged=staged,
            name=f"zc-{mode}{cross}{staged}",
            slow_pulls=0.04 if cross == "1" else 0.0)
        finals[(mode, cross, staged)] = f[0]
    ref = finals[("1", "1", "1")]
    for key, f in finals.items():
        for a, b in zip(ref, f):
            np.testing.assert_array_equal(a, b, err_msg=str(key))


@pytest.mark.parametrize("cross", ["0", "1"])
def test_int8_with_error_feedback_is_the_unsharded_run(cross):
    """int8 on the fused plane with error feedback, 3 steps: a non-owner
    commits a skipped bucket's residual when its frames land, so every
    push and sum is the unsharded run's."""
    finals = {}
    for mode in ("1", "0"):
        f, _, snap, _ = _chain_run(
            2, mode, 3, 30, cross=cross, codec="int8",
            name=f"ze-{mode}{cross}",
            extra_env={"BPS_MIN_COMPRESS_BYTES": "1024",
                       "BPS_COMPRESS_EF": "1"})
        finals[mode] = f[0]
        assert snap["ps/push_bytes"] < snap["ps/d2h_bytes"] / 3   # int8
    for a, b in zip(finals["1"], finals["0"]):
        np.testing.assert_array_equal(a, b)


# -- fallbacks ----------------------------------------------------------------

class _NormSGD(torch.optim.Optimizer):
    """SGD on the gradient over its global norm: coupled across leaves."""

    def __init__(self, params, lr=0.1):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self):
        ps = [p for g in self.param_groups for p in g["params"]
              if p.grad is not None]
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
        for g in self.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    p.add_(p.grad / norm, alpha=-g["lr"])


class _NoMailbox:
    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name.startswith("param_"):
            raise AttributeError(name)
        return getattr(self._inner, name)


class _Async(_NoMailbox):
    async_mode = True

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _fallback_case(case):
    """(backend wrapper, compression kwargs, tree, world, optimizer)."""
    rng = np.random.RandomState(0)
    tree = [(f"w{i}", torch.from_numpy(rng.randn(2048).astype(np.float32)))
            for i in range(4)]
    world, wrap, kw, make_opt = 2, None, {}, None
    if case == "dp1":
        world = 1
    elif case == "no_mailbox":
        wrap = _NoMailbox
    elif case == "async":
        wrap = _Async
    elif case == "legacy_chain":
        kw = {"compressor_type": "onebit"}
    elif case == "one_group":
        tree = tree[:1]
    elif case == "coupled":
        make_opt = _NormSGD
    return wrap, kw, tree, world, make_opt


FALLBACKS = {
    "dp1": "dp=1 (nothing to shard across)",
    "no_mailbox": "backend _NoMailbox has no param mailbox "
                  "(param_put/param_get)",
    "async": "async PS mode (round-less pulls leave no ownership anchor)",
    "legacy_chain": "legacy compressor_type keys on this declaration (their "
                    "byte-path pulls carry codec state per worker)",
    "one_group": "1 bucket group(s) — nothing to partition",
    "coupled": "optimizer is not leafwise-decomposable (owned-shard apply "
               "would change the math)",
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_each_fallback_logs_the_jax_line(case, port_log):
    wrap, kw, tree, world, make_opt = _fallback_case(case)
    be = pengine.HostPSBackend(num_servers=1, num_workers=1,
                               engine_threads=1)
    reg = NameRegistry()
    reg.declare("fb", **kw)
    ex = pps.PSGradientExchange(wrap(be) if wrap else be,
                                partition_bytes=8 << 10, registry=reg,
                                min_compress_bytes=1024)
    params = [(n, torch.nn.Parameter(t.clone())) for n, t in tree]
    opt = (make_opt or h.adam)([p for _, p in params])
    try:
        assert psu.build_sharded_state(ex, params, opt, "fb", 0,
                                       world) is None
    finally:
        ex.close()
        be.close()
    want = ("BPS_SHARDED_UPDATE falls back to the full weight update: "
            + FALLBACKS[case])
    assert port_log == [want]
    if case in ("dp1", "one_group"):
        # the JAX package says the same for the same case
        jl = _Lines()
        jlog().addHandler(jl)
        jbe = jengine.HostPSBackend(num_servers=1, num_workers=1,
                                    engine_threads=1)
        jex = jps.PSGradientExchange(jbe, partition_bytes=8 << 10)
        try:
            jsu.build_sharded_state(jex, {n: t.numpy() for n, t in tree},
                                    optax.adam(1e-3), "fb", 0, world)
        finally:
            jlog().removeHandler(jl)
            jex.close()
            jbe.close()
        assert jl.lines == [want]


@pytest.mark.parametrize("route", ["monolithic", "accumulation"])
def test_trainer_falls_back_off_the_chunked_tail(route, port_log):
    """``BPS_APPLY_CHUNKED=0`` or ``backward_passes_per_step`` > 1: the
    JAX trainer's INFO line, and the full update trains both workers to
    the same parameters."""
    extra = {"BPS_APPLY_CHUNKED": "0"} if route == "monolithic" else {}
    steps = 2 if route == "monolithic" else 4
    p0 = h.chain_params(depth=2, dim=64)
    batches = [h.chain_batches(64, 41 + w, steps) for w in range(2)]
    real = h.DistributedTrainer

    class _Trainer(real):
        def __init__(self, *a, **kw):
            if route == "accumulation":
                kw["backward_passes_per_step"] = 2
            super().__init__(*a, **kw)

    h.DistributedTrainer = _Trainer
    try:
        f, _, _, _ = h.run_port_arm(
            lambda: h.Chain(p0), h.chain_loss, batches, dp=2, sharded="1",
            name=f"zf-{route}", partition_bytes=64 * 64 * 4, steps=steps,
            expect_engaged=False, extra_env=extra)
    finally:
        h.DistributedTrainer = real
    for a, b in zip(f[0], f[1]):
        np.testing.assert_array_equal(a, b)
    want = ("BPS_SHARDED_UPDATE falls back to the full weight update: "
            "BPS_APPLY_CHUNKED=0 or backward_passes_per_step>1 (the sharded "
            "tail is the chunked tail)")
    assert port_log.count(want) == 2


# -- failures -----------------------------------------------------------------

def _mini_workers(dp=2, n_leaves=4, size=2048):
    rng = np.random.RandomState(0)
    grads = [[torch.from_numpy(rng.randn(size).astype(np.float32))
              for _ in range(n_leaves)] for _ in range(dp)]
    be = pengine.HostPSBackend(num_servers=1, num_workers=dp,
                               engine_threads=2)
    reg = NameRegistry()
    exs = [pps.PSGradientExchange(be, partition_bytes=4 << 10, registry=reg)
           for _ in range(dp)]
    params = [[(f"k{i}", torch.nn.Parameter(torch.zeros(size)))
               for i in range(n_leaves)] for _ in range(dp)]
    opts = [h.adam([p for _, p in ps]) for ps in params]
    states = [psu.build_sharded_state(exs[w], params[w], opts[w], "od", w, dp)
              for w in range(dp)]
    return be, exs, params, opts, grads, states


def _tail(state, ex, params, opt, grads, put_param=None):
    plan = state.plan
    chunked = ChunkedApply(opt, [p for _, p in params],
                           [list(g) for g in plan.groups], owned=plan.owned_set)
    hdl = ex.exchange_ingest(params, name="od", sharded=plan.round_view())
    hdl.feed(range(len(grads)), grads)
    hdl.finish()
    return state.run_tail(hdl, chunked, 1, state.next_seq(),
                          lambda arr, shape: (torch.from_numpy(arr / 2.0)
                                              .view(shape), None),
                          put_param or state.param_installer("cpu"),
                          chunked.hyper())


def test_owner_death_raises_the_diagnostic_and_the_watchdog_names_it():
    """Worker 1 pushes its gradients, its owned pulls run, and it dies
    before publishing: worker 0's tail raises naming the group, the owner
    rank, the step and the key; while the fetch waits, the watchdog dumps
    the skipped buckets as ``await_param`` from owner 1."""
    os.environ["BPS_PARAM_TIMEOUT_MS"] = "2500"
    be, exs, params, opts, grads, states = _mini_workers()
    try:
        plan0 = states[0].plan
        assert states[0].timeout_ms == 2500
        dumps = []
        wd = StallWatchdog(exs[0], stall_sec=0.4,
                           on_dump=lambda s, d: dumps.append((s, d)))
        h1 = exs[1].exchange_ingest(params[1], name="od",
                                    sharded=states[1].plan.round_view())
        h1.feed(range(4), grads[1])
        h1.finish()
        with pytest.raises(RuntimeError) as ei:
            _tail(states[0], exs[0], params[0], opts[0], grads[0])
        wd.stop()
        # the fetchers wait in parallel: any non-owned group may time out
        # first, and its message names it
        m = re.search(r"param frame for group (\d+) \(key (0x[0-9a-f]+), "
                      r"step 1, seq 1\) never arrived from owner replica 1 "
                      r"within 2500ms", str(ei.value))
        assert m, str(ei.value)
        gi = int(m.group(1))
        assert gi in plan0.fetch_order
        assert m.group(2) == f"{plan0.param_keys[gi]:#x}"
        assert dumps, "the watchdog never fired"
        state = dumps[-1][0]
        awaits = [b for r in state["rounds"] for b in r["buckets"]
                  if b["state"] == "await_param"]
        assert awaits and all(b.get("owner") == 1 for b in awaits), state
        assert len(awaits) == len(plan0.skip_groups)
        text = format_dump(state, 1.0)
        assert "awaiting param publish from owner replica 1" in text
        assert "owner replica never published" in text
        # the flight recorder's events for the implicated keys ride along
        assert {e.get("key") for e in state["flight"]["events"]} & \
            {b["pskey"] for b in awaits}
    finally:
        for ex in exs:
            ex.close()
        for st in states:
            st.close()
        be.close()


def test_a_failed_skipped_push_blames_this_replica():
    """A failed push of a bucket this replica does not pull streams no
    leaf and feeds no fetch: the tail reports this replica's failure,
    never an owner's death."""
    os.environ["BPS_PARAM_TIMEOUT_MS"] = "1500"
    be, exs, params, opts, grads, states = _mini_workers()
    try:
        plan0 = states[0].plan
        bad_key = exs[0]._plan(params[0], "od")[1][
            sorted(plan0.skip_groups)[0]][0]

        class _FailPush:
            def __init__(self, inner):
                self._inner = inner

            def push(self, key, data):
                if key == bad_key:
                    raise ConnectionError("injected push failure")
                return self._inner.push(key, data)

            def __getattr__(self, name):
                return getattr(self._inner, name)

        exs[0].backend = _FailPush(be)
        with pytest.raises((RuntimeError, ConnectionError)) as ei:
            _tail(states[0], exs[0], params[0], opts[0], grads[0])
        assert "owner died" not in str(ei.value)
        chain = repr(ei.value) + repr(ei.value.__cause__)
        assert "injected push failure" in chain, chain
    finally:
        for ex in exs:
            ex.close()
        for st in states:
            st.close()
        be.close()


def test_a_dead_publisher_is_raised_at_the_next_publish_and_at_close():
    be, exs, params, opts, grads, states = _mini_workers()
    try:
        st = states[0]

        def refuse(*a, **k):
            raise ConnectionError("mailbox gone")

        exs[0].backend = type("B", (), {"param_put": staticmethod(refuse)})()
        gi = st.plan.owned[0]
        st.publish(gi, 1, [params[0][li][1].detach().numpy()
                           for li in st.plan.groups[gi]])
        deadline = time.time() + 5
        while st._pub_err is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="publisher died"):
            st.publish(st.plan.owned[0], 2, [])
        with pytest.raises(RuntimeError, match="publisher died"):
            st.close()
    finally:
        for ex in exs:
            ex.close()
        states[1].close()
        be.close()
