"""The port's adaptive codec controller (``BPS_COMPRESS=auto``,
``byteps_tpu_torch/compress/controller.py``) held against the JAX
package's: each case of the JAX package's ``tests/test_compress_controller.py``
is a signal trace fed to both controllers, each over its own fresh metrics
registry, comparing every decision's levels, the ``compress/level/<layer>``
gauges and the ``compress/decisions`` counter. Then the plane in auto mode:
the port's ``PSGradientExchange`` on CPU tensors against the JAX exchange on
the same seeded gradients and the same injected signals, round by round.

Tolerance: none. Levels and counters are integers; the exchanges' sums are
bit for bit (the port encodes with its kernels' plain versions, the JAX
package with its host codec, whose bytes they are: ``test_torch_ps.py``).
"""

import numpy as np
import pytest
import torch

from byteps_tpu.compress import device as jdev
from byteps_tpu.compress.controller import CompressController as JController
from byteps_tpu.compress.plane import CompressionPlane as JPlane
from byteps_tpu.obs import metrics as jmetrics
from byteps_tpu.server.engine import HostPSBackend as JBackend
from byteps_tpu.server.ps_mode import PSGradientExchange as JExchange
from byteps_tpu_torch.compress import device as tdev
from byteps_tpu_torch.compress import wire
from byteps_tpu_torch.compress.controller import (CompressController,
                                                  FixedController)
from byteps_tpu_torch.compress.plane import CompressionPlane
from byteps_tpu_torch.obs import flight
from byteps_tpu_torch.obs import metrics as tmetrics
from byteps_tpu_torch.server.engine import HostPSBackend
from byteps_tpu_torch.server.ps_mode import PSGradientExchange

LAYERS = ("l0", "l1")


def _stall(n):
    return {"stalls": n}


# A round of a trace: the signals raised before that decision. "stalls" and
# "resends" add to their counters, "depth" sets the backlog gauge, "bytes"
# adds to per-layer ps/push_bytes counters.
TRACES = {
    # sustained stalls walk the ladder one rung per `hold` verdicts
    "wire_bound_ratchets_up": (dict(max_level="topk"), [_stall(5)] * 12),
    # BPS_COMPRESS_MAX gates the fp8 rungs
    "max_int8_never_fp8": (dict(max_level="int8"), [_stall(5)] * 12),
    "max_fp8_e4m3_never_topk": (dict(max_level="fp8_e4m3"), [_stall(5)] * 12),
    "resends_count_as_pressure": (dict(max_level="fp16"),
                                  [{"resends": 1}] * 2),
    "queue_depth_counts_as_pressure": (dict(max_level="fp16"),
                                       [{"depth": 5}, {}]),
    # an idle wire decays every layer back to none
    "idle_wire_decays_to_none": (dict(max_level="topk"),
                                 [_stall(1)] * 10 + [{}] * 10),
    # alternating verdicts never move the ladder
    "hysteresis_alternating": (dict(max_level="topk"),
                               [_stall(1), {}] * 6),
    # a backlog under the floor with no stalls is the boundary: holds
    "boundary_depth_holds": (dict(max_level="topk"),
                             [{"depth": 1.0}] * 6),
    "boundary_depth_holds_a_raised_level": (
        dict(max_level="int8"),
        [_stall(1)] * 4 + [{"depth": 1.0}] * 5 + [{"depth": 0}] * 4),
    "decisions_counted": (dict(max_level="int8"), [_stall(1)] * 4),
    # only layers that moved bytes climb; decay takes every layer
    "up_step_targets_loading_layers": (
        dict(max_level="int8", hold=1),
        [_stall(1), {"stalls": 1, "bytes": {"l0": 1 << 20}}, {}]),
    "queue_floor_raised": (dict(max_level="int8", queue_depth_min=8.0),
                           [{"depth": 5}] * 4 + [{"depth": 9}] * 4),
}
# cases driven through on_round, where `interval` spaces the decisions
ON_ROUND = {
    "interval_cadence": (dict(max_level="int8", hold=1, interval=3),
                         [_stall(1)] * 5),
    "interval_two_hold_two": (dict(max_level="fp8_e4m3", interval=2),
                              [_stall(2)] * 12 + [{}] * 12),
}


def _apply(reg, step):
    if step.get("stalls"):
        reg.counter("nic/stalls").inc(step["stalls"])
    if step.get("resends"):
        reg.counter("transport/resends").inc(step["resends"])
    if "depth" in step:
        reg.gauge("server/engine_queue_depth").set(step["depth"])
    for layer, n in step.get("bytes", {}).items():
        reg.counter(f"ps/push_bytes/{layer}").inc(n)


def _drive(make_reg, make_ctl, kw, trace, on_round):
    reg = make_reg()
    c = make_ctl(registry=reg, **kw)
    for layer in LAYERS:
        c.register_layer(layer)
    seen = []
    for step in trace:
        _apply(reg, step)
        if on_round:
            c.on_round()
        else:
            c.decide()
        seen.append(tuple(c.level_of(layer) for layer in LAYERS))
    gauges = tuple(reg.gauge(f"compress/level/{layer}").value
                   for layer in LAYERS)
    return seen, gauges, reg.counter("compress/decisions").value


@pytest.mark.parametrize("case,on_round", [(c, False) for c in TRACES]
                         + [(c, True) for c in ON_ROUND])
def test_controller_trace_is_the_jax_controllers(case, on_round):
    kw, trace = (ON_ROUND if on_round else TRACES)[case]
    ours = _drive(tmetrics.MetricsRegistry, CompressController, kw, trace,
                  on_round)
    ref = _drive(jmetrics.MetricsRegistry, JController, kw, trace, on_round)
    assert ours == ref
    levels, gauges, decisions = ours
    # the gauges hold the last levels; the counter counts the changes
    assert gauges == levels[-1]
    changes = sum(a != b for prev, cur in zip([(0, 0)] + levels, levels)
                  for a, b in zip(prev, cur))
    assert decisions == changes


def test_decisions_are_flight_events():
    """A level change is a key-less ``codec`` event of the flight ring."""
    rec = flight.get_recorder()
    rec.configure(enabled=True)
    rec.clear()
    reg = tmetrics.MetricsRegistry()
    c = CompressController(registry=reg, max_level="fp16", hold=1)
    c.register_layer("x")
    reg.counter("nic/stalls").inc()
    c.decide()
    evs = rec.events(keys=[12345])          # key-less: passes any filter
    assert [(e["kind"], e["stage"], e["detail"]) for e in evs] == \
        [("codec", "x", "level 0->1")]
    rec.configure()


def test_fixed_controller_pins_the_trace():
    reg = tmetrics.MetricsRegistry()
    c = FixedController("fp16", registry=reg)
    c.register_layer("a")
    reg.counter("nic/stalls").inc(100)
    c.on_round()
    assert c.level_of("a") == wire.CODEC_FP16
    assert reg.gauge("compress/level/a").value == wire.CODEC_FP16


def test_plane_auto_mode_is_the_jax_planes(monkeypatch):
    """Through the planes (``BPS_COMPRESS_MAX`` and
    ``BPS_COMPRESS_INTERVAL`` from the env): the same stalls ratchet the
    level; each round's host encode at that level and its residual are the
    JAX plane's; quiet rounds decay it, and the decayed round flushes the
    residual once and restarts the fp8 sequence."""
    monkeypatch.setenv("BPS_COMPRESS_MAX", "fp8_e4m3")
    monkeypatch.setenv("BPS_COMPRESS_INTERVAL", "1")
    planes = []
    for reg, plane_cls in ((tmetrics.MetricsRegistry(), CompressionPlane),
                           (jmetrics.MetricsRegistry(), JPlane)):
        p = plane_cls.from_config("auto", 0, registry=reg)
        assert p.register(11, 2048, "float32", "m.0")
        planes.append((reg, p))
    assert planes[0][1].controller.max_level == wire.CODEC_FP8_E4M3
    rng = np.random.RandomState(5)
    trace = []
    for rnd in range(1, 15):
        x = rng.randn(2048).astype(np.float32)
        outs = []
        for reg, p in planes:
            if rnd <= 6:
                reg.counter("nic/stalls").inc(2)
            p.on_round()
            level = p.level_of(11)
            if level:
                payload = p.encode(11, x, level, rnd)
                merged = p.decode(11, payload, rnd)
            else:
                p.note_dense_push(11, x.nbytes)
                merged = p.fold_residual(11, x, rnd)
                p.commit(11, rnd)
            st = p._keys[11]
            resid = None if st.residual is None else \
                np.asarray(st.residual, np.float32).tobytes()
            outs.append((level, np.asarray(merged).tobytes(), resid,
                         st.sr_seq))
        assert outs[0] == outs[1], rnd
        trace.append(outs[0][0])
    assert trace == [0, 1, 1, 2, 2, 3, 3, 2, 2, 1, 1, 0, 0, 0]
    assert planes[0][1]._keys[11].residual is None   # flushed on decay


def test_auto_with_stats_off_warns(monkeypatch, caplog):
    import logging

    from byteps_tpu_torch.common.logging import get_logger
    monkeypatch.setattr(tmetrics, "_enabled", False)
    log = get_logger()
    log.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=log.name):
            CompressionPlane.from_config("auto", 0,
                                         registry=tmetrics.MetricsRegistry())
    finally:
        log.propagate = False
    assert "BPS_STATS=0" in caplog.text


def _grads(seed):
    rng = np.random.RandomState(seed)
    shapes = [(64, 33), (900,), (17, 5, 12), (3000,), (1,)]
    return {f"l{i}": (rng.randn(*s) * (i + 1)).astype(np.float32)
            for i, s in enumerate(shapes)}


def _signals(reg, rnd):
    """The injected signals before round ``rnd``: stalls for 6 rounds,
    then quiet; the backlog gauge pinned to 0 so the pushes' own samples
    (a timing of the engine threads) cannot vote."""
    if rnd < 6:
        reg.counter("nic/stalls").inc(3)
    reg.gauge("server/engine_queue_depth").set(0)


def test_exchange_in_auto_mode_is_the_jax_exchange(monkeypatch):
    """``BPS_COMPRESS=auto`` with ``BPS_COMPRESS_MAX=fp8_e4m3`` through
    the exchanges, the port's on CPU tensors (its device encode, the
    kernels' plain versions), the JAX package's with its host codec: with
    the same injected signals the level trace climbs to fp8 and decays,
    and every round's summed leaves are the JAX exchange's, bit for bit."""
    monkeypatch.setenv("BPS_COMPRESS_MAX", "fp8_e4m3")
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tdev.reset_probe()
    trees = [_grads(20 + r) for r in range(12)]
    treg, jreg = tmetrics.get_registry(), jmetrics.get_registry()
    be = HostPSBackend(num_servers=1, num_workers=1, engine_threads=1)
    ex = PSGradientExchange(be, partition_bytes=16 << 10,
                            min_compress_bytes=0, compress="auto",
                            device="cpu")
    got, levels = [], []
    try:
        for r, t in enumerate(trees):
            _signals(treg, r)
            out = ex.exchange([(k, torch.from_numpy(v)) for k, v in t.items()],
                              name="g")
            got.append([o.copy() for o in out])
            levels.append(sorted({ex._cplane.level_of(k)
                                  for k, _ in ex._plans[next(iter(ex._plans))][1]
                                  if ex._cplane.active(k)}))
    finally:
        ex.close()
        be.close()
        torch.set_num_threads(n)
        tdev.reset_probe()
    monkeypatch.setenv("BPS_COMPRESS_DEVICE", "0")
    jdev.reset_probe()
    import jax.numpy as jnp
    jbe = JBackend(num_servers=1, num_workers=1, engine_threads=1)
    jex = JExchange(jbe, partition_bytes=16 << 10, min_compress_bytes=0,
                    compress="auto")
    try:
        for r, (t, g) in enumerate(zip(trees, got)):
            _signals(jreg, r)
            want = jex.exchange({k: jnp.asarray(v) for k, v in t.items()},
                                name="g")
            for o, k in zip(g, sorted(t)):
                assert o.tobytes() == np.asarray(want[k]).tobytes(), (r, k)
    finally:
        jex.close()
        jbe.close()
        jdev.reset_probe()
    # one level for every eligible bucket each round: none, then up a
    # rung every second stalled round, then down every second quiet one
    assert [lv for (lv,) in levels] == [0, 1, 1, 2, 2, 3, 3, 2, 2, 1, 1, 0]


def test_backlog_gauge_counts_unsummed_pushes():
    """``server/engine_queue_depth``: a dense push samples the backend's
    backlog, its engines' queued pushes plus the fused store's buffered
    arrivals. ``engine_load`` is the JAX server's assigned bytes; the port's
    ``queue_depth`` leaves it out (it never falls back, so it would hold
    the controller wire-bound), where the JAX ``queue_depth`` adds it."""
    from byteps_tpu_torch.compress import wire as twire
    be = HostPSBackend(num_servers=1, num_workers=2, engine_threads=2)
    jbe = JBackend(num_servers=1, num_workers=2, engine_threads=2)
    try:
        for b in (be, jbe):
            b.init_key(1, 4096 * 4, "float32", fused=True)
            b.init_key(2, 1000 * 4, "float32")
        loads = [s.engine_load(t) for s in be.servers for t in range(2)]
        assert loads == [s.engine_load(t) for s in jbe.servers
                         for t in range(2)]
        assert sum(loads) == (4096 + 1000) * 4
        assert be.queue_depth() == 0
        x = np.ones(4096, np.float32)
        be.push_fused(1, twire.encode(twire.CODEC_INT8, x))
        assert be.queue_depth() == 1           # one arrival buffered
        be._qd_next_sample = 0.0
        be.push(2, np.ones(1000, np.float32))  # a dense push samples it
        assert tmetrics.get_registry().gauge(
            "server/engine_queue_depth").value in (1, 2)
        be.push(1, x)                          # the fused round completes
        out = np.empty(4096, np.float32)
        be.pull(1, out, round=1)
        assert be._homog.pending() == 0
    finally:
        be.close()
        jbe.close()
