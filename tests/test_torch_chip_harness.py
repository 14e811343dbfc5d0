"""Repairs of ``chip_smoke.py``'s gates, held on the CPU.

The push_pull speed gate of ``bert_large_pushpull_int8``: the reading of
``get_pushpull_speed()`` (``telemetry.PushPullSpeed``, a 10 s window) is
held within x``SPEED_FACTOR`` of a model of that window. Its first model
counted whole steps by the dispatch of their first exchange, exact only
while every counted step fits in the window; with three steps over 11.5 s
(one of them 5.06 s), a step whose exchanges were dispatched across the
window's edge is half in the telemetry's window and wholly out of the
model's, and the gate failed a sound reading (313.6 MB/s against a
modelled 424.9). ``chip_smoke.window_mbps`` models it per exchange, each
by its own start and bytes, as the telemetry counts it: fed such a run's
dispatch times it agrees with the telemetry, where the old model does
not.
"""

import time
import types

import numpy as np
import pytest

import chip_smoke
from byteps_tpu_torch import telemetry

N_EXCH, BYTES = 391, 1_335_967_744 // 391    # BERT-large's gradients


def _run_like_e():
    """Three steps of 391 exchanges each: (start, done, bytes) of every
    exchange, and when each step's last synchronize returned. Each step's
    dispatch loop takes 2 s; step 1 ends at 5.06 s, step 3 at 11.5 s, so
    step 1's dispatch loop straddles the window's edge at the last
    reading."""
    steps = [(1.2, 3.2, 5.06), (6.0, 8.0, 8.6), (9.2, 11.2, 11.5)]
    exchanges, ends = [], []
    for first, last, end in steps:
        starts = np.linspace(first, last, N_EXCH)
        dones = np.linspace(last + 0.05, end, N_EXCH)
        exchanges += [(float(a), float(b), BYTES)
                      for a, b in zip(starts, dones)]
        ends.append(end)
    return exchanges, ends


def _telemetry_readings(exchanges, ends, monkeypatch):
    clock = {"now": 0.0}
    monkeypatch.setattr(telemetry, "time",
                        types.SimpleNamespace(time=lambda: clock["now"]))
    speed = telemetry.PushPullSpeed()
    out, prev = [], 0.0
    for end in ends:
        for start, done, n in exchanges:
            if prev < done <= end:          # this step's synchronizes
                clock["now"] = done
                speed.record(n, done - start)
        clock["now"] = prev = end
        out.append(speed.mbps())
    return out


def _old_model(exchanges, ends, per_step):
    """The first model: whole steps by their first dispatch."""
    firsts = [exchanges[i * per_step][0] for i in range(len(ends))]
    out = []
    for k, now in enumerate(ends):
        inside = [d for d in firsts[:k + 1] if now - d <= 10.0]
        out.append(len(inside) * per_step * BYTES / (now - min(inside))
                   / 1e6)
    return out


def test_the_window_is_modelled_per_exchange(monkeypatch):
    exchanges, ends = _run_like_e()
    got = _telemetry_readings(exchanges, ends, monkeypatch)
    new = [chip_smoke.window_mbps(exchanges, now)[0] for now in ends]
    old = _old_model(exchanges, ends, N_EXCH)
    f = chip_smoke.SPEED_FACTOR
    assert f == 1.25
    for g, w in zip(got, new):
        assert 1 / f <= g / w <= f
        assert g == pytest.approx(w, rel=1e-9)
    # the last reading: part of step 1 is still in the telemetry's window
    assert chip_smoke.window_mbps(exchanges, ends[-1])[1] < 3 * N_EXCH
    assert not all(1 / f <= g / w <= f for g, w in zip(got, old))
    assert got[-1] / old[-1] < 1 / f


# -- the full run's time limit: paths cut in depth, every gate kept ----------

def test_cut_paths_keep_their_width_and_recompute_their_counts():
    """The cut paths (``CUT_LAYERS`` of BERT-large's 24 layers) keep its
    full width, and their wanted launches follow the depth: 2 forwards
    and 1 fused backward a layer a step (whole-block remat), at d 64. The
    async phase's config is the full depth."""
    full = chip_smoke._bert_setup()[0]
    cut = chip_smoke._bert_setup(layers=chip_smoke.CUT_LAYERS)[0]
    assert (full.layers, cut.layers) == (24, chip_smoke.CUT_LAYERS) \
        and cut.layers < 24
    for f in ("hidden", "heads", "mlp_dim", "vocab_size", "max_seq",
              "dtype", "remat"):
        assert getattr(cut, f) == getattr(full, f), f
    for cfg in (full, cut):
        want = chip_smoke._attention_launches(cfg, ("flash_bwd_fused",))(None)
        n = chip_smoke.STEPS * cfg.layers
        assert want["flash_fwd"] == want["flash_fwd:d64"] == 2 * n
        assert want["flash_bwd_fused"] == want["flash_bwd_fused:d64"] == n
        assert want["int8_quantize"] == want["fp8_sr_quantize"] == 0


def test_cut_gpt2_paths_keep_their_width_and_recompute_their_counts():
    """GPT-2 medium's compressed paths beyond onebit run at
    ``CUT_LAYERS``: its full width, and wanted launches (2 forwards, a dq
    and a dk/dv a layer a step) that follow the depth."""
    full = chip_smoke._gpt2_setup()[0]
    cut = chip_smoke._gpt2_setup(layers=chip_smoke.CUT_LAYERS)[0]
    assert (full.layers, cut.layers) == (24, chip_smoke.CUT_LAYERS)
    for f in ("hidden", "heads", "mlp_dim", "vocab_size", "max_seq",
              "dtype", "remat", "causal"):
        assert getattr(cut, f) == getattr(full, f), f
    want = chip_smoke._attention_launches(
        cut, ("flash_bwd_dq", "flash_bwd_dkv"))(None)
    n = chip_smoke.STEPS * cut.layers
    assert want["flash_fwd"] == want["flash_fwd:d64"] == 2 * n
    assert want["flash_bwd_dq"] == want["flash_bwd_dkv"] == n
    assert want["flash_bwd_fused"] == 0


def test_timed_keeps_each_phases_seconds():
    chip_smoke.PHASE_S.clear()
    assert chip_smoke._timed("p", lambda a, b: a + b, 2, 3) == 5
    with pytest.raises(ZeroDivisionError):
        chip_smoke._timed("q", lambda: 1 / 0)
    assert set(chip_smoke.PHASE_S) == {"p", "q"}
    chip_smoke.PHASE_S.clear()


# -- the async phase's store gate ---------------------------------------------

def _folds(rng, n, k):
    init = (rng.randn(n) * 10.0 ** rng.randint(-3, 3, n)).astype(np.float32)
    deltas = [(rng.randn(n) * 10.0 ** rng.randint(-8, 0, n)).astype(
        np.float32) for _ in range(k)]
    return init, deltas


@pytest.mark.parametrize("seed", range(4))
def test_the_async_store_gate_holds_any_fold_order(seed):
    """Two workers' folds have no defined order: the store, folded in fp32
    in any order, is within ``async_store_check``'s bound of the float64
    sum; a store that missed one delta, or folded one twice, is not."""
    rng = np.random.RandomState(seed)
    init, deltas = _folds(rng, 50_000, 6)
    # near-cancelling deltas: the running value grows past the end's
    deltas[0] += np.float32(1e3)
    deltas[1] -= np.float32(1e3)
    for order in (range(6), rng.permutation(6), rng.permutation(6)):
        store = init.copy()
        for i in order:
            store = store + deltas[i]
        over, worst = chip_smoke.async_store_check(init, deltas, store, 6)
        assert over == 0 and worst <= 1.0
    for bad in (store - deltas[3], store + deltas[3]):
        over, _ = chip_smoke.async_store_check(init, deltas, bad, 6)
        assert over > 0


def test_the_async_store_gate_on_bf16_deltas():
    """(d2): the deltas as pushed, bf16 bits widened exactly."""
    from byteps_tpu_torch.common import bf16
    rng = np.random.RandomState(9)
    init, deltas = _folds(rng, 20_000, 6)
    wide = [bf16.widen(bf16.narrow(d)) for d in deltas]
    store = init.copy()
    for d in wide[::-1]:
        store = store + d
    assert chip_smoke.async_store_check(init, wide, store, 6)[0] == 0
    # against the unrounded deltas the bf16 store is off
    assert chip_smoke.async_store_check(init, deltas, store, 6)[0] > 0


# -- the async phase: the pulled weights installed, the other's deltas in them

def test_the_install_gate_reads_every_parameter_bit_for_bit():
    """``async_installed`` counts the parameters that are not the last
    pull's host buffers: a trainer that pushed its deltas but kept its
    own weights fails it, by one ulp or by the sign of a zero."""
    import torch
    rng = np.random.RandomState(3)
    hosts = [torch.from_numpy(rng.randn(n).astype(np.float32))
             for n in (5, 12, 1)]
    hosts[2][0] = 0.0
    params = [torch.nn.Parameter(h.clone().reshape(-1, 1)) for h in hosts]
    trainer = types.SimpleNamespace(
        _ps_params=[(str(i), p) for i, p in enumerate(params)],
        _pulled=(hosts, [h.numpy() for h in hosts]))
    assert chip_smoke.async_installed(trainer) == 0
    with torch.no_grad():
        params[1][4] = torch.from_numpy(np.nextafter(
            hosts[1][4:5].numpy(), np.float32(np.inf)))
        params[2][0] = -0.0
    assert chip_smoke.async_installed(trainer) == 2


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_the_own_only_gate_on_an_async_store(wire):
    """On the port's async store: ``PullRounds`` reads each key's round
    before the pull, and ``async_own_only`` finds the keys whose pull
    began after another worker's fold; of them, pulled weights that are
    init plus this worker's own deltas alone (a pull that missed the
    other's delta) are counted."""
    from byteps_tpu_torch.common import bf16
    from byteps_tpu_torch.server.engine import HostPSBackend
    rng = np.random.RandomState(4)
    init = [rng.randn(n).astype(np.float32) for n in (300, 40)]
    be = HostPSBackend(num_workers=2, async_mode=True)
    try:
        for k, a in enumerate(init):
            be.init_key(k, a.nbytes, "float32", init=a)
        log = chip_smoke.DeltaLog(be)
        rounds = chip_smoke.PullRounds(be)
        for _ in range(3):
            for k, a in enumerate(init):
                d = (rng.randn(a.size) * 1e-3).astype(np.float32)
                be.push(k, d if wire == "float32" else bf16.narrow(d))
        log.stop()
        be.push(0, np.full(300, 1e-2, np.float32))    # the other worker
        deadline = time.time() + 30         # the engine's folds
        while (be.round(0), be.round(1)) != (4, 3):
            assert time.time() < deadline, (be.round(0), be.round(1))
            time.sleep(0.001)
        hosts = [np.empty_like(a) for a in init]
        rounds.on = True
        for k, h in enumerate(hosts):
            be.pull(k, h)
        rounds.stop()
    finally:
        be.close()
    assert rounds.seen == {0: 4, 1: 3}
    assert chip_smoke.async_own_only(init, log.pushed, rounds.seen, [0, 1],
                                     hosts, 3) == (1, 0)
    own = init[0]
    for d in log.pushed[0]:
        own = own + bf16.cast(d, "float32")
    assert chip_smoke.async_own_only(init, log.pushed, rounds.seen, [0, 1],
                                     [own, hosts[1]], 3) == (1, 1)


def test_the_servers_memory_by_mapping():
    """``memory_map`` sorts ``/proc/<pid>/smaps``' resident sets: the brk
    heap, anonymous mappings aligned to glibc's 64 MiB arena heaps, other
    anonymous mappings, files; ``rss_at`` is the largest sample up to
    each step's end."""
    text = "\n".join([
        "55d0c0a00000-55d0c0a21000 rw-p 00000000 00:00 0   [heap]",
        "Size:  132 kB", "Rss:   100 kB", "VmFlags: rd wr mr",
        "7f0004000000-7f0008000000 rw-p 00000000 00:00 0 ",
        "Rss:   2048 kB",
        "7f0008021000-7f000c000000 rw-p 00000000 00:00 0 ",
        "Rss:   30 kB",
        "7f1000000000-7f1000001000 r-xp 00000000 08:01 42   /usr/lib/libc.so.6",
        "Rss:   4 kB",
        "7ffd00000000-7ffd00021000 rw-p 00000000 00:00 0   [stack]",
        "Rss:   8 kB"])
    assert chip_smoke.memory_map(text=text) == {
        "brk": 100 << 10, "arenas": 2048 << 10, "anon": 38 << 10,
        "files": 4 << 10}
    assert chip_smoke.memory_map(pid=-1) is None
    samples = [(1.0, 5), (2.0, 9), (3.0, 7), (4.0, 8)]
    assert chip_smoke.rss_at(samples, [0.5, 2.5, 3.5, 9.0]) == [0, 9, 9, 9]


# -- the transport phase's gates (``bert_large_ps_transport``, (f3))


def _bert_large_plan():
    """BERT-large's dense bucket sizes (327 buckets of at most 4,096,000
    bytes) and the parts ``_stripe_ranges`` makes of each at
    ``BPS_STRIPE_MIN=1048576`` on 4 channels."""
    from byteps_tpu_torch.server.transport import RemotePSBackend
    c = object.__new__(RemotePSBackend)
    c._stripe_min, c._nconns = 1 << 20, 4
    sizes = [4_096_000] * 300 + [1_048_576] * 7 + [524_288] * 5 \
        + [8_192] * 15
    return sizes, [len(c._stripe_ranges(n) or ()) for n in sizes]


def _sound_stats(arm, plan):
    n, nb = 6, len(plan)
    parts, whole = sum(plan), sum(1 for p in plan if not p)
    stats = dict.fromkeys(
        ("server/push_frames", "server/pull_frames", "server/shm_pushes",
         "server/shm_pulls", "server/part_pushes", "server/part_pulls",
         "server/tcp_conns", "server/ipc_conns"), 0)
    if arm == "f0":
        stats.update({"server/push_frames": n * nb,
                      "server/pull_frames": n * nb + 3,
                      "server/tcp_conns": 8})
    elif arm == "f1":
        stats.update({"server/shm_pushes": n * nb,
                      "server/shm_pulls": n * nb + 5,
                      "server/ipc_conns": 8})
    else:
        stats.update({"server/part_pushes": n * parts,
                      "server/part_pulls": n * parts,
                      "server/push_frames": n * whole,
                      "server/pull_frames": n * whole + 1,
                      "server/tcp_conns": 8})
    return stats


def test_the_transport_frames_come_from_the_bucket_plan():
    sizes, plan = _bert_large_plan()
    assert len(plan) == 327
    assert plan[:300] == [4] * 300            # 4 parts of 1,024,000 bytes
    assert plan[300:] == [0] * 27             # below 1 MiB or one part
    exact, least = chip_smoke.transport_frames_want("f1", plan)
    assert exact["server/shm_pushes"] == 2 * 3 * 327
    assert least["server/shm_pulls"] == 2 * 3 * 327
    assert exact["server/push_frames"] == exact["server/pull_frames"] == 0
    assert exact["server/tcp_conns"] == 0
    exact, least = chip_smoke.transport_frames_want("f2", plan)
    assert exact["server/part_pushes"] == 2 * 3 * 1200
    assert exact["server/push_frames"] == 2 * 3 * 27
    assert least["server/part_pulls"] == 2 * 3 * 1200
    exact, _ = chip_smoke.transport_frames_want("f0", plan)
    assert exact["server/push_frames"] == 2 * 3 * 327
    assert exact["server/part_pushes"] == exact["server/shm_pushes"] == 0


@pytest.mark.parametrize("arm", ["f0", "f1", "f2"])
def test_the_transport_server_gate_passes_a_sound_run_only(arm):
    _, plan = _bert_large_plan()
    stats = _sound_stats(arm, plan)
    assert chip_smoke.check_transport_server(arm, stats, plan) == []
    faults = {"f0": ("server/push_frames", -1),
              "f1": ("server/push_frames", 1),     # a socket push
              "f2": ("server/part_pushes", 1)}     # a part resent
    name, d = faults[arm]
    bad = dict(stats, **{name: stats[name] + d})
    assert chip_smoke.check_transport_server(arm, bad, plan)
    if arm == "f1":
        for name in ("server/tcp_conns", "server/pull_frames"):
            assert chip_smoke.check_transport_server(
                arm, dict(stats, **{name: 1}), plan)
        short = dict(stats, **{"server/shm_pulls": 2 * 3 * 327 - 1})
        assert chip_smoke.check_transport_server(arm, short, plan)


def test_the_dev_shm_fit_check():
    need, why = chip_smoke.shm_fit(64 << 20, 2, 4, 4_096_000)
    assert need == 2 * 4 * 4_096_000 and why is None
    need, why = chip_smoke.shm_fit(32 << 20, 2, 4, 4_096_000)
    assert need == 32_768_000 and why is None        # 32 MiB holds it
    need, why = chip_smoke.shm_fit(30 << 20, 2, 4, 4_096_000)
    assert why and "/dev/shm has" in why
    need, why = chip_smoke.shm_fit(16 << 20, 2, 4, 1000)
    assert need == 8 << 20 and why is None           # 1 MiB a segment


def _snapshot_run():
    before = {"keys": 3, "rounds": [chip_smoke.SNAPSHOT_STEPS],
              "sha1": ["a", "b", "c"]}
    report = {"sha1": ["a", "b", "c"], "reconnects": 4, "loss3": 7.2,
              "rounds": [1], "over": 0}
    first = chip_smoke.snapshot_lines([
        "[byteps_tpu_torch.launch] server up on :4000 (workers=1)",
        "[byteps_tpu_torch.launch] final snapshot: 3 PS keys, 4096 bytes "
        "in 0.012 s -> /tmp/x/ps.npz"])
    second = chip_smoke.snapshot_lines([
        "[byteps_tpu_torch.launch] restored 3 PS keys from /tmp/x/ps.npz "
        "(4096 bytes in 0.020 s)",
        "[byteps_tpu_torch.launch] server up on :4000 (workers=1)"])
    return before, report, first, second, {"server/restored_keys": 3}


def test_the_snapshot_restart_gate_passes_a_sound_run_only():
    before, report, first, second, stats = _snapshot_run()
    assert first["final"] == (3, 4096, 0.012) and first["restored"] is None
    assert second["restored"] == (3, 4096, 0.020)
    assert chip_smoke.check_snapshot_restart(before, report, first, second,
                                             stats) == []
    broken = [
        (dict(before), dict(report, sha1=["a", "x", "c"]), first, second,
         stats),
        (before, dict(report, reconnects=0), first, second, stats),
        (before, dict(report, loss3=float("nan")), first, second, stats),
        (before, dict(report, over=12), first, second, stats),
        (before, report, {"final": None, "restored": None}, second, stats),
        (before, report, first, {"final": None, "restored": (2, 1, 0.1)},
         stats),
        (before, report, first, second, {"server/restored_keys": 0}),
        (dict(before, rounds=[1, 2]), report, first, second, stats),
    ]
    for args in broken:
        assert chip_smoke.check_snapshot_restart(*args), args


# -- the membership phase's gates (bert_large_ps_membership)

def _small_plan_inputs():
    """``_plan_inputs`` of a port exchange over six leaves in 4 KiB
    buckets."""
    import torch

    from byteps_tpu_torch.server import engine, ps_mode
    from byteps_tpu_torch.sharded_update import ShardedUpdatePlan
    be = engine.HostPSBackend(num_servers=1, num_workers=1,
                              engine_threads=1)
    ex = ps_mode.PSGradientExchange(be, partition_bytes=4 << 10)
    pairs = [(f"k{i}", torch.zeros(1000 + 200 * i)) for i in range(6)]
    try:
        _, keyed = ex._plan(pairs, "m")
        groups = ex.leaf_groups(pairs, name="m")
    finally:
        ex.close()
        be.close()
    return {"keyed": [[k, b.index, [s.leaf_index for s in b.segments]]
                      for k, b in keyed],
            "groups": [list(g) for g in groups],
            "leaf_meta": [[list(sh), dt, n] for sh, dt, n in
                          ShardedUpdatePlan.leaf_meta_of(pairs)]}


def _state(plan, wid, epoch):
    mine = sorted(gi for gi, o in enumerate(plan.owner) if o == wid)
    moments = 2 * sum(plan.group_bytes[gi] for gi in mine)
    steps = 4 * sum(len(plan.groups[gi]) for gi in mine)
    return {"owned": mine, "with_state": list(mine),
            "state_bytes": moments + steps, "moment_bytes": moments,
            "owner": list(plan.owner), "member_epoch": epoch}


def _membership_g1():
    """(g1)'s two sound reports on the small plan."""
    inputs = _small_plan_inputs()
    plan0 = chip_smoke._plan_from(inputs)
    res = [{"plan": inputs, "start": _state(plan0, w, 1), "reshards": []}
           for w in (0, 1)]
    prev, epoch = plan0, 1
    for live in chip_smoke.MEMBERSHIP_LIVE.values():
        new, epoch = prev.reshard(live), epoch + 1
        for w, r in enumerate(res):
            before, after = _state(prev, w, epoch - 1), _state(new, w, epoch)
            lost = sorted(set(before["owned"]) - set(after["owned"]))
            gained = sorted(set(after["owned"]) - set(before["owned"]))
            r["reshards"].append({
                "live": list(live), "weights": None, "seconds": 0.1,
                "member_epoch": epoch, "lost": lost, "gained": gained,
                "puts": list(lost), "adopted": list(gained),
                "before": before, "after": after})
        prev = new
    for w, r in enumerate(res):
        r["end"] = _state(prev, w, epoch)
    return res


def _break_plan(res, case):
    x = res[1]["reshards"][0]
    if case == "owner_map":
        x["after"]["owner"] = [0] * (len(x["after"]["owner"]) - 1) + [1]
    elif case == "leaver_keeps_state":
        x["after"]["state_bytes"] = 8
    elif case == "leaver_owns":
        x["after"]["owned"] = x["after"]["with_state"] = [0]
    elif case == "frames":
        x["puts"] = x["puts"][:-1]
    elif case == "adopted":
        res[0]["reshards"][0]["adopted"] = []
    elif case == "moments":
        res[0]["reshards"][1]["after"]["moment_bytes"] += 4
    elif case == "weights":
        x["weights"] = [1] * len(x["after"]["owner"])
    elif case == "epoch":
        res[0]["end"]["member_epoch"] = 2
    return res


@pytest.mark.parametrize("case", ["owner_map", "leaver_keeps_state",
                                  "leaver_owns", "frames", "adopted",
                                  "moments", "weights", "epoch"])
def test_the_membership_plan_gate_passes_a_sound_run_only(case):
    res = _membership_g1()
    assert len(res[0]["plan"]["groups"]) >= 3
    assert res[1]["reshards"][0]["lost"], "the leaver owned nothing"
    assert res[0]["reshards"][0]["after"]["owned"] == \
        list(range(len(res[0]["plan"]["groups"])))
    assert chip_smoke.check_membership_plans(res) == []
    assert chip_smoke.check_membership_plans(_break_plan(res, case))


def _membership_ck():
    owner = [0, 1, 0, 1, 0]
    slices = {f"g{gi}.bin": 1000 + gi for gi in range(len(owner))}
    g0 = [{"save": {"owner": owner, "member_epoch": 1,
                    "slices": {k: v for k, v in slices.items()
                               if owner[int(k[1:-4])] == w}}}
          for w in (0, 1)]
    g2 = []
    for w in (0, 1):
        mine = [gi for gi, o in enumerate(owner) if o == w]
        g2.append({"restore": {"owner": owner, "member_epoch": 1,
                               "slices": dict(slices),
                               "optimizer_before_step": 0},
                   "adopted_at_start": mine,
                   "end": {"owned": mine, "with_state": mine}})
    return g0, g2


def test_the_membership_slice_gate_passes_a_sound_run_only():
    g0, g2 = _membership_ck()
    assert chip_smoke.check_membership_slices(g0, g2) == []
    broken = []
    g0, g2 = _membership_ck()
    del g0[1]["save"]["slices"]["g1.bin"]
    broken.append((g0, g2))
    g0, g2 = _membership_ck()
    g2[1]["restore"]["member_epoch"] = 2
    broken.append((g0, g2))
    g0, g2 = _membership_ck()
    g2[0]["adopted_at_start"] = [0, 1, 2, 4]
    broken.append((g0, g2))
    g0, g2 = _membership_ck()
    g2[1]["end"]["with_state"] = [1, 3, 4]
    broken.append((g0, g2))
    g0, g2 = _membership_ck()
    g2[0]["restore"]["optimizer_before_step"] = 12
    broken.append((g0, g2))
    g0, g2 = _membership_ck()
    del g2[0]["restore"]["slices"]["g4.bin"]
    broken.append((g0, g2))
    for args in broken:
        assert chip_smoke.check_membership_slices(*args), args


def test_the_one_sha1_gate_passes_a_sound_run_only():
    losses = [[7.5, 7.25, 7.0], [7.75, 7.5, 7.125]]

    def arms():
        out = {arm: [{"params": "ab12", "losses": list(losses[w])}
                     for w in (0, 1)] for arm in ("g0", "g1")}
        out["g2"] = [{"params": "ab12", "losses": [losses[w][2]]}
                     for w in (0, 1)]
        return out

    assert chip_smoke.check_one_sha1(arms()) == []
    bad = arms()
    bad["g2"][1]["params"] = "ab13"
    assert chip_smoke.check_one_sha1(bad)
    bad = arms()
    bad["g1"][0]["losses"][1] = 7.2500001
    assert chip_smoke.check_one_sha1(bad)
    bad = arms()
    bad["g2"][0]["losses"] = [7.25]
    assert chip_smoke.check_one_sha1(bad)
