"""Worker process of the remote-PS tests: one of the independent worker
processes that meet only at standalone servers over TCP, the BytePS
deployment (``BPS_ENABLE_PS=1``, ``BPS_NUM_WORKER``, ``BPS_WORKER_ID``;
no process group).

    python _torch_ps_remote_worker.py MODE WID ADDRS OUT [INPUTS]

ADDRS is ``codec=host:port,...`` for the trainer modes (one server a codec;
a codec may carry a tag, ``int8@off``, so two servers run one codec) and
``host:port`` for "plugin". Prints ``WORKER_OK`` at the end.

MODE "port": the port's ``DistributedTrainer`` on the small BERT of
``test_torch_ps_trainer.py`` (the weights INPUTS holds, from
``convert.params_from_jax``) takes STEPS steps on this worker's batches
(seed WID) on the default PS route, once a codec; saves the losses, the
parameters in the JAX tree's layout and the count of compressed buckets
(``torch.save``).

MODE "jax": the same with the JAX package's trainer (weights from
``init_params(PRNGKey(0))``, a one-device mesh; the JAX staged head reads
``jax.core.Var``, which jax 0.9 lacks, so it runs the streamed tail without
the staged head and the cross-step driver: the routes give the same bits).
Both JAX workers declare their keys and meet at a file barrier before the
first step: the JAX server's fused front resets a key at every
declaration, so a declaration landing after the other worker's first push
would wedge the round (ROADMAP.md queue 3; the port's server keeps it).

MODE "lag": bounded staleness at world 2 (``BPS_MAX_LAG=2``; the server
runs with ``BPS_LAG_GRACE_MS=0``): the port's trainer on the default route,
STEPS steps, with a scripted order kept by files beside OUT. Each
worker's round-1 pulls wait until the other pushed its whole round 1, so
round 1 completes: at grace 0 a pull that seals round 1 before the other
worker's first push of that key makes that worker take the server's round
as its seed (the elastic-rejoin adopt) and join at round 2, and the two
would apply different rounds. Worker 1 holds its round-2 pushes until
worker 0 pulled its whole round 2, which the server therefore seals
without worker 1; worker 1's round 2 then late-folds into round 3. Saves
the losses, the parameters' bytes and the verdicts it counted.

MODE "async": async PS at world 2 (``BPS_ENABLE_ASYNC=1``, an async
server; ``BPS_ASYNC_WIRE_DTYPE`` as the caller set it): the port's trainer,
STEPS steps, the two workers' pushes in a scripted order kept by files
beside OUT: worker 0's step 1, worker 1's step 1, worker 0's step 2, ...
each worker pushing a step's deltas only once the other has pushed its
previous turn's. Saves the keys, its initial weights a key and the host
copy of every delta it pushed (the dtype's name and the bytes), a step at
a time.

MODE "plugin": the assertions of ``tests/_ps_worker.py`` on the port's API
(``push_pull`` averages to 2.5 and sums to 10.0; async handles synchronized
in a divergent order), through the top-level API and the torch plugin,
then the plugin's ``broadcast_parameters`` from root 0 and one
``DistributedOptimizer`` step; saves what it read.
"""

import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WIDTH = dict(hidden=128, layers=2, heads=4, vocab_size=512, max_seq=64)
SEQ, BATCH, MAX_PRED, LR, EPS, STEPS = 64, 4, 10, 1e-3, 1e-6, 3


def _addrs(spec):
    return dict(kv.split("=", 1) for kv in spec.split(","))


def _batch(wid, step):
    from byteps_tpu_torch.models import bert as tbert
    return tbert.synth_mlm_batch(np.random.RandomState(100 * wid + step),
                                 BATCH, SEQ, WIDTH["vocab_size"])


def run_port(wid, addrs, out, inputs):
    import torch
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    import byteps_tpu_torch as bps
    from byteps_tpu_torch import convert
    from byteps_tpu_torch.models import bert as tbert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    state = torch.load(inputs)
    res = {}
    for codec, addr in _addrs(addrs).items():
        os.environ.update(BPS_COMPRESS=codec.split("@")[0],
                          BPS_SERVER_ADDRS=addr)
        bps.init(device="cpu")
        model = tbert.Transformer(tbert.bert_config(dtype="float32",
                                                    **WIDTH))
        model.load_state_dict(state)
        tt = DistributedTrainer(
            lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED),
            model, adamw(model.parameters(), LR, eps=EPS), device="cpu")
        losses = [tt.step(_batch(wid, i)).item() for i in range(STEPS)]
        tt.drain()
        res[codec] = (losses, convert.params_to_jax_layout(tt.model),
                      tt.ps_exchange.n_compressed())
        tt.close()
        bps.shutdown()
    torch.save(res, out)


def _wait_file(path, timeout=120.0):
    import time
    deadline = time.time() + timeout
    while not Path(path).exists():
        if time.time() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.01)


def run_lag(wid, addr, out, inputs):
    import threading
    from collections import Counter

    import torch
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import bert as tbert
    from byteps_tpu_torch.obs.metrics import get_registry
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    os.environ.update(BPS_COMPRESS="none", BPS_SERVER_ADDRS=addr,
                      BPS_MAX_LAG="2")
    bps.init(device="cpu")
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH))
    model.load_state_dict(torch.load(inputs))
    tt = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED),
        model, adamw(model.parameters(), LR, eps=EPS), device="cpu")
    ex = tt.ps_exchange
    ex.leaf_groups(tt._ps_params, name=tt._name)        # the plan
    (_, keyed), = ex._plans.values()
    nkeys = len(keyed)
    assert all(ex._lag_routes(k) for k, _ in keyed)
    base = str(out)[:-len(f"{wid}.out")]
    be = ex.backend
    real_push, real_pull = be.push_lag, be.pull_lag
    lock = threading.Lock()
    pushed, pulled = Counter(), Counter()

    def tick(count, what, rnd):
        with lock:
            count[rnd] += 1
            done = count[rnd] == nkeys
        if done:
            Path(f"{base}w{wid}.{what}.{rnd}").touch()

    def push_lag(key, worker, rnd, data):
        if wid == 1 and rnd == 2:
            _wait_file(f"{base}w0.pulled.2")
        real_push(key, worker, rnd, data)
        tick(pushed, "pushed", rnd)

    def pull_lag(key, worker, rnd, out_, timeout_ms=None):
        if rnd == 1:
            _wait_file(f"{base}w{1 - wid}.pushed.1")
        flags = real_pull(key, worker, rnd, out_, timeout_ms)
        tick(pulled, "pulled", rnd)
        return flags

    be.push_lag, be.pull_lag = push_lag, pull_lag
    losses = [tt.step(_batch(wid, i)).item() for i in range(STEPS)]
    tt.drain()
    reg = get_registry()
    res = {"losses": losses,
           "params": b"".join(p.detach().numpy().tobytes()
                              for _, p in tt._ps_params),
           "verdicts": {n: reg.counter(f"ps/lag_{n}").value
                        for n in ("complete", "stale", "barrier")},
           "nkeys": nkeys}
    tt.close()
    bps.shutdown()
    torch.save(res, out)


def run_async(wid, addr, out, inputs):
    import torch
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common import bf16
    from byteps_tpu_torch.models import bert as tbert
    from byteps_tpu_torch.optim import adamw
    from byteps_tpu_torch.training import DistributedTrainer
    os.environ.update(BPS_ENABLE_ASYNC="1", BPS_SERVER_ADDRS=addr)
    bps.init(device="cpu")
    model = tbert.Transformer(tbert.bert_config(dtype="float32", **WIDTH))
    model.load_state_dict(torch.load(inputs))
    tt = DistributedTrainer(
        lambda m, b: tbert.mlm_loss(m, b, max_predictions=MAX_PRED),
        model, adamw(model.parameters(), LR, eps=EPS), device="cpu")
    w = tt._async_worker
    init = [p.detach().numpy().reshape(-1).copy() for _, p in tt._ps_params]
    nkeys = len(w.keys)
    base = str(out)[:-len(f"{wid}.out")]
    be = w.backend
    real_push = be.push
    pushed = []               # per step: (dtype name, bytes) a key

    def push(key, data):
        n = sum(len(s) for s in pushed)
        turn = 2 * (n // nkeys) + wid
        if n % nkeys == 0:
            if turn:
                _wait_file(f"{base}turn.{turn - 1}")
            pushed.append([])
        real_push(key, data)
        pushed[-1].append((bf16.dtype_name(data),
                           np.ascontiguousarray(data).tobytes()))
        if len(pushed[-1]) == nkeys:
            Path(f"{base}turn.{turn}").touch()

    be.push = push
    losses = [tt.step(_batch(wid, i)).item() for i in range(STEPS)]
    res = {"losses": losses, "keys": list(w.keys), "init": init,
           "pushed": pushed}
    tt.close()
    bps.shutdown()
    torch.save(res, out)


def run_jax(wid, addrs, out, inputs):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import optax
    import torch

    import byteps_tpu as jbps
    from byteps_tpu.models import bert as jbert
    from byteps_tpu.models import transformer as jtr
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu.training import DistributedTrainer as JaxTrainer
    jcfg = jbert.bert_config(dtype="float32", attn_impl="naive", **WIDTH)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    res = {}
    for codec, addr in _addrs(addrs).items():
        os.environ.update(BPS_COMPRESS=codec.split("@")[0],
                          BPS_SERVER_ADDRS=addr)
        mesh = make_mesh({"data": 1}, devices=jax.devices()[:1])
        jbps.init(mesh=mesh)
        jt = JaxTrainer(lambda p, b: jbert.mlm_loss(p, jcfg, b,
                                                    max_predictions=MAX_PRED),
                        jp, optax.adamw(LR, eps=EPS), mesh=mesh)
        jt._ps_exchange.leaf_groups(jt.params, name=jt._name)
        _barrier(out, wid, codec)
        losses = [float(jt.step(_batch(wid, i))) for i in range(STEPS)]
        res[codec] = (losses, jax.tree.map(np.asarray, jt.params))
        jbps.shutdown()
    torch.save(res, out)


def _barrier(out, wid, tag, timeout=120.0):
    """Wait, bounded, until the other worker wrote its ready file."""
    import time
    Path(f"{out}.{tag}.ready").touch()
    peer = Path(f"{out[:-len(f'{wid}.out')]}{1 - wid}.out.{tag}.ready")
    deadline = time.time() + timeout
    while not peer.exists():
        if time.time() > deadline:
            raise TimeoutError(f"worker {1 - wid} never reached the barrier")
        time.sleep(0.05)


def run_plugin(wid, addr, out):
    import torch
    torch.set_num_threads(1)
    os.environ["BPS_SERVER_ADDRS"] = addr
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as bt
    res = {}
    bps.init(device="cpu")
    assert bt.size() == 2 and bt.rank() == wid, (bt.size(), bt.rank())
    # the JAX worker's local means and sums, one tensor a worker here
    mean = bps.push_pull({"t": torch.full((64,), 2.0 + wid)}, average=True,
                         name="grads")["t"]
    total = bps.push_pull({"t": torch.full((64,), 4.0 + 2 * wid)},
                          average=False, name="grads")["t"]
    res["api_mean"], res["api_sum"] = mean.numpy(), total.numpy()
    a = {"t": torch.full((32,), 2.0 + 2 * wid)}
    b = {"t": torch.full((32,), 10.0 + 2 * wid)}
    ha = bps.push_pull_async(a, average=False, name="async_a")
    hb = bps.push_pull_async(b, average=False, name="async_b")
    first, second = (hb, ha) if wid == 0 else (ha, hb)
    out_first, out_second = bps.synchronize(first), bps.synchronize(second)
    oa = out_second if wid == 0 else out_first
    ob = out_first if wid == 0 else out_second
    res["api_async_a"], res["api_async_b"] = oa["t"].numpy(), ob["t"].numpy()
    # the plugin: the same through its dispatcher's pool
    res["plugin_mean"] = bt.push_pull(torch.full((64,), 2.0 + wid),
                                      average=True, name="p.mean").numpy()
    res["plugin_sum"] = bt.push_pull(torch.full((64,), 4.0 + 2 * wid),
                                     average=False, name="p.sum").numpy()
    ha = bt.push_pull_async(torch.full((32,), 2.0 + 2 * wid), average=False,
                            name="p.async_a")
    hb = bt.push_pull_async(torch.full((32,), 10.0 + 2 * wid),
                            average=False, name="p.async_b")
    order = (hb, ha) if wid == 0 else (ha, hb)
    got = {h: bt.synchronize(h) for h in order}
    res["plugin_async_a"], res["plugin_async_b"] = (got[ha].numpy(),
                                                    got[hb].numpy())
    # broadcast from root 0 and one averaged optimizer step
    torch.manual_seed(wid)
    model = torch.nn.Linear(8, 4)
    bt.broadcast_parameters(model.state_dict(), root_rank=0)
    res["bcast"] = torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()]).numpy()
    opt = bt.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters())
    x = torch.full((2, 8), 1.0 + wid)
    model(x).sum().backward()
    opt.step()
    res["grads"] = torch.cat([p.grad.reshape(-1)
                              for p in model.parameters()]).numpy()
    res["stepped"] = torch.cat([p.detach().reshape(-1)
                                for p in model.parameters()]).numpy()
    bps.shutdown()
    np.savez(out, **res)


def main():
    mode, wid, addrs, out = sys.argv[1:5]
    inputs = sys.argv[5] if len(sys.argv) > 5 else None
    wid = int(wid)
    os.environ.update(BPS_ENABLE_PS="1", BPS_NUM_WORKER="2",
                      BPS_WORKER_ID=str(wid))
    if mode == "port":
        run_port(wid, addrs, out, inputs)
    elif mode == "jax":
        run_jax(wid, addrs, out, inputs)
    elif mode == "lag":
        run_lag(wid, addrs, out, inputs)
    elif mode == "async":
        run_async(wid, addrs, out, inputs)
    else:
        run_plugin(wid, addrs, out)
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
