"""Worker of the port's BytePS API tests over gloo: one rank of a CPU world
joined through a FileStore, with ``bps.init()`` (``BPS_NUM_WORKER`` and
``BPS_WORKER_ID`` set per rank).

    python _torch_api_worker.py MODE RANK WORLD STORE INPUTS OUT

``Ranks`` starts a whole world of them from a test and collects their
outputs.

MODE "api": the top-level API on this rank's row of every array INPUTS
holds under ``tree.*``: ``push_pull`` with average on and off, three
``push_pull_async`` handles in flight synchronized in reverse order,
``broadcast_parameters`` from root 1, the plugin's
``broadcast_parameters`` and ``broadcast_optimizer_state`` from root 1
(a fresh optimizer on every rank, and one stepped on root only), and
plugin dispatches whose priorities differ between the ranks; then again
with ``BPS_SCHEDULING_CREDIT=4096``, saving how often dispatch waited.

MODE "plugin": BERT-tiny (fp32, naive attention, the weights INPUTS
holds) takes 3 steps on this rank's batches through the plugin's
``DistributedOptimizer``, ``DistributedDataParallel`` and ``CrossBarrier``
(AdamW), and one accumulation step through each of the first two
(``backward_passes_per_step=2``, ``no_sync``). Saves every gradient as
the hooks saw it and after the reduction, and the parameters at the end.
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import byteps_tpu_torch as bps  # noqa: E402
import byteps_tpu_torch.torch as bt  # noqa: E402
from byteps_tpu_torch.models import bert  # noqa: E402
from byteps_tpu_torch.parallel.collectives import tree_flatten  # noqa: E402

TINY = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=64)
SEQ, ROWS, MAX_PRED, LR, EPS = 64, 2, 10, 1e-3, 1e-6


def _init(rank, world, store):
    os.environ.update(BPS_NUM_WORKER=str(world), BPS_WORKER_ID=str(rank))
    bps.init(device="cpu", init_method="file://" + store,
             timeout=datetime.timedelta(seconds=60))


def _row_tree(z, rank):
    """This rank's tree: {name: row} of the ``tree.<name>`` arrays."""
    return {k[5:]: torch.from_numpy(np.ascontiguousarray(z[k][rank]))
            for k in z.files if k.startswith("tree.")}


def _save_tree(res, prefix, tree):
    paths, leaves, _ = tree_flatten(tree)
    for p, t in zip(paths, leaves):
        res[prefix + p] = t.detach().numpy()


def _optim_state(opt):
    return {f"{pid}.{k}": (v.numpy() if torch.is_tensor(v) else np.array(v))
            for pid, st in opt.state_dict()["state"].items()
            for k, v in st.items()}


def run_api(rank, world, store, z):
    res = {}
    _init(rank, world, store)
    tree = _row_tree(z, rank)
    _save_tree(res, "mean", bps.push_pull(tree, name="g"))
    _save_tree(res, "sum", bps.push_pull(tree, average=False, name="g"))
    handles = [bps.push_pull_async(tree, average=avg, name=f"h{i}")
               for i, avg in enumerate((True, False, True))]
    for i, h in reversed(list(enumerate(handles))):
        _save_tree(res, f"async{i}", bps.synchronize(h))
    _save_tree(res, "bcast", bps.broadcast_parameters(tree, root_rank=1))

    # the plugin's in-place broadcasts from root 1
    params = {k: v.clone() for k, v in tree.items()}
    bt.broadcast_parameters(params, root_rank=1)
    _save_tree(res, "pbcast", params)
    torch.manual_seed(rank)
    lin = torch.nn.Linear(5, 3)
    fresh = torch.optim.AdamW(lin.parameters(), lr=0.1)
    bt.broadcast_optimizer_state(fresh, root_rank=1)
    for k, v in _optim_state(fresh).items():
        res[f"fresh.{k}"] = v
    res["fresh_params"] = np.concatenate(
        [p.detach().numpy().ravel() for p in lin.parameters()])
    stepped = torch.optim.AdamW(lin.parameters(), lr=0.1)
    if rank == 1:
        lin(torch.randn(4, 5)).sum().backward()
        stepped.step()
        for k, v in _optim_state(stepped).items():
            res[f"root_state.{k}"] = v
    bt.broadcast_optimizer_state(stepped, root_rank=1)
    for k, v in _optim_state(stepped).items():
        res[f"stepped.{k}"] = v

    # priorities that differ between the ranks: the collectives still go
    # out in dispatch order, so the sums match
    names = sorted(tree)
    hs = [bt.push_pull_async(tree[n], average=False, name=f"p.{n}",
                             priority=(i if rank == 0 else -i))
          for i, n in enumerate(names)]
    for n, h in zip(names, hs):
        res[f"prio.{n}"] = bt.synchronize(h).numpy()
    bps.shutdown()

    # again under a credit of 4096 bytes
    os.environ["BPS_SCHEDULING_CREDIT"] = "4096"
    _init(rank, world, store + ".credit")
    waits = bps.get_metrics().stage("CREDIT_BLOCK")
    before = waits.count
    _save_tree(res, "credit", bps.push_pull(tree, name="c"))
    hs = [bt.push_pull_async(tree[n], average=True, name=f"q.{n}")
          for n in names]
    for n, h in zip(names, hs):
        res[f"credit_plugin.{n}"] = bt.synchronize(h).numpy()
    res["credit_waits"] = np.array(waits.count - before)
    bps.shutdown()
    return res


# ------------------------------------------------------------ the plugin

def _model(z):
    model = bert.Transformer(bert.bert_config(dtype="float32",
                                              attn_impl="naive", **TINY))
    model.load_state_dict({k[2:]: torch.from_numpy(z[k])
                           for k in z.files if k.startswith("p.")})
    return model


def _loss(model, z, rank, step):
    batch = (torch.from_numpy(z["tokens"][rank, step]),
             torch.from_numpy(z["targets"][rank, step]))
    return bert.mlm_loss(model, batch, max_predictions=MAX_PRED)


def _capture(model, seen):
    """A hook ahead of the wrapper's: each parameter's gradient as the
    wrapper's hook will read it."""
    for n, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, n=n: seen.__setitem__(n, p.grad.detach().clone()))


def _adamw(params):
    return torch.optim.AdamW(params, lr=LR, eps=EPS, weight_decay=1e-4)


class _Through:
    """The wrapped model's attributes (the loss reads its config and
    head), its forward through the ``DistributedDataParallel`` wrapper."""

    def __init__(self, ddp):
        self._ddp = ddp

    def __call__(self, *args, **kwargs):
        return self._ddp(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._ddp.module, name)


def _save_grads(res, tag, model, seen):
    for n, p in model.named_parameters():
        res[f"{tag}.raw.{n}"] = seen[n].numpy()
        res[f"{tag}.synced.{n}"] = p.grad.detach().numpy().copy()


def run_plugin(rank, world, store, z):
    res = {}
    _init(rank, world, store)
    steps = z["tokens"].shape[1] - 1       # the last batch: accumulation

    # DistributedOptimizer
    model, seen = _model(z), {}
    _capture(model, seen)
    opt = bt.DistributedOptimizer(_adamw(model.parameters()),
                                  named_parameters=model.named_parameters())
    bt.broadcast_parameters(model.state_dict(), root_rank=0)
    bt.broadcast_optimizer_state(opt, root_rank=0)
    for s in range(steps):
        opt.zero_grad()
        _loss(model, z, rank, s).backward()
        opt.synchronize()
        _save_grads(res, f"opt{s}", model, seen)
        with opt.skip_synchronize():
            opt.step()
    _save_tree(res, "opt.params", dict(model.named_parameters()))
    # two backward passes a step: the gradients sum, then one sync
    opt.set_backward_passes_per_step(2)
    opt.zero_grad()
    for s in (0, steps):
        _loss(model, z, rank, s).backward()
    opt.synchronize()
    _save_grads(res, "opt_acc", model, seen)

    # DistributedDataParallel: synced when backward returns
    model, seen = _model(z), {}
    _capture(model, seen)
    ddp = _Through(bt.DistributedDataParallel(model))
    dopt = _adamw(model.parameters())
    for s in range(steps):
        dopt.zero_grad()
        _loss(ddp, z, rank, s).backward()
        ddp._ddp.synchronize()        # parameters no loss reaches
        _save_grads(res, f"ddp{s}", model, seen)
        dopt.step()
    _save_tree(res, "ddp.params", dict(model.named_parameters()))
    dopt.zero_grad()
    with ddp._ddp.no_sync():
        _loss(ddp, z, rank, 0).backward()
    _loss(ddp, z, rank, steps).backward()
    ddp._ddp.synchronize()
    _save_grads(res, "ddp_acc", model, seen)

    # CrossBarrier: updates applied by its poller as reductions land
    model = _model(z)
    opt = bt.DistributedOptimizer(_adamw(model.parameters()),
                                  named_parameters=model.named_parameters())
    cb = bt.CrossBarrier(model, opt, num_steps=steps)
    for s in range(steps):
        cb.zero_grad()
        _loss(model, z, rank, s).backward()
        cb.step()
    cb.close()
    _save_tree(res, "cb.params", dict(model.named_parameters()))
    bps.shutdown()
    return res


class Ranks:
    """``world`` worker processes of ``mode`` on ``src``, started at once
    (the caller computes its reference meanwhile). ``result()`` waits at
    most ``timeout`` seconds for all of them, kills and reaps any left,
    raises with the log of a rank that failed, and returns each rank's
    outputs."""

    def __init__(self, mode: str, world: int, src, tmp) -> None:
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
        for k in ("BPS_ENABLE_PS", "BPS_COMPRESS", "BPS_SCHEDULING_CREDIT",
                  "BPS_COORDINATOR_ADDRESS", "BPS_SERVER_ADDRS"):
            env.pop(k, None)
        env["BPS_PARTITION_BYTES"] = str(64 << 10)
        self._outs = [Path(tmp) / f"{mode}{world}.{r}.npz"
                      for r in range(world)]
        store = Path(tmp) / f"{mode}{world}.store"
        self._procs = [subprocess.Popen(
            [sys.executable, __file__, mode, str(r), str(world), str(store),
             str(src), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r, out in enumerate(self._outs)]
        self._res = None

    def result(self, timeout: float = 120):
        if self._res is None:
            try:
                logs = [p.communicate(timeout=timeout)[0]
                        for p in self._procs]
            finally:
                self.close()
            for r, (p, log) in enumerate(zip(self._procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                       f"{log}")
            self._res = [dict(np.load(o)) for o in self._outs]
        return self._res

    def close(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
            if p.stdout is not None:
                p.stdout.close()


def main():
    mode, rank, world, store, src, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    z = np.load(src)
    res = (run_api if mode == "api" else run_plugin)(rank, world, store, z)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
