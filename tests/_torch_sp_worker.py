"""Worker of the port's sequence-parallel tests: one rank of a gloo
world on the CPU, joined through a FileStore.

    python _torch_sp_worker.py MODE RANK WORLD STORE INPUTS OUT

``Ranks`` starts a whole world of them from a test and collects their
outputs.

MODE "ring": ``ring_attention`` on a ``{"seq": WORLD}`` mesh. INPUTS holds
the whole q, k, v; the rank takes its sequence shard, runs each
(impl, causal) case with loss sum(o · (o + 1)) and saves its output and
gradient shards.

MODE "trainer": ``ShardedTrainer`` on the mesh INPUTS names (``data`` ×
``seq``), for BERT and GPT-2 at small width from the weights INPUTS
holds; 3 steps on the global batches INPUTS holds. Saves the losses, the
parameters after the steps and GPT-2's next-token targets of the first
batch's shard.

MODE "options": ``ShardedTrainer`` on the mesh INPUTS names, GPT-2 at
small width with the options INPUTS holds (``accum``:
``backward_passes_per_step``; ``onebit``: the README's compression;
``chunk``: ``lm_head_chunk``), one step on each global batch INPUTS
holds. Saves the losses and the parameters after the steps.

MODE "rs": the compressed exchange ``CompressionPlan(exchange="rs")``
over the world, for each compression case INPUTS names: 3 rounds of this
rank's rows of the gradients INPUTS holds. Saves each round's reduced
leaves and, after the rounds, every compressed bucket's per-shard and
merge states (flattened to their leaves).
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist  # noqa: E402

from byteps_tpu_torch.models import bert, gpt2  # noqa: E402
from byteps_tpu_torch.models.transformer import Transformer  # noqa: E402
from byteps_tpu_torch.optim import adamw  # noqa: E402
from byteps_tpu_torch.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from byteps_tpu_torch.parallel.ring import ring_attention  # noqa: E402
from byteps_tpu_torch.training import ShardedTrainer  # noqa: E402

WIDTH = dict(hidden=64, layers=2, heads=4, vocab_size=128, max_seq=64)


def run_ring(rank, world, z):
    mesh = make_mesh({"seq": world})
    q, k, v = (torch.from_numpy(z[n]) for n in ("q", "k", "v"))
    s = q.shape[1] // world
    sl = slice(rank * s, (rank + 1) * s)
    res = {}
    with use_mesh(mesh):
        for impl in ("flash", "naive"):
            for causal in (False, True):
                xs = [t[:, sl].clone().requires_grad_() for t in (q, k, v)]
                o = ring_attention(*xs, "seq", causal=causal, impl=impl)
                (o * (o + 1.0)).sum().backward()
                tag = f"{impl}_{int(causal)}"
                res[f"o_{tag}"] = o.detach().numpy()
                for n, x in zip("qkv", xs):
                    res[f"d{n}_{tag}"] = x.grad.numpy()
    return res


def run_trainer(rank, world, z):
    axes = {a: int(n) for a, n in zip(z["axes"], z["sizes"])}
    mesh = make_mesh(axes)
    res = {}
    for name in ("bert", "gpt2"):
        if name == "bert":
            cfg = bert.bert_config(dtype="float32", sp_axis="seq", **WIDTH)
            loss_fn = bert.mlm_loss     # the full head under sp_axis
            batches = list(zip(z["bert_tokens"], z["bert_targets"]))
        else:
            cfg = gpt2.gpt2_config(dtype="float32", sp_axis="seq", **WIDTH)
            loss_fn = gpt2.causal_lm_loss
            batches = list(z["gpt2_tokens"])
        model = Transformer(cfg)
        model.load_state_dict({k[len(name) + 3:]: torch.from_numpy(z[k])
                               for k in z.files
                               if k.startswith(f"{name}.p.")})
        tr = ShardedTrainer(loss_fn, model,
                            adamw(model.parameters(), float(z["lr"]),
                                  eps=float(z["eps"])),
                            mesh, device="cpu")
        res[f"{name}.losses"] = np.array([tr.step(b).item()
                                          for b in batches])
        for k, p in model.state_dict().items():
            res[f"{name}.p.{k}"] = p.numpy()
        if name == "gpt2":
            shard = torch.from_numpy(tr.shard_batch(batches[0]))
            with use_mesh(mesh):
                res["gpt2.targets"] = gpt2.next_token_targets(
                    shard, "seq").numpy()
    res["coords"] = np.array([mesh.ring(a).index for a in mesh.shape])
    return res


README_KW = {"compressor_type": "onebit", "compressor_onebit_scaling": "true",
             "ef_type": "vanilla", "momentum_type": "nesterov"}


def run_options(rank, world, z):
    axes = {a: int(n) for a, n in zip(z["axes"], z["sizes"])}
    mesh = make_mesh(axes)
    cfg = gpt2.gpt2_config(dtype="float32", sp_axis="seq",
                           lm_head_chunk=int(z["chunk"]), **WIDTH)
    model = Transformer(cfg)
    model.load_state_dict({k[len("gpt2.p."):]: torch.from_numpy(z[k])
                           for k in z.files if k.startswith("gpt2.p.")})
    tr = ShardedTrainer(gpt2.causal_lm_loss, model,
                        adamw(model.parameters(), float(z["lr"]),
                              eps=float(z["eps"])),
                        mesh, device="cpu",
                        partition_bytes=int(z["partition"]),
                        min_compress_bytes=int(z["min_compress"]),
                        backward_passes_per_step=int(z["accum"]),
                        compression=README_KW if int(z["onebit"]) else None)
    res = {"losses": np.array([tr.step(b).item() for b in z["gpt2_tokens"]])}
    for k, p in model.state_dict().items():
        res[f"p.{k}"] = p.numpy()
    return res


def _state_leaves(st, prefix, out):
    if isinstance(st, dict):
        for k in sorted(st):
            _state_leaves(st[k], f"{prefix}.{k}", out)
    elif isinstance(st, (list, tuple)):
        for i, v in enumerate(st):
            _state_leaves(v, f"{prefix}.{i}", out)
    else:
        out[prefix] = st.numpy()


def run_rs(rank, world, z):
    from byteps_tpu_torch.common.partition import LeafSpec
    from byteps_tpu_torch.ops.compression.reducer import CompressionPlan
    specs = [LeafSpec(f"l{i}", int(n), "float32")
             for i, n in enumerate(z["sizes"])]
    res = {}
    for case in z["cases"]:
        kw = dict(zip(z[f"{case}.keys"], z[f"{case}.values"]))
        plan = CompressionPlan(specs, int(z["partition"]), kw,
                               int(z["min_compress"]), world=world)
        st = plan.init_state()
        for r, rows in enumerate(z["grads"]):       # [rounds, world, total]
            flat = torch.from_numpy(rows[rank].copy())
            leaves = list(flat.split([s.size for s in specs]))
            st = plan.reduce(leaves, st, group=dist.group.WORLD)
            res[f"{case}.out{r}"] = flat.numpy().copy()
        for i, s in enumerate(st):
            if s != ():
                _state_leaves(s, f"{case}.state{i}", res)
    return res


class Ranks:
    """``world`` worker processes of ``mode`` on ``src``, started at once
    (the caller computes its reference meanwhile). ``result()`` waits at
    most ``timeout`` seconds for all of them, kills and reaps any left,
    raises with the log of a rank that failed, and returns each rank's
    outputs."""

    def __init__(self, mode: str, world: int, src, tmp) -> None:
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
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
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        z = np.load(src)
        run = {"ring": run_ring, "trainer": run_trainer, "rs": run_rs,
               "options": run_options}[mode]
        res = run(rank, world, z)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
