"""Shared set-up of the sharded-update tests (``test_torch_sharded_update.py``,
``test_torch_sharded_update_jax.py``): ``dp`` port trainers in threads, each
with its own ``RemotePSBackend`` connection pool, against one standalone
server in this process: the deployment's shape, one socket pool a worker.
The chain MLP is ``tests/test_sharded_update.py``'s, its weights and
batches made with numpy from that file's seeds."""

import contextlib
import os
import threading
import time

import numpy as np
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.obs.metrics import get_registry
from byteps_tpu_torch.server.engine import PSServer
from byteps_tpu_torch.server.transport import (PSTransportServer,
                                               RemotePSBackend)
from byteps_tpu_torch.training import DistributedTrainer

WAIT = 60.0          # seconds a worker thread may take
ENV = ("BPS_WORKER_ID", "DMLC_WORKER_ID", "BPS_NUM_WORKER",
       "DMLC_NUM_WORKER", "BPS_ENABLE_PS", "BYTEPS_ENABLE_PS",
       "BPS_SERVER_ADDRS", "BPS_SHARDED_UPDATE", "BPS_SHARD_RANK",
       "BPS_SHARD_WORLD", "BPS_CROSS_STEP", "BPS_BWD_STAGED",
       "BPS_APPLY_CHUNKED", "BPS_PS_CONNS", "BPS_PARAM_TIMEOUT_MS",
       "BPS_WATCHDOG_SEC", "BPS_COMPRESS", "BPS_COMPRESS_EF",
       "BPS_COMPRESS_DEVICE", "BPS_MIN_COMPRESS_BYTES",
       "BPS_PARTITION_BYTES", "BPS_PS_PIPELINE", "BPS_SCHEDULING_CREDIT")


@contextlib.contextmanager
def env(**kv):
    """Set ``kv`` (and clear the other knobs of ``ENV``) for the block."""
    saved = {k: os.environ.get(k) for k in set(ENV) | set(kv)}
    try:
        for k in ENV:
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in kv.items()})
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the chain MLP of tests/test_sharded_update.py --------------------------

def chain_params(depth=4, dim=96, seed=3):
    rng = np.random.RandomState(seed)
    return {f"w{i}": (rng.randn(dim, dim) / 12).astype(np.float32)
            for i in range(depth)}


def chain_batches(dim, seed, n, bs=32):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = r.randn(bs, dim).astype(np.float32)
        out.append((x, np.tanh(x)))
    return out


class Chain(torch.nn.Module):
    def __init__(self, params) -> None:
        super().__init__()
        self.depth = len(params)
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(np.array(v))))

    def forward(self, x):
        h = x
        for i in range(self.depth):
            h = torch.tanh(h @ getattr(self, f"w{i}"))
        return h


def chain_loss(m, b):
    x, y = b
    return ((m(x) - y) ** 2).mean()


class SlowPulls:
    """A backend proxy whose gradient pulls sleep first, so a round's pulls
    (and the param frames behind them) are still out when the next round's
    pushes arrive: two rounds in flight."""

    def __init__(self, inner, delay=0.04) -> None:
        self._inner = inner
        self._delay = delay

    def pull(self, key, out, round=0, timeout_ms=None):
        time.sleep(self._delay)
        return self._inner.pull(key, out, round=round, timeout_ms=timeout_ms)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def adam(ps):
    return torch.optim.Adam(ps, lr=1e-3)


def run_port_arm(make_model, loss_fn, worker_batches, *, dp, sharded,
                 name, partition_bytes, steps, cross="0", staged="1",
                 optimizer=adam, conns=8, slow_pulls=0.0, codec="none",
                 expect_engaged=None, extra_env=None):
    """``dp`` port trainers (threads) over one port server on TCP, each
    with its own connection pool. Returns (per-worker final parameters as
    numpy in the flat order, per-worker losses, the registry's snapshot,
    per-worker (owned groups, groups with optimizer state))."""
    eng = PSServer(num_workers=dp, engine_threads=2)
    srv = PSTransportServer(eng, host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{srv.port}"
    privs = []
    with env(BPS_ENABLE_PS=1, BPS_NUM_WORKER=dp, BPS_SERVER_ADDRS=addr,
             BPS_SHARDED_UPDATE=sharded, BPS_CROSS_STEP=cross,
             BPS_BWD_STAGED=staged, BPS_PS_CONNS=conns, BPS_COMPRESS=codec,
             **(extra_env or {})):
        try:
            bps.init(device="cpu")
            get_registry().reset()
            trs = []
            for w in range(dp):
                model = make_model()
                tr = DistributedTrainer(loss_fn, model,
                                        optimizer(model.parameters()),
                                        device="cpu",
                                        partition_bytes=partition_bytes,
                                        name=name, shard_rank=w)
                priv = RemotePSBackend([addr], conns_per_shard=conns)
                tr.ps_exchange.backend = (SlowPulls(priv, slow_pulls)
                                          if slow_pulls else priv)
                privs.append(priv)
                trs.append(tr)
            errs, losses = [], [[] for _ in range(dp)]

            def run(w):
                try:
                    for b in worker_batches[w][:steps]:
                        losses[w].append(trs[w].step(b).item())
                    trs[w].drain()
                except BaseException as e:   # noqa: BLE001 — asserted
                    errs.append((w, e))

            ts = [threading.Thread(target=run, args=(w,), daemon=True)
                  for w in range(dp)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WAIT)
            assert not any(t.is_alive() for t in ts), \
                "workers hung: " + repr([tr.ps_exchange.debug_state()
                                         for tr in trs])
            assert not errs, errs
            engaged = (sharded == "1" and dp > 1 if expect_engaged is None
                       else expect_engaged)
            owned = []
            for tr in trs:
                assert (tr._sharded is not None) == engaged, \
                    f"sharded engaged: want {engaged}"
                owned.append((set(tr._sharded.plan.owned) if engaged
                              else None,
                              set(tr._chunked.groups_with_state())
                              if tr._chunked is not None else None))
            finals = [[p.detach().numpy().copy() for _, p in tr._ps_params]
                      for tr in trs]
            snap = get_registry().snapshot()
            for tr in trs:
                tr.close()
            return finals, losses, snap, owned
        finally:
            bps.shutdown()
            for p in privs:
                p.close()
            srv.close()
            eng.close()


def _in_threads(fns, what):
    """Run ``fns`` (one a worker) in threads; raise a worker's failure or
    a hang past ``WAIT``."""
    errs = []

    def run(w, fn):
        try:
            fn()
        except BaseException as e:   # noqa: BLE001 — asserted
            errs.append((w, e))

    ts = [threading.Thread(target=run, args=(w, fn), daemon=True)
          for w, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    assert not any(t.is_alive() for t in ts), f"{what}: a worker hung"
    assert not errs, errs


def state_bytes(tr):
    """The bytes of a trainer's optimizer-state tensors."""
    return sum(t.numel() * t.element_size() for s in tr._tx.state.values()
               for t in s.values() if torch.is_tensor(t))


def run_phased(make_model, loss_fn, worker_batches, phases, *, name,
               dp=2, cross="0", optimizer=adam, partition_bytes=8 << 10,
               conns=8, restore=None, save=None, start=0,
               handoff_timeout_ms=20000):
    """``dp`` port trainers (threads) over one port server on TCP, the
    shape of the JAX package's ``_phased_rig``: ``phases`` is ``[(steps,
    live)]``, and before a phase whose ``live`` is not None every worker
    calls ``reshard(live)`` at once (publish before fetch on each). With
    ``restore`` each trainer restores that sharded checkpoint before its
    first step; with ``save`` each saves one there after the last phase,
    worker 0 last. Worker ``w`` steps on ``worker_batches[w][start:]``.
    Returns a dict: ``finals`` (per-worker parameters as numpy in the flat
    order), ``owned``, ``with_state``, ``owner``, ``member_epoch``,
    ``state_bytes`` (per worker at the end), ``reshards`` (per reshard
    phase, each worker's result), ``metas`` (the restores')."""
    eng = PSServer(num_workers=dp, engine_threads=2)
    srv = PSTransportServer(eng, host="127.0.0.1", port=0)
    addr = f"127.0.0.1:{srv.port}"
    privs, out = [], {"reshards": [], "metas": []}
    with env(BPS_ENABLE_PS=1, BPS_NUM_WORKER=dp, BPS_SERVER_ADDRS=addr,
             BPS_SHARDED_UPDATE=1, BPS_CROSS_STEP=cross, BPS_PS_CONNS=conns):
        try:
            bps.init(device="cpu")
            get_registry().reset()
            trs = []
            for w in range(dp):
                model = make_model()
                tr = DistributedTrainer(loss_fn, model,
                                        optimizer(model.parameters()),
                                        device="cpu",
                                        partition_bytes=partition_bytes,
                                        name=name, shard_rank=w)
                priv = RemotePSBackend([addr], conns_per_shard=conns)
                tr.ps_exchange.backend = priv
                privs.append(priv)
                trs.append(tr)
            if restore is not None:
                out["metas"] = [tr.restore_sharded(restore) for tr in trs]
            done = start
            for steps, live in phases:
                if live is not None:
                    res = [None] * dp

                    def rs(w, live=live, res=res):
                        res[w] = trs[w].reshard(
                            live, handoff_timeout_ms=handoff_timeout_ms)
                    _in_threads([lambda w=w: rs(w) for w in range(dp)],
                                "reshard")
                    owners = {tuple(tr._sharded.plan.owner) for tr in trs}
                    assert len(owners) == 1, \
                        f"reshard diverged across ranks: {owners}"
                    out["reshards"].append(res)

                def run(w, s=done, n=steps):
                    for i in range(n):
                        trs[w].step(worker_batches[w][s + i])
                    trs[w].drain()
                _in_threads([lambda w=w: run(w) for w in range(dp)],
                            "steps")
                done += steps
            if save is not None:
                from byteps_tpu_torch.checkpoint import \
                    save_sharded_checkpoint
                for tr in reversed(trs):
                    save_sharded_checkpoint(save, tr)
            for tr in trs:
                assert tr._sharded is not None, \
                    "the sharded update fell back"
            out.update(
                finals=[[p.detach().numpy().copy() for _, p in tr._ps_params]
                        for tr in trs],
                owned=[set(tr._sharded.plan.owned) for tr in trs],
                with_state=[set(tr._chunked.groups_with_state())
                            for tr in trs],
                owner=[list(tr._sharded.plan.owner) for tr in trs],
                member_epoch=[tr._sharded.member_epoch for tr in trs],
                state_bytes=[state_bytes(tr) for tr in trs])
            for tr in trs:
                tr.close()
            return out
        finally:
            bps.shutdown()
            for p in privs:
                p.close()
            srv.close()
            eng.close()
