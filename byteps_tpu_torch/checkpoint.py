"""Checkpoint and resume helpers (the port of ``byteps_tpu/checkpoint.py``:
``save_checkpoint`` at ``:60-83``, ``restore_checkpoint`` at ``:207-218``,
the sharded pair at ``:85-204``).

The reference leaves checkpoints to the frameworks and only guarantees a
consistent init and a stable name→key map across an elastic resume
(reference: SURVEY §5 checkpoint). The JAX package saves the whole train
state, the parameters, the optimizer state, the step and the declared
tensors of the name registry, so a resume continues bit for bit. So does
the port:

    state = trainer.state_dict()          # drains the cross-step tails
    save_checkpoint(path, state["model"], state["optimizer"],
                    step=state["step_count"], registry=gs.registry)
    params, opt, step, declared = restore_checkpoint(
        path, model.state_dict(), optimizer.state_dict())
    trainer.load_state_dict({"model": params, "optimizer": opt,
                             "step_count": step})

A checkpoint is a directory with the JAX package's layout:
``bps_meta.json``, ``{"step": ..., "declared": [...]}`` written as the
JAX package writes it (``json.dump``, the same keys, the declarations in
registry order), and the state file beside it, here ``state.pt``
(``torch.save`` of ``{"params": ..., "opt_state": ...}``) where the JAX
package has orbax's ``state`` directory. Neither package reads the
other's state file: orbax and JAX are not installed where the port runs,
and the JAX package has no reader of ``torch.save``. The state file is
written under a temporary name and renamed, then the meta the same way,
so a save cut short never leaves a meta beside a torn state.

``params`` is a ``{name: tensor}`` dict, as from ``model.state_dict()``;
``opt_state`` an optimizer's ``state_dict()``. Restored tensors land on
their template's device (a leaf the template lacks, such as the moments
of a fresh optimizer, stays on the CPU, where the optimizer's
``load_state_dict`` moves it to its parameter's device).

Sharded checkpoints (``BPS_SHARDED_UPDATE=1``): every worker holds the
optimizer state of its owned bucket groups only, so every worker calls
``save_sharded_checkpoint(path, trainer)`` at the same step boundary.
Each writes its owned groups' slices, ``opt_shard/s<step>/g<gi>.bin``
(``sharded_update.pack_opt_state`` frames, the membership handoff's
format; the JAX package's layout, so a slice of either package restores
into the other), each under a temporary name and renamed; worker 0 then
writes ``state.pt`` (``{"params": model.state_dict()}``) and last
``bps_meta.json``, ``{"step", "sharded": {"member_epoch", "world",
"live", "owner", "name", "groups"}}`` as the JAX package writes it. The
meta is the commit marker and names the step whose slice directory it
pairs with, so a re-save cut short leaves the committed meta and its
slices readable (the window between ``state.pt``'s rename and the
meta's is the JAX package's too). ``DistributedTrainer.restore_sharded``
reads it back before the first step; a feature-store ``embed=`` raises
(``server/embed.py`` is not ported: ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

_META = "bps_meta.json"
_STATE = "state.pt"
_SLICES = "opt_shard"
_EMBED = ("the feature store (server/embed.py) is not ported yet (see "
          "ROADMAP.md, 'Modules still to port', queue 1, item 8)")


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _meta(step: int, registry) -> dict:
    meta = {"step": step}
    if registry is not None:
        meta["declared"] = [
            {"name": d.name, "priority": d.priority,
             "kwargs": d.compression_kwargs}
            for d in (registry.get(n) for n in registry.declared_names())]
    return meta


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    step: int = 0, registry=None) -> None:
    """Save the train state; the registry's declarations ride along so
    name→key survives a restart (reference: the ReDeclareTensor replay).

    With gradient accumulation (``backward_passes_per_step=k``) save only
    at sync boundaries (``step % k == 0``): ``DistributedTrainer``'s
    ``state_dict()`` holds no accumulated gradient."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    _write_atomic(os.path.join(path, _STATE),
                  lambda p: torch.save(state, p))

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(_meta(step, registry), f)
    _write_atomic(os.path.join(path, _META), write_meta)


def _place(loaded, template, where: str):
    """``loaded`` with every tensor moved to the device of the template's
    tensor at the same place; a tensor the template lacks stays put."""
    if torch.is_tensor(loaded):
        if torch.is_tensor(template):
            if loaded.shape != template.shape:
                raise ValueError(f"checkpoint {where}: shape "
                                 f"{tuple(loaded.shape)}, the template's "
                                 f"{tuple(template.shape)}")
            return loaded.to(template.device)
        return loaded
    if isinstance(loaded, dict):
        t = template if isinstance(template, dict) else {}
        return {k: _place(v, t.get(k), f"{where}.{k}")
                for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        t = template if isinstance(template, (list, tuple)) else ()
        out = [_place(v, t[i] if i < len(t) else None, f"{where}[{i}]")
               for i, v in enumerate(loaded)]
        return type(loaded)(out)
    return loaded


def restore_checkpoint(path: str, params_like: Any,
                       opt_state_like: Any = None):
    """Restore into the given templates (``model.state_dict()``, an
    optimizer's ``state_dict()``). Returns ``(params, opt_state, step,
    declared)``; ``opt_state`` is None unless a template is given. The
    parameters must have the template's names and shapes."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, _STATE), map_location="cpu",
                       weights_only=True)
    params = state["params"]
    if isinstance(params_like, dict) and set(params) != set(params_like):
        raise ValueError(
            f"checkpoint {path}: parameters "
            f"{sorted(set(params) ^ set(params_like))} are in only one of "
            f"the checkpoint and the template")
    params = _place(params, params_like, "params")
    opt_state = None
    if opt_state_like is not None:
        opt_state = _place(state.get("opt_state"), opt_state_like,
                           "opt_state")
    return (params, opt_state, meta.get("step", 0),
            meta.get("declared", []))


def save_sharded_checkpoint(path: str, trainer, step: Optional[int] = None,
                            embed=None) -> None:
    """Save this worker's part of a sharded checkpoint (module docstring):
    the slices of its owned groups, then, on worker 0, the parameters and
    the meta. It drains the trainer first, so every tail and param frame
    of the steps before is in. Raises without an engaged sharded
    update."""
    if embed is not None:
        raise NotImplementedError(f"save_sharded_checkpoint(embed=): "
                                  f"{_EMBED}")
    st = getattr(trainer, "_sharded", None)
    chunked = getattr(trainer, "_chunked", None)
    if st is None or chunked is None or not chunked.decomposable:
        raise RuntimeError(
            "save_sharded_checkpoint needs an engaged sharded update "
            "(BPS_SHARDED_UPDATE=1, dp>1, at least one step run) — use "
            "save_checkpoint for the full-tree state")
    trainer.drain()
    from .sharded_update import pack_opt_state
    step_val = int(trainer.step_count if step is None else step)
    path = os.path.abspath(path)
    shard_dir = os.path.join(path, _SLICES, f"s{step_val}")
    os.makedirs(shard_dir, exist_ok=True)
    plan = st.plan
    for gi in plan.owned:
        blob = pack_opt_state(chunked.group_state(gi))
        tmp = os.path.join(shard_dir, f".g{gi}.bin.tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(shard_dir, f"g{gi}.bin"))
    if plan.rank != 0:
        return
    params = trainer._model.state_dict()
    _write_atomic(os.path.join(path, _STATE),
                  lambda p: torch.save({"params": params}, p))
    meta = {"step": step_val,
            "sharded": {"member_epoch": st.member_epoch,
                        "world": plan.world,
                        "live": sorted(plan.live),
                        "owner": list(plan.owner),
                        "name": st.name,
                        "groups": [list(g) for g in plan.groups]}}
    tmp = os.path.join(path, f".{_META}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, _META))


def restore_sharded_checkpoint(path: str, params_like: Any, embed=None):
    """Read a sharded checkpoint: ``(params, {group: slice bytes}, step,
    meta)``. Every slice of the committed step (the meta's) comes back,
    whoever saved it, so any worker may adopt any group; a slice for a
    group at or beyond the meta's group count is left out. ``params``
    as ``restore_checkpoint`` places them, against ``params_like``."""
    if embed is not None:
        raise NotImplementedError(f"restore_sharded_checkpoint(embed=): "
                                  f"{_EMBED}")
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if "sharded" not in meta:
        raise ValueError(
            f"{path} is not a sharded checkpoint (no membership meta) — "
            f"restore_checkpoint handles full-tree saves")
    params, _, _, _ = restore_checkpoint(path, params_like)
    shard_dir = os.path.join(path, _SLICES, f"s{meta.get('step', 0)}")
    n_groups = len(meta["sharded"].get("groups") or []) or None
    blobs = {}
    if os.path.isdir(shard_dir):
        for fn in sorted(os.listdir(shard_dir)):
            if fn.startswith("g") and fn.endswith(".bin"):
                gi = int(fn[1:-4])
                if n_groups is not None and gi >= n_groups:
                    continue
                with open(os.path.join(shard_dir, fn), "rb") as f:
                    blobs[gi] = f.read()
    return params, blobs, meta.get("step", 0), meta
