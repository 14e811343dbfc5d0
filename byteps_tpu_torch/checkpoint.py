"""Checkpoint and resume helpers (the port of the full-tree half of
``byteps_tpu/checkpoint.py``: ``save_checkpoint`` at ``:60-83``,
``restore_checkpoint`` at ``:207-218``).

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

The sharded checkpoints of ``BPS_SHARDED_UPDATE=1``
(``save_sharded_checkpoint``, ``restore_sharded_checkpoint``) are not
ported yet and raise (ROADMAP.md, queue 1, item 6, "What the sharded
update leaves").
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

_META = "bps_meta.json"
_STATE = "state.pt"
_SHARDED = ("is not ported yet (see ROADMAP.md, 'Modules still to port', "
            "queue 1, item 6, 'What the sharded update leaves')")


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
    """The sharded update's per-replica checkpoint: not ported."""
    raise NotImplementedError(f"save_sharded_checkpoint (sharded "
                              f"checkpoints of BPS_SHARDED_UPDATE=1) "
                              f"{_SHARDED}")


def restore_sharded_checkpoint(path: str, params_like: Any, embed=None):
    """The sharded update's per-replica restore: not ported."""
    raise NotImplementedError(f"restore_sharded_checkpoint (sharded "
                              f"checkpoints of BPS_SHARDED_UPDATE=1) "
                              f"{_SHARDED}")
