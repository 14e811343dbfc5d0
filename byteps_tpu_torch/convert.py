"""Carry weights and gradients between the JAX package's parameter trees
and the port's modules.

The port keeps the JAX tree's layout leaf for leaf, so the conversion is
by name alone: a nested dict of arrays (``jax.tree.map(np.asarray,
params)``) flattens to ``state_dict`` keys by joining its path with dots,
and back. Only numpy crosses the boundary; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> a ``state_dict`` for ``load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{k}.", node[k])
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, copy=True))

    walk("", tree)
    return out


def _nest(named: Iterable[Tuple[str, torch.Tensor]]) -> dict:
    tree: dict = {}
    for name, t in named:
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = None if t is None else t.detach().float().cpu().numpy()
    return tree


def params_to_jax_layout(model: torch.nn.Module) -> dict:
    """The model's parameters as a nested dict of fp32 numpy arrays."""
    return _nest(model.named_parameters())


def grads_to_jax_layout(model: torch.nn.Module) -> dict:
    """The parameters' ``.grad`` as a nested dict of fp32 numpy arrays in
    the JAX tree's layout (None where a parameter has no gradient), so a
    test can compare them with ``jax.grad`` leaf by leaf."""
    return _nest((n, p.grad) for n, p in model.named_parameters())
