"""RandomK sparsifier of the port (counterpart of
``byteps_tpu/ops/compression/randomk.py``): k coordinates drawn uniformly
**with replacement**, shipped as (index, value) pairs like topk's
(reference: impl/randomk.cc draws Randint(0, len) k times; a repeated
index carries the same value, so it does no harm).

``compress_with_indices(x, idx)`` is the deterministic core, which the
golden tests drive with the reference's XorShift128+ indices. ``compress``
draws its indices from a ``torch.Generator`` on the bucket's device whose
state is the compressor state, seeded from the ``seed`` kwarg (the JAX
package threads a ``jax.random`` key instead: the same distribution, a
stream torch cannot replay). As there, every bucket starts from the same
seed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...common.partition import itemsize
from .base import Compressor, generator, generator_state, register
from .topk import resolve_k, scatter


@register("randomk")
def _make(kwargs, size, dtype):
    return RandomkCompressor(size, dtype, k=resolve_k(kwargs, size, dtype),
                             seed=int(kwargs.get("seed", 0)))


class RandomkCompressor(Compressor):
    name = "randomk"

    def __init__(self, size: int, dtype: str = "float32", k: int = 1,
                 seed: int = 0) -> None:
        super().__init__(size, dtype)
        self.k = min(k, size)
        self.seed = seed

    def init_state(self, device=None):
        return {"rng": generator_state(self.seed, device)}

    def draw(self, state, device) -> Tuple[torch.Tensor, dict]:
        """k indices in [0, size) from the state's generator, and the
        state after them."""
        g = generator(state["rng"], device)
        idx = torch.randint(0, self.size, (self.k,), generator=g,
                            device=device, dtype=torch.int32)
        return idx, {"rng": g.get_state()}

    def compress(self, x: torch.Tensor, state) -> Tuple[dict, dict]:
        idx, state = self.draw(state, x.device)
        return self.compress_with_indices(x, idx)[0], state

    def compress_with_indices(self, x: torch.Tensor,
                              idx: torch.Tensor) -> Tuple[dict, tuple]:
        idx = torch.as_tensor(idx, dtype=torch.int32, device=x.device)
        return {"indices": idx, "values": x[idx]}, ()

    def decompress(self, payload: dict) -> torch.Tensor:
        return scatter(self.size, self.dtype, payload)

    def payload_nbytes(self) -> int:
        return self.k * (4 + itemsize(self.dtype))
