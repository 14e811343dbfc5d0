"""TopK sparsifier of the port (counterpart of
``byteps_tpu/ops/compression/topk.py``): keep the k largest-magnitude
entries as (index, value) pairs (reference: impl/topk.{cc,h}; k from
``compressor_k``, a fraction of the buffer when < 1, a count otherwise).

The payload is ``{"indices": int32 [k], "values": [k]}`` and decompress
scatters the values into zeros. ``torch.topk`` on CUDA promises no order
among equal magnitudes, where ``jax.lax.top_k`` takes the lower index
first: the two agree on the decompressed buffer whenever no tie straddles
the k-th place, never necessarily on the order of the index array.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...common.partition import itemsize
from .base import DTYPES, Compressor, register


def resolve_k(kwargs, size: int, dtype: str) -> int:
    """``compressor_k`` < 1: that fraction of the element count (the
    reference's factor · size_bytes / dtype_len), at least 1; >= 1: the
    count itself."""
    factor = float(kwargs.get("compressor_k", 0.01))
    if factor < 1:
        return max(int(factor * size), 1)
    return int(factor)


@register("topk")
def _make(kwargs, size, dtype):
    return TopkCompressor(size, dtype, k=resolve_k(kwargs, size, dtype))


def scatter(size: int, dtype: str, payload: dict) -> torch.Tensor:
    """Zeros of ``size`` with ``payload["values"]`` at
    ``payload["indices"]`` (repeated indices carry the same value)."""
    values = payload["values"]
    out = torch.zeros(size, dtype=DTYPES[dtype], device=values.device)
    out[payload["indices"]] = values.to(out.dtype)
    return out


class TopkCompressor(Compressor):
    name = "topk"

    def __init__(self, size: int, dtype: str = "float32", k: int = 1) -> None:
        super().__init__(size, dtype)
        self.k = min(k, size)

    def compress(self, x: torch.Tensor, state=()) -> Tuple[dict, tuple]:
        idx = torch.topk(x.abs(), self.k, sorted=False).indices
        return {"indices": idx.to(torch.int32), "values": x[idx]}, state

    def decompress(self, payload: dict) -> torch.Tensor:
        return scatter(self.size, self.dtype, payload)

    def payload_nbytes(self) -> int:
        return self.k * (4 + itemsize(self.dtype))
