"""Onebit (signSGD) compressor of the port (counterpart of
``byteps_tpu/ops/compression/onebit.py``): 32:1 sign-bit packing with an
optional L1-mean scale (reference: impl/onebit.{cc,h}: sign bits packed
MSB-first into words, scale = mean |x| when
``compressor_onebit_scaling`` is on).

The payload is ``{"packed": int32 words, "scale": fp32 scalar}``. The
scale is taken outside the kernels, in fp32, as the JAX package takes it;
decompress is ``unpack(words) * scale`` cast to the bucket's dtype.

``compressor_backend``: "auto" and "pallas" (the JAX package's names)
pack and unpack through the Hopper kernels of ``kernels.py`` for CUDA
tensors; "jnp" takes their plain versions, only because the user asked
for it (as ``impl="naive"`` does for attention). CPU tensors always take
the plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels
from .base import DTYPES, Compressor, register


@register("onebit")
def _make(kwargs, size, dtype):
    scaled = kwargs.get("compressor_onebit_scaling", "false").lower() in (
        "1", "true", "yes")
    return OnebitCompressor(size, dtype, use_scale=scaled,
                            backend=kwargs.get("compressor_backend", "auto"))


class OnebitCompressor(Compressor):
    name = "onebit"

    def __init__(self, size: int, dtype: str = "float32",
                 use_scale: bool = False, backend: str = "auto") -> None:
        super().__init__(size, dtype)
        if backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown onebit backend {backend!r}")
        self.use_scale = use_scale
        if backend == "jnp":
            self._pack, self._unpack = (kernels.onebit_pack_plain,
                                        kernels.onebit_unpack_plain)
        else:
            self._pack, self._unpack = kernels.onebit_pack, \
                kernels.onebit_unpack

    def compress(self, x: torch.Tensor, state=()) -> Tuple[dict, tuple]:
        packed = self._pack(x.float())
        if self.use_scale:
            scale = x.float().abs().mean()
        else:
            scale = torch.ones((), dtype=torch.float32, device=x.device)
        return {"packed": packed, "scale": scale}, state

    def decompress(self, payload: dict) -> torch.Tensor:
        signs = self._unpack(payload["packed"], self.size)
        return (signs * payload["scale"]).to(DTYPES[self.dtype])

    def payload_nbytes(self) -> int:
        return -(-self.size // 32) * 4 + 4
