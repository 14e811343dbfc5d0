"""Stochastic dithering quantizer of the port (counterpart of
``byteps_tpu/ops/compression/dithering.py``; reference:
impl/dithering.{cc,h}, QSGD-style): normalize by the max or the L2 norm,
quantize onto s linear levels {i/s} or natural levels {2^(i-s)}, and
round to one of the two neighbouring levels at random (Bernoulli).

As in the JAX package the payload is dense: ``{"q": int8 codes (int16
when the widest code exceeds 127), "scale": fp32}``, where the reference
Elias-delta-codes a bit stream.

``quantize(x, u)`` takes the uniforms in [0, 1) and is the golden-tested
core, in the JAX package's order of operations (|x| / scale · s, floor,
u < p). ``compress`` draws ``u`` from a ``torch.Generator`` on the
bucket's device whose state is the compressor state, seeded from the
``seed`` kwarg, as randomk does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .base import DTYPES, Compressor, generator, generator_state, register

LINEAR, NATURAL = 0, 1   # dithering_partition (reference PartitionType)
MAX, L2 = 0, 1           # dithering_normalize (reference NomalizeType)


@register("dithering")
def _make(kwargs, size, dtype):
    return DitheringCompressor(
        size, dtype, s=int(float(kwargs.get("compressor_k", 4))),
        seed=int(kwargs.get("seed", 0)),
        ptype=int(kwargs.get("dithering_partition", LINEAR)),
        ntype=int(kwargs.get("dithering_normalize", MAX)))


def round_next_pow2(v: torch.Tensor) -> torch.Tensor:
    """The smallest power of two >= v (1 for v <= 1), elementwise
    (reference: RoundNextPow2, utils.h). The JAX package computes it on
    uint32; int64 gives the same values for every v in [0, 2^31], which
    covers the natural partition's ceil(normalized) <= 2^(s-1)."""
    v = v.to(torch.int64).clamp_min(1) - 1
    for shift in (1, 2, 4, 8, 16):
        v = v | (v >> shift)
    return v + 1


class DitheringCompressor(Compressor):
    name = "dithering"

    def __init__(self, size: int, dtype: str = "float32", s: int = 4,
                 seed: int = 0, ptype: int = LINEAR, ntype: int = MAX) -> None:
        super().__init__(size, dtype)
        self.s = s
        self.seed = seed
        self.ptype = ptype
        self.ntype = ntype
        # the widest code: s for linear, 2^(s-1) for natural
        self.qmax = s if ptype == LINEAR else (1 << (s - 1))
        self.qdtype = torch.int8 if self.qmax <= 127 else torch.int16

    def init_state(self, device=None):
        return {"rng": generator_state(self.seed, device)}

    def draw(self, state, device) -> Tuple[torch.Tensor, dict]:
        """``size`` fp32 uniforms in [0, 1) from the state's generator,
        and the state after them."""
        g = generator(state["rng"], device)
        u = torch.rand(self.size, generator=g, device=device,
                       dtype=torch.float32)
        return u, {"rng": g.get_state()}

    def _scale(self, x):
        if self.ntype == MAX:
            return x.abs().max()
        return torch.sqrt((x * x).sum())

    def quantize(self, x: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(signed codes, scale) of ``x`` with the uniforms ``u`` driving
        the Bernoulli rounding."""
        scale = self._scale(x)
        absx = x.abs()
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        if self.ptype == LINEAR:
            normalized = absx / safe * self.s
            floor = torch.floor(normalized)
            # Bernoulli(normalized - floor): u < p (reference: next() < p·2^64)
            q = floor + (u < (normalized - floor))
        else:
            normalized = absx / safe * (1 << (self.s - 1))
            fl = (round_next_pow2(torch.ceil(normalized)) >> 1).to(
                torch.float32)
            length = torch.where(fl != 0, fl, torch.ones_like(fl))
            p = (normalized - fl) / length
            q = fl + length * (u < p)
        q = torch.sign(x) * q
        return q.to(self.qdtype), scale.float()

    def compress(self, x: torch.Tensor, state) -> Tuple[dict, dict]:
        u, state = self.draw(state, x.device)
        q, scale = self.quantize(x, u)
        return {"q": q, "scale": scale}, state

    def decompress(self, payload: dict) -> torch.Tensor:
        out = payload["q"].float() * payload["scale"] / self.qmax
        return out.to(DTYPES[self.dtype])

    def payload_nbytes(self) -> int:
        return self.size * (1 if self.qdtype == torch.int8 else 2) + 4
