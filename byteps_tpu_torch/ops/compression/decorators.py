"""Compressor decorators of the port: error feedback and Nesterov momentum
(counterpart of ``byteps_tpu/ops/compression/decorators.py``).

Reference:
  - error_feedback.h:26-46: ``corrected = grad + error; compressed =
    Compress(corrected); error = corrected - Decompress(compressed)``;
  - vanilla_error_feedback.{cc,h}: the carried error is scaled by
    η_{t-1}/η_t. The JAX package carries the two learning rates in the
    state (ratio 1 until a schedule sets them); so does the port;
  - momentum.h + nesterov_momentum.h:26-34: ``m = μm + g; g += μm``.

State in, state out, as in the JAX package: nothing is updated in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .base import DTYPES, Compressor


class VanillaErrorFeedback(Compressor):
    name = "vanilla_ef"

    def __init__(self, inner: Compressor) -> None:
        super().__init__(inner.size, inner.dtype)
        self.inner = inner

    def init_state(self, device=None):
        one = torch.ones((), dtype=torch.float32, device=device)
        return {"error": torch.zeros(self.size, dtype=DTYPES[self.dtype],
                                     device=device),
                "lr_prev": one, "lr_now": one.clone(),
                "inner": self.inner.init_state(device)}

    def compress(self, x: torch.Tensor, state) -> Tuple[dict, dict]:
        ratio = state["lr_prev"] / state["lr_now"].clamp_min(1e-30)
        corrected = x + ratio * state["error"]
        payload, inner_state = self.inner.compress(corrected, state["inner"])
        error = corrected - self.inner.decompress(payload)
        return payload, {"error": error, "lr_prev": state["lr_now"],
                         "lr_now": state["lr_now"], "inner": inner_state}

    def decompress(self, payload):
        return self.inner.decompress(payload)

    def payload_nbytes(self) -> int:
        return self.inner.payload_nbytes()


class NesterovMomentum(Compressor):
    name = "nesterov_momentum"

    def __init__(self, inner: Compressor, mu: float = 0.9) -> None:
        super().__init__(inner.size, inner.dtype)
        self.inner = inner
        self.mu = mu

    def init_state(self, device=None):
        return {"m": torch.zeros(self.size, dtype=DTYPES[self.dtype],
                                 device=device),
                "inner": self.inner.init_state(device)}

    def compress(self, x: torch.Tensor, state) -> Tuple[dict, dict]:
        m = self.mu * state["m"] + x          # m = μm + g
        corrected = x + self.mu * m           # g += μm (Nesterov lookahead)
        payload, inner_state = self.inner.compress(corrected, state["inner"])
        return payload, {"m": m, "inner": inner_state}

    def decompress(self, payload):
        return self.inner.decompress(payload)

    def payload_nbytes(self) -> int:
        return self.inner.payload_nbytes()
