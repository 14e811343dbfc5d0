"""Compressor interface and registry of the port (counterpart of
``byteps_tpu/ops/compression/base.py``).

Reference: compressor.h:74-117 (Compress/Decompress), compressor_registry.cc
(name -> constructor; Create() resolves the decorator chain momentum ->
error feedback -> compressor from string kwargs).

As in the JAX package, a compressor works on one flat 1-D bucket buffer
and its state (error-feedback memory, momentum) is passed in and returned
explicitly, so one instance can serve a bucket on any device. State and
payloads are dicts of tensors on the bucket's device. The kwargs surface
is string-typed and keeps the reference's key names (``compressor_type``,
``ef_type``, ``momentum_type``, ``momentum_mu``,
``compressor_onebit_scaling``, ``compressor_backend``, ``compressor_k``,
``seed``, ``dithering_partition``, ``dithering_normalize``).

Registered (by the package's ``__init__``, which imports each module):
``onebit``, ``topk``, ``randomk`` and ``dithering``, the JAX package's
four. The two that draw random numbers (randomk, dithering)
keep a ``torch.Generator``'s state in their compressor state
(``generator_state``): a CPU byte tensor, seeded from the ``seed`` kwarg,
that goes in and out of ``compress`` like any other state, so no draw
waits on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

Payload = Dict[str, torch.Tensor]
State = Any

# bucket dtype names (as ``common/partition.py`` writes them) -> torch
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

_REGISTRY: Dict[str, Callable[..., "Compressor"]] = {}


def register(name: str):
    def deco(ctor):
        if name in _REGISTRY:
            raise ValueError(f"duplicate compressor {name!r}")
        _REGISTRY[name] = ctor
        return ctor
    return deco


class Compressor:
    """A compressor over a flat float buffer of ``size`` elements."""

    name: str = "identity"

    def __init__(self, size: int, dtype: str = "float32") -> None:
        self.size = size
        self.dtype = dtype

    def init_state(self, device=None) -> State:
        return ()

    def compress(self, x: torch.Tensor, state: State) -> Tuple[Payload, State]:
        raise NotImplementedError

    def decompress(self, payload: Payload) -> torch.Tensor:
        raise NotImplementedError

    def payload_nbytes(self) -> int:
        """Wire size of one compressed payload (for telemetry/ratio)."""
        raise NotImplementedError


def generator_state(seed: int, device=None) -> torch.Tensor:
    """The state of a ``torch.Generator`` on ``device`` (default the CPU)
    seeded with ``seed``: a CPU byte tensor."""
    g = torch.Generator(device=device or "cpu")
    g.manual_seed(seed)
    return g.get_state()


def generator(state: torch.Tensor, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` at ``state`` (which must come
    from a generator of the same device type)."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def create(kwargs: Dict[str, str], size: int,
           dtype: str = "float32") -> Optional[Compressor]:
    """The decorator chain of ``kwargs``, outermost first: Nesterov
    momentum -> vanilla error feedback -> the compressor (reference:
    CompressorRegistry::Create, compressor_registry.cc:40-56). None when
    no ``compressor_type`` is given."""
    if "compressor_type" not in kwargs:
        return None
    kind = kwargs["compressor_type"]
    ctor = _REGISTRY.get(kind)
    if ctor is None:
        raise ValueError(f"no compressor registered under {kind!r}; have "
                         f"{sorted(_REGISTRY)}")
    comp = ctor(kwargs, size, dtype)
    if kwargs.get("ef_type") == "vanilla":
        from .decorators import VanillaErrorFeedback
        comp = VanillaErrorFeedback(comp)
    if kwargs.get("momentum_type") == "nesterov":
        from .decorators import NesterovMomentum
        comp = NesterovMomentum(comp, mu=float(kwargs.get("momentum_mu",
                                                          0.9)))
    return comp


def registered_names():
    return sorted(_REGISTRY)
