"""XorShift128+ of the reference, bit for bit (the port's copy of
``byteps_tpu/ops/compression/rng.py``; reference: compressor/utils.h:72-158,
XorShift128PlusBitShifterRNG: ``set_seed(seed)`` sets the state {a = seed,
b = seed}; Randint(low, high) = xorshift128p() % (high - low) + low;
Bernoulli(p) = next() < p · 2^64).

The host codecs of the PS path draw from it: ``HostRandomk``'s indices and
seeded ``HostDithering``'s uniforms (``ops/compression/host.py``); the
native primitives advance the same two state words in place.
"""

from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


class XorShift128Plus:
    """xorshift128+ in the variant the reference uses."""

    def __init__(self, seed: int = 0) -> None:
        if seed:
            self.set_seed(seed)
        else:
            rd = np.random.RandomState()
            self._a = np.uint64(rd.randint(0, 2**32))
            self._b = np.uint64(rd.randint(0, 2**32))

    def set_seed(self, seed: int) -> None:
        self._a = np.uint64(seed)
        self._b = np.uint64(seed)

    def next(self) -> int:
        with np.errstate(over="ignore"):
            t = self._a
            s = self._b
            self._a = s
            t ^= (t << np.uint64(23)) & _MASK
            t ^= t >> np.uint64(17)
            t ^= s ^ (s >> np.uint64(26))
            self._b = t
            return int((t + s) & _MASK)

    def randint(self, low: int, high: int) -> int:
        """Uniform int in [low, high): the reference's Randint."""
        return self.next() % (high - low) + low

    def rand(self) -> float:
        return self.next() / float(2**64)

    def bernoulli(self, p: float) -> bool:
        return self.next() < p * float(2**64)

    def randint_array(self, low: int, high: int, k: int) -> np.ndarray:
        return np.array([self.randint(low, high) for _ in range(k)],
                        dtype=np.int64)
