"""Consistent-hash ring (the port's copy of ``HashRing`` in
``byteps_tpu/server/plane/placement.py``).

``HashRing`` fixes the deterministic order in which shards (here: the
data-parallel replicas of the sharded weight update) are considered for a
key: the clockwise successor walk from the key's ring position. Every
process that builds the ring over the same shard count walks it alike, so
every worker derives the same assignment with no coordination round, and
the JAX package's workers derive the same one: the hashes are the JAX
package's, bit for bit.

The placement service, epochs and key migration of the managed server
plane are not ported yet (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import bisect
from typing import List, Optional

DEFAULT_VNODES = 64


def _h64(s: str) -> int:
    """FNV-1a over the string form: process-independent, unlike Python's
    salted ``hash()``."""
    h = 0xCBF29CE484222325
    for ch in s:
        h = ((h ^ ord(ch)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _mix64(x: int) -> int:
    """splitmix64 finalizer, a key's ring position: keys are sequential
    integers (``decl << 16 | bucket``), and the full avalanche spreads
    adjacent ones over the whole ring."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class HashRing:
    """Virtual-node consistent-hash ring over ``num_shards`` shards;
    ``weights`` (relative capacity per shard, default equal) scale each
    shard's vnode count."""

    def __init__(self, num_shards: int, vnodes: int = DEFAULT_VNODES,
                 weights: Optional[List[float]] = None) -> None:
        if num_shards <= 0:
            raise ValueError("need at least one shard")
        if weights is not None and len(weights) != num_shards:
            raise ValueError(f"{len(weights)} weights for {num_shards} "
                             f"shards")
        self.num_shards = num_shards
        self.vnodes = max(1, int(vnodes))
        w = weights or [1.0] * num_shards
        wmax = max(w)
        pts: List[tuple] = []
        for s in range(num_shards):
            n = max(1, round(self.vnodes * w[s] / wmax))
            for v in range(n):
                pts.append((_mix64(_h64(f"shard{s}#v{v}")), s))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [o for _, o in pts]

    def lookup(self, key: int) -> int:
        """The key's primary shard: the first vnode clockwise of it."""
        i = bisect.bisect_right(self._points, _mix64(key))
        return self._owners[i % len(self._owners)]

    def successors(self, key: int, k: int,
                   skip: Optional[set] = None) -> List[int]:
        """The first ``k`` distinct shards on the clockwise walk from the
        key's position, ``skip`` excluded; fewer live shards: all of
        them, in walk order."""
        skip = skip or set()
        i = bisect.bisect_right(self._points, _mix64(key))
        out: List[int] = []
        n = len(self._owners)
        for j in range(n):
            s = self._owners[(i + j) % n]
            if s in skip or s in out:
                continue
            out.append(s)
            if len(out) >= k:
                break
        return out
