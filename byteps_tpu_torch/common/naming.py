"""Tensor declaration, stable name→key assignment, and PS key placement
(the port's copy of ``byteps_tpu/common/naming.py``, with the djb2
placement only).

Mirrors the reference's declaration machinery:
  - ``IsTensorDeclared`` / declared-key assignment (reference: global.cc:412-429)
  - per-partition PS keys ``declared_key << 16 | i`` (reference: operations.cc:301-317)
  - server placement by the djb2 hash of the key (reference:
    global.cc:566-677, BYTEPS_KEY_HASH_FN's default)

Keys follow declaration order, not the name string: the first name
declared in a registry gets key 0. The fp8 codecs' noise seed derives from
the PS key, so a worker that declares its gradients in the same order as
the JAX package's gets the same keys and the same payloads.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def _raw_djb2(key: int) -> int:
    # reference: global.cc djb2 over the decimal-string form of the key
    h = 5381
    for ch in str(key):
        h = ((h << 5) + h + ord(ch)) & 0xFFFFFFFF
    return h


@dataclass
class TensorDecl:
    """Per-tensor declaration record (reference: BPSContext, common.h:177-205)."""
    name: str
    declared_key: int
    priority: int = 0              # default -declared_key, like tf ops.cc:158
    compression_kwargs: Dict[str, str] = field(default_factory=dict)

    def key_for_partition(self, i: int) -> int:
        """Partition ``i``'s PS key; 16 bits of partition space per tensor
        (reference: operations.cc:301)."""
        if not 0 <= i < 1 << 16:
            raise ValueError(f"{self.name}: partition {i} outside the 16-bit "
                             f"partition space of a PS key")
        return (self.declared_key << 16) | i


class NameRegistry:
    """Thread-safe name→key registry; keys follow declaration order, and
    ``redeclare_all`` replays them for an elastic resume."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._decls: Dict[str, TensorDecl] = {}
        self._order: List[str] = []          # declaration order, for replay

    def declare(self, name: str, priority: Optional[int] = None,
                **compression_kwargs: str) -> TensorDecl:
        """Declare a tensor; idempotent per name (reference:
        IsTensorDeclared). ``priority`` defaults to ``-declared_key``:
        the later a tensor is declared, the later it goes."""
        with self._lock:
            decl = self._decls.get(name)
            if decl is None:
                key = len(self._order)
                decl = TensorDecl(
                    name, key, -key if priority is None else priority,
                    {k: str(v) for k, v in compression_kwargs.items()})
                self._decls[name] = decl
                self._order.append(name)
            return decl

    def get(self, name: str) -> Optional[TensorDecl]:
        with self._lock:
            return self._decls.get(name)

    def declared_names(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def redeclare_all(self) -> List[TensorDecl]:
        """Replay the declarations in their original order (reference:
        ReDeclareTensor, global.cc:431-436): keys follow that order, so
        name→key stays the same."""
        with self._lock:
            decls = [self._decls[n] for n in self._order]
        self.reset()
        return [self.declare(d.name, priority=d.priority,
                             **d.compression_kwargs) for d in decls]

    def reset(self) -> None:
        with self._lock:
            self._decls.clear()
            self._order.clear()


def place_key(key: int, num_servers: int) -> int:
    """Which server shard owns a PS key: djb2, the reference's default
    (reference: global.cc:628-677). The JAX package's other placements
    (``BPS_KEY_HASH_FN``) are not ported (ROADMAP.md)."""
    if num_servers <= 1:
        return 0
    return _raw_djb2(key) % num_servers


def log_key_placement(key: int, nbytes: int, shard: int,
                      shard_bytes: dict) -> None:
    """Record and log one key's server placement with per-server load
    shares (reference: global.cc:660-667)."""
    from .logging import get_logger
    shard_bytes[shard] = shard_bytes.get(shard, 0) + int(nbytes)
    log = get_logger()
    if not log.isEnabledFor(10):        # DEBUG: skip the formatting cost
        return
    total = sum(shard_bytes.values()) or 1
    loads = ", ".join(f"s{i}={100.0 * b / total:.0f}%"
                      for i, b in sorted(shard_bytes.items()))
    log.debug("PS key %d (%d B) -> server %d (djb2 hash); load: %s",
              key, nbytes, shard, loads)
