"""Codec controller of the fused compression plane (the port's copy of the
pinned half of ``byteps_tpu/compress/controller.py``).

``FixedController`` is the pinned decision trace (``BPS_COMPRESS=<codec>``):
every registered layer runs one codec, forever, so a fixed trace plus
deterministic codecs gives bit-reproducible compressed training. The
adaptive ``CompressController`` (``BPS_COMPRESS=auto``), which reads live
congestion signals, is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional

from ..obs.metrics import MetricsRegistry, get_registry
from . import wire


class FixedController:
    """Pinned decision trace: every registered layer runs ONE codec."""

    def __init__(self, level: str,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.reg = registry if registry is not None else get_registry()
        self.level = wire.codec_id(level)
        self._layers: List[str] = []
        self._m_decisions = self.reg.counter("compress/decisions")

    def register_layer(self, layer: str) -> None:
        if layer in self._layers:
            return
        self._layers.append(layer)
        self.reg.gauge(f"compress/level/{layer}").set(self.level)
        if self.level != wire.CODEC_NONE:
            self._m_decisions.inc()

    def level_of(self, layer: str) -> int:
        return self.level

    def on_round(self) -> None:
        pass
