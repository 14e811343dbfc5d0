"""Codec controllers of the fused compression plane (the port's copy of
``byteps_tpu/compress/controller.py``).

``FixedController`` is the pinned decision trace (``BPS_COMPRESS=<codec>``):
every registered layer runs one codec, forever, so a fixed trace plus
deterministic codecs gives bit-reproducible compressed training.

``CompressController`` (``BPS_COMPRESS=auto``) maps live congestion
signals of the metrics registry to a per-layer codec level. Compression
pays only where the wire, not compute, is the bottleneck (arXiv
2103.00543); on an idle link its quantize and dequantize work is pure
loss. Signals:

  ``nic/stalls``                 pacing stalls (counter; a delta > 0 means
                                 senders waited on the wire since the last
                                 decision)
  ``server/engine_queue_depth``  enqueued-but-unsummed pushes (gauge, the
                                 server's backlog, ``server/engine.py``)
  ``transport/resends``          reconnect-and-resend events (counter)
  ``ps/push_bytes/<layer>``      who loads the wire: the three signals set
                                 the direction, the per-layer byte deltas
                                 pick the layers an up-step applies to

and the ladder is ``wire.LEVELS`` (none → fp16 → int8 → fp8_e4m3 → ...),
clamped at ``max_level`` (``BPS_COMPRESS_MAX``). ``nic/stalls`` moves
only when a caller raises it: the token-bucket pacer that raises it in the
JAX package is not ported (ROADMAP.md queue 1). With the in-process server
a live run reads the backlog gauge; with standalone servers
(``BPS_SERVER_ADDRS``) the gauge lives in the server processes, so a
worker's controller reads ``transport/resends`` alone (the remote
transport raises it), as the JAX package's does until its fleet scraper
brings the servers' backlog over. The JAX controller can take the backlog
from a fleet scraper's maximum over the server shards; the fleet scraper
(``BPS_FLEET_SCRAPE_SEC``) is refused in this port, so there is no such
branch here.

Decisions happen at round boundaries (the exchange calls ``on_round``
when it opens a round, every ``interval`` rounds one decision,
``BPS_COMPRESS_INTERVAL``) with hysteresis: a level moves only after
``hold`` consecutive congested (or idle) verdicts, and a boundary verdict
resets both streaks, so a signal riding its threshold never flaps the
codec. An idle wire (all three signals quiet) decays every layer back
toward ``none``. ``compress/level/<layer>`` gauges hold each layer's
ladder index and ``compress/decisions`` counts level changes; each change
is also a key-less flight-recorder event.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..obs import flight
from ..obs.metrics import MetricsRegistry, get_registry
from . import wire


class CompressController:
    """Maps live congestion signals to a per-layer codec level."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_level: str = "int8",
                 hold: int = 2,
                 queue_depth_min: float = 2.0,
                 interval: int = 1) -> None:
        self.reg = registry if registry is not None else get_registry()
        self.max_level = wire.codec_id(max_level)
        self.hold = max(1, int(hold))
        self.queue_depth_min = float(queue_depth_min)
        self.interval = max(1, int(interval))
        self._lock = threading.Lock()
        self._layers: Dict[str, int] = {}        # layer -> ladder index
        self._gauges: Dict[str, object] = {}
        self._bytes: Dict[str, object] = {}      # ps/push_bytes/<layer>
        self._bytes_snap: Dict[str, int] = {}    # value at last decision
        self._up = 0                              # consecutive verdicts
        self._down = 0
        self._last_stalls = self.reg.counter("nic/stalls").value
        self._last_resends = self.reg.counter("transport/resends").value
        self._rounds_seen = 0
        self._m_decisions = self.reg.counter("compress/decisions")

    # ------------------------------------------------------------ layers

    def register_layer(self, layer: str) -> None:
        with self._lock:
            if layer in self._layers:
                return
            self._layers[layer] = wire.CODEC_NONE
            g = self.reg.gauge(f"compress/level/{layer}")
            g.set(wire.CODEC_NONE)
            self._gauges[layer] = g
            # the exchange counts every push of the layer's bucket here,
            # dense or encoded: who loads the wire (see _shift)
            self._bytes[layer] = self.reg.counter(f"ps/push_bytes/{layer}")
            self._bytes_snap[layer] = self._bytes[layer].value

    def level_of(self, layer: str) -> int:
        return self._layers.get(layer, wire.CODEC_NONE)

    # ---------------------------------------------------------- decision

    def _verdict(self) -> Optional[bool]:
        """True: wire-bound; False: idle; None: the boundary (no vote).

        The two counters' deltas since the last decision and the backlog
        gauge's current value. All quiet is idle; a stall, a resend or a
        backlog at the floor is wire-bound; a backlog between 0 and the
        floor with no stalls is the boundary, which must not flap."""
        stalls = self.reg.counter("nic/stalls").value
        resends = self.reg.counter("transport/resends").value
        depth = self.reg.gauge("server/engine_queue_depth").value
        d_stalls = stalls - self._last_stalls
        d_resends = resends - self._last_resends
        self._last_stalls, self._last_resends = stalls, resends
        if d_stalls > 0 or d_resends > 0 or depth >= self.queue_depth_min:
            return True
        if d_stalls == 0 and d_resends == 0 and depth <= 0:
            return False
        return None

    def on_round(self) -> None:
        """One round boundary passed; every ``interval`` rounds read the
        signals and maybe move the ladder."""
        with self._lock:
            self._rounds_seen += 1
            if self._rounds_seen % self.interval:
                return
            self.decide_locked()

    def decide(self) -> Dict[str, int]:
        """Force one decision pass; returns the levels after it."""
        with self._lock:
            self.decide_locked()
            return dict(self._layers)

    def decide_locked(self) -> None:
        v = self._verdict()
        try:
            if v is None:
                # the boundary resets both streaks: a signal riding its
                # threshold holds the levels
                self._up = self._down = 0
                return
            if v:
                self._up += 1
                self._down = 0
                if self._up >= self.hold:
                    self._up = 0
                    self._shift(+1)
            else:
                self._down += 1
                self._up = 0
                if self._down >= self.hold:
                    self._down = 0
                    self._shift(-1)
        finally:
            # "bytes since the last decision" is _shift's signal: snapshot
            # on every pass, verdict or not
            for name, c in self._bytes.items():
                self._bytes_snap[name] = c.value

    def _shift(self, direction: int) -> None:
        """Move layers one rung (clamped to [none, max_level]) and record
        the changes. An up-step applies to the layers that moved bytes
        since the last decision (an idle layer has nothing on the wire to
        compress), to all of them when none has; a decay applies to every
        layer. Size and dtype eligibility is the plane's business."""
        targets = self._layers
        if direction > 0:
            loaded = {name for name in self._layers
                      if self._bytes[name].value - self._bytes_snap[name] > 0}
            if loaded:
                targets = loaded
        for layer in list(targets):
            lvl = self._layers[layer]
            new = min(max(lvl + direction, wire.CODEC_NONE), self.max_level)
            if new != lvl:
                self._layers[layer] = new
                self._gauges[layer].set(new)
                self._m_decisions.inc()
                # key-less: a codec decision is context for every key's
                # postmortem
                flight.record("codec", stage=layer,
                              detail=f"level {lvl}->{new}")


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
