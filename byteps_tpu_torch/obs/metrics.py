"""Lock-cheap process-wide metrics registry (the port's copy of the part of
``byteps_tpu/obs/metrics.py`` that the parameter-server path reports
into).

Counters (monotonic), gauges (last value) and fixed-bucket latency
histograms, always on unless ``BPS_STATS=0``. One observation costs an
attribute hop plus one short per-metric lock, cheap enough for the
exchange's per-bucket hot path. Metric objects are created on first use
and live for the process; call sites may cache them.

The parameter-server stages are pre-registered as ``stage/<NAME>``
histograms, so "which stages exist" is answerable before any traffic.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.config import _TRUE

# the stages the sync PS exchange observes (docs/timeline.md's names)
STAGES: Tuple[str, ...] = (
    "PS_PUSH_PULL", "PS_D2H", "PS_PACK", "PS_COMPRESS", "PS_COMPRESS_DEV",
    "PS_PUSH", "PS_PULL", "PS_DECOMPRESS", "PS_UNPACK", "PS_H2D")

# fused compression plane and device encode: byte and merge counters
# pre-registered so "is the plane doing anything" is answerable before
# any traffic; the per-layer ps/{push,pull,d2h}_bytes/<decl>.<bucket>
# counters ride alongside, registered at plan time
COMPRESS_COUNTERS: Tuple[str, ...] = (
    "compress/decisions", "compress/raw_bytes", "compress/wire_bytes",
    "ps/push_bytes", "ps/pull_bytes", "ps/d2h_bytes",
    "server/fused_rounds_homog", "server/fused_rounds_fallback",
    "server/fused_dense_decodes", "server/fused_merge_cpu_s",
    "server/fused_pull_hits", "server/fused_pull_encodes")


# bounded staleness (server/admission.py::StaleStore): pre-registered so
# a server's report says 0 before any round sealed
LAG_COUNTERS: Tuple[str, ...] = (
    "lag/stale_serves", "lag/barrier_falls", "lag/late_folds",
    "lag/evicted_serves")
LAG_GAUGES: Tuple[str, ...] = ("lag/max_streak",)


def _env_stats_on() -> bool:
    return os.environ.get("BPS_STATS", "1").strip().lower() in _TRUE


# the master switch, read once per process
_enabled = _env_stats_on()


def metrics_enabled() -> bool:
    return _enabled


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Last-value gauge, with inc/dec for level gauges such as
    ``ps/rounds_in_flight``."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0


def _default_bounds() -> Tuple[float, ...]:
    """Geometric latency bucket edges: 1e-5 seconds, doubling 24 times."""
    bounds, b = [], 1e-5
    for _ in range(24):
        bounds.append(b)
        b *= 2.0
    return tuple(bounds)


_DEFAULT_BOUNDS = _default_bounds()


class Histogram:
    """Fixed-bucket histogram: count, sum, max and per-bucket counts
    (``bounds[i]`` is the inclusive upper edge of bucket ``i``; one
    overflow bucket catches the rest)."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_max",
                 "_lock")

    def __init__(self, name: str,
                 bounds: Optional[Sequence[float]] = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None \
            else _DEFAULT_BOUNDS
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> dict:
        with self._lock:
            count, tot, mx = self._count, self._sum, self._max
        if count == 0:
            return {"count": 0, "sum_ms": 0.0}
        return {"count": count, "sum_ms": tot * 1e3,
                "mean_ms": tot / count * 1e3, "max_ms": mx * 1e3}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._max = 0.0


class MetricsRegistry:
    """Name → metric map. Creation is locked (rare); observation touches
    only the metric's own lock. Types are pinned per name: asking for
    ``counter("x")`` after ``gauge("x")`` raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        for s in STAGES:
            self.histogram(f"stage/{s}")
        for c in COMPRESS_COUNTERS + LAG_COUNTERS:
            self.counter(c)
        for g in LAG_GAUGES:
            self.gauge(g)

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"requested as {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        if bounds is None:
            return self._get(name, Histogram)
        return self._get(name, Histogram, bounds)

    def stage(self, stage: str) -> Histogram:
        """The latency histogram of a timeline stage name."""
        return self.histogram(f"stage/{stage}")

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Raw values: {name: int|float|{histogram summary}}."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.summary() if isinstance(m, Histogram) else m.value
                for name, m in items}

    def counters_with_prefix(
            self, prefixes: Tuple[str, ...]) -> Dict[str, int]:
        """{name: value} of every counter whose name starts with one of
        ``prefixes``: the per-layer byte counters
        (``ps/push_bytes/<decl>.<bucket>``) appear at plan time, so no
        fixed list covers them."""
        with self._lock:
            items = [(n, m) for n, m in self._metrics.items()
                     if isinstance(m, Counter) and n.startswith(prefixes)]
        return {n: m.value for n, m in items}

    def reset(self) -> None:
        """Zero every metric."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer reports into."""
    return _REGISTRY


def observe_stage(stage: str, dur_s: float) -> None:
    """Record one span of a stage into its latency histogram."""
    if not _enabled:
        return
    _REGISTRY.stage(stage).observe(dur_s)
