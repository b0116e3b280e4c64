"""Bounded process-wide metrics registry.

Counterpart of ``deepspeed_tpu/observability/metrics.py``, the part serving
telemetry uses: one registry per process, keyed by the tags declared in
``observability.schema``, with three instrument kinds: :class:`Counter` (a
cumulative total), :class:`Gauge` (last write wins) and :class:`Histogram`
(fixed log buckets: O(1) memory however long the run, percentiles from the
bucket counts). A telemetry emitter records through its own
:class:`RegistryFeed`, so the counters of several emitters sum. The
Prometheus exposition and the ``/metrics`` HTTP plane belong to the fleet
(ROADMAP.md queue 1 item 9).
"""

import math
import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from . import schema

Event = Tuple[str, float, int]


class Counter:
    """Cumulative total; ``set_total`` when the emitter keeps the running total."""

    kind = schema.COUNTER

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set_total(self, v: float) -> None:
        # monotone: a replayed or stale event must not rewind the total
        if v > self.value:
            self.value = float(v)


class Gauge:
    kind = schema.GAUGE

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-bucket histogram: bucket ``i`` covers ``(lo * growth**(i-1),
    lo * growth**i]``, plus an underflow bucket for values ``<= lo`` and an
    overflow bucket. Percentiles interpolate inside the covering bucket, so
    their relative error is bounded by ``growth - 1``."""

    kind = schema.HISTOGRAM

    def __init__(self, lo: float = 1e-3, hi: float = 1e7, growth: float = 1.08):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} g={growth}")
        self.lo, self.growth = float(lo), float(growth)
        self._log_lo, self._log_g = math.log(lo), math.log(growth)
        n = int(math.ceil((math.log(hi) - self._log_lo) / self._log_g))
        self.counts = np.zeros(n + 2, np.int64)   # [underflow, n buckets, overflow]
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil((math.log(v) - self._log_lo) / self._log_g))
        return min(i, len(self.counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Percentile ``q`` in [0, 100] from the bucket counts, clamped to the
        observed min and max."""
        if self.count == 0:
            return None
        rank = q / 100.0 * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if rank < cum + c:
                if i == 0:
                    est = self.lo
                elif i == len(self.counts) - 1:
                    est = self.max
                else:
                    hi = self.lo * self.growth ** i
                    lo = hi / self.growth
                    frac = (rank - cum + 0.5) / c
                    est = lo * (hi / lo) ** min(max(frac, 0.0), 1.0)
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)


_KIND_CLS = {schema.COUNTER: Counter, schema.GAUGE: Gauge, schema.HISTOGRAM: Histogram}


class MetricsRegistry:
    """Process-wide instrument table keyed by tag. ``record(tag, value)``
    updates (or creates) the instrument of the tag's declared kind; an
    undeclared tag raises."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, tag: str):
        inst = self._metrics.get(tag)
        if inst is None:
            kind = schema.kind_of(tag)
            with self._lock:
                inst = self._metrics.setdefault(tag, _KIND_CLS[kind]())
        return inst

    def record(self, tag: str, value: float, step: int = 0) -> None:
        inst = self._get(tag)
        if inst.kind == schema.COUNTER:
            inst.set_total(value)
        elif inst.kind == schema.GAUGE:
            inst.set(value)
        else:
            inst.observe(value)

    def snapshot(self) -> Dict[str, Dict]:
        out = {}
        for tag, inst in sorted(self._metrics.items()):
            if inst.kind == schema.HISTOGRAM:
                out[tag] = {"kind": inst.kind, "count": inst.count, "sum": inst.total,
                            "min": inst.min, "max": inst.max,
                            "p50": inst.percentile(50), "p95": inst.percentile(95),
                            "p99": inst.percentile(99)}
            else:
                out[tag] = {"kind": inst.kind, "value": inst.value}
        return out


class RegistryFeed:
    """Per-emitter bridge from cumulative event streams to the registry: each
    emitter publishes its own running totals, so the feed remembers its last
    value per counter tag and adds the delta; gauges and histograms pass
    through."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None else _registry
        self._last: Dict[str, float] = {}

    def record_events(self, events: Iterable[Event]) -> None:
        reg = self._registry
        for tag, value, step in events:
            inst = reg._get(tag)
            if inst.kind == schema.COUNTER:
                delta = float(value) - self._last.get(tag, 0.0)
                if delta > 0:
                    inst.inc(delta)
                self._last[tag] = float(value)
            else:
                reg.record(tag, value, step)


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry
