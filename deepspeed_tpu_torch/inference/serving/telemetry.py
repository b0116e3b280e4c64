"""Serving telemetry: per-request TTFT/TPOT, queue depth, slot occupancy and
tokens/sec, recorded into the process-wide metrics registry
(``observability.metrics``) and aggregated for the caller's snapshot.

Counterpart of ``deepspeed_tpu/inference/serving/telemetry.py`` without the
``MonitorMaster`` backends (ROADMAP.md queue 1 item 9): a ``monitor`` passed
in receives the same ``(tag, value, step)`` events through its
``write_events``. Tags, declared in ``observability.schema``:

- ``serving/ttft_ms``, ``serving/tpot_ms``: per finished request;
- ``serving/tokens_per_sec``: per decode chunk;
- ``serving/queue_depth``, ``serving/slot_occupancy``,
  ``serving/completed_total``, ``serving/rejected_total``: per scheduler step;
- ``serving/prefix_*``: per scheduler step, prefix cache enabled only;
- ``serving/pages_in_use``, ``serving/page_fragmentation``,
  ``serving/prefix_shared_pages``, ``serving/cow_copies_total``: per
  scheduler step, paged pool only;
- ``serving/spec_*``: per verify round, speculation on only; the emission
  site is ``inference.speculative.emit_spec_events``, this class keeps the
  counters.

Latency distributions are fixed-log-bucket histograms: memory stays O(1)
however long the run, and ``snapshot()`` reads its percentiles from them.
"""

import time
from collections import deque
from typing import Dict, Iterable, Optional

from ...observability.metrics import Histogram, RegistryFeed
from ..speculative import SpecStats, emit_spec_events


def window_rate(times: Iterable[float], now: float,
                horizon_s: float = 10.0) -> Optional[float]:
    """Events per second over the trailing ``horizon_s`` window, or None
    without fresh evidence (fewer than two events inside the horizon — a
    stale window must never report an ancient rate). The drain-rate helper
    behind the scheduler's backpressure hint."""
    recent = [t for t in times if t >= now - horizon_s]
    if len(recent) < 2 or now <= recent[0]:
        return None
    return (len(recent) - 1) / max(now - recent[0], 1e-6)


def adaptive_retry_after(floor_s: float, cap_s: float, queue_depth: int,
                         max_queue: int,
                         drain_rate: Optional[float]) -> float:
    """Load-adaptive backpressure hint: estimated seconds until one queue
    slot drains (``(depth + 1) / drain_rate``), a fill-scaled multiple of
    the floor before any drain evidence exists; bounded to
    ``[floor_s, cap_s]`` so one bad estimate cannot park every client for
    minutes. A static hint convoys rejected clients back in lockstep at
    exactly the wrong moment — this one stretches with the backlog."""
    if drain_rate is None or drain_rate <= 0:
        hint = floor_s * (1.0 + queue_depth / max(1, max_queue))
    else:
        hint = (queue_depth + 1) / drain_rate
    return float(min(max(hint, floor_s), cap_s))


class ServingTelemetry:
    """Aggregator and event emitter; ``monitor`` is an optional object with a
    ``write_events(events)`` method and an ``enabled`` flag."""

    def __init__(self, monitor=None):
        self.monitor = monitor
        self._tick = 0
        self._chunk_idx = 0
        self._finished_idx = 0
        # per-telemetry bounded histograms (ms): the snapshot's percentile
        # source; the process registry keeps its own instruments
        self.ttft_ms = Histogram()
        self.tpot_ms = Histogram()
        # per-emitter registry feed: this telemetry's cumulative counters
        # contribute deltas, so several schedulers (and successive runs) sum
        # in the registry instead of max-merging
        self._feed = RegistryFeed()
        self.tokens_total = 0
        self.completed = 0
        self.rejected = 0
        self.cancelled = 0
        self.expired = 0
        self.evicted = 0
        self.decode_seconds = 0.0
        # prefix-cache counters (only advanced when the cache is enabled)
        self.prefix_enabled = False
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self._prefix_stats = None    # latest PrefixCache.stats() gauge set
        self._paged_stats = None     # latest PagedKVPool.stats() gauge set
        # speculative-decoding counters (advanced only when speculation is on)
        self.spec = SpecStats()
        self.spec_enabled = False
        # completion timestamps (bounded): the observed drain rate behind the
        # load-adaptive QueueFullError.retry_after hint
        self._finish_times = deque(maxlen=64)
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------------- emits
    def _write(self, events):
        self._feed.record_events(events)   # the process registry
        if self.monitor is not None and getattr(self.monitor, "enabled", False):
            self.monitor.write_events(events)

    def on_step(self, queue_depth: int, occupancy: float,
                prefix_stats=None, paged_stats=None) -> None:
        self._tick += 1
        ev = [("serving/queue_depth", float(queue_depth), self._tick),
              ("serving/slot_occupancy", float(occupancy), self._tick),
              ("serving/completed_total", float(self.completed), self._tick),
              ("serving/rejected_total", float(self.rejected), self._tick)]
        if paged_stats is not None:
            # paged-pool gauges/counters (PagedKVPool.stats()): page-granular
            # occupancy, allocation-granularity waste, zero-copy sharing
            self._paged_stats = paged_stats
            ev += [("serving/pages_in_use",
                    float(paged_stats["pages_in_use"]), self._tick),
                   ("serving/page_fragmentation",
                    float(paged_stats["page_fragmentation"]), self._tick),
                   ("serving/prefix_shared_pages",
                    float(paged_stats["prefix_shared_pages"]), self._tick),
                   ("serving/cow_copies_total",
                    float(paged_stats["cow_copies_total"]), self._tick)]
        if prefix_stats is not None:
            self._prefix_stats = prefix_stats
            # hit_rate here is ADMISSION-level (successful prefills), the same
            # quantity the snapshot publishes under the same name — the trie's
            # own lookup-level counters (which also tick on failed/retried
            # admissions) live in prefix_cache_report() only
            n = self.prefix_hits + self.prefix_misses
            ev += [("serving/prefix_hit_rate",
                    self.prefix_hits / n if n else 0.0, self._tick),
                   ("serving/prefix_cached_bytes",
                    float(prefix_stats["cached_bytes"]), self._tick),
                   ("serving/prefix_evicted_total",
                    float(prefix_stats["evicted"]), self._tick)]
            if "spilled_bytes" in prefix_stats:
                # tiered-cache rung: host-RAM residency + the two
                # movement counters (device→host spill, host→device promote)
                ev += [("serving/prefix_spilled_bytes",
                        float(prefix_stats["spilled_bytes"]), self._tick),
                       ("serving/prefix_spills_total",
                        float(prefix_stats["spills"]), self._tick),
                       ("serving/prefix_promotions_total",
                        float(prefix_stats["promotions"]), self._tick)]
        self._write(ev)

    def on_prefix(self, hit: bool, tokens: int, enabled: bool = True) -> None:
        """Per-admission hit/miss accounting (``tokens`` = prefill tokens
        skipped via the restored prefix; 0 on a miss)."""
        if not enabled:
            return
        self.prefix_enabled = True
        if hit:
            self.prefix_hits += 1
            self.prefix_hit_tokens += int(tokens)
        else:
            self.prefix_misses += 1

    def on_chunk(self, tokens: int, elapsed: float) -> None:
        self._chunk_idx += 1
        self.tokens_total += int(tokens)
        self.decode_seconds += float(elapsed)
        if elapsed > 0:
            self._write([("serving/tokens_per_sec", tokens / elapsed,
                          self._chunk_idx)])

    def on_spec(self, proposed: int, accepted: int, tokens: int, draft_s: float,
                verify_s: float) -> None:
        """Per-verify-round accounting (one round is one target forward pass
        over the whole slot-batch)."""
        self.spec_enabled = True
        s = self.spec
        s.rounds += 1
        s.proposed += int(proposed)
        s.accepted += int(accepted)
        s.tokens += int(tokens)
        s.draft_s += float(draft_s)
        s.verify_s += float(verify_s)
        emit_spec_events(self, s, draft_s, s.rounds)

    def on_rejected(self) -> None:
        self.rejected += 1

    def on_finished(self, handle) -> None:
        from .scheduler import RequestState
        if handle.state == RequestState.CANCELLED:
            self.cancelled += 1
            return
        if handle.state == RequestState.EXPIRED:
            self.expired += 1
            return
        if handle.state == RequestState.EVICTED:
            self.evicted += 1
            return
        self.completed += 1
        self._finished_idx += 1
        self._finish_times.append(time.monotonic())
        events = []
        if handle.ttft is not None:
            self.ttft_ms.observe(handle.ttft * 1e3)
            events.append(("serving/ttft_ms", handle.ttft * 1e3,
                           self._finished_idx))
        if handle.tpot is not None:
            self.tpot_ms.observe(handle.tpot * 1e3)
            events.append(("serving/tpot_ms", handle.tpot * 1e3,
                           self._finished_idx))
        self._write(events)

    def drain_rate(self, now: Optional[float] = None,
                   horizon_s: float = 10.0) -> Optional[float]:
        """Recent completions per second, or None without fresh evidence."""
        now = time.monotonic() if now is None else now
        return window_rate(self._finish_times, now, horizon_s)

    # --------------------------------------------------------------- aggregate
    def snapshot(self) -> Dict:
        elapsed = time.perf_counter() - self._t_start
        prefix = {}
        if self.prefix_enabled or self._prefix_stats is not None:
            n = self.prefix_hits + self.prefix_misses
            prefix = {
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_rate": self.prefix_hits / n if n else 0.0,
                "prefix_hit_tokens": self.prefix_hit_tokens,
            }
            if self._prefix_stats is not None:
                prefix["prefix_inserted"] = self._prefix_stats["inserted"]
                prefix["prefix_evicted"] = self._prefix_stats["evicted"]
                prefix["prefix_cached_bytes"] = \
                    self._prefix_stats["cached_bytes"]
                if "spilled_bytes" in self._prefix_stats:
                    prefix["prefix_spilled_bytes"] = \
                        self._prefix_stats["spilled_bytes"]
                    prefix["prefix_spills"] = self._prefix_stats["spills"]
                    prefix["prefix_promotions"] = \
                        self._prefix_stats["promotions"]
        paged = ({f"paged_{k}": v for k, v in self._paged_stats.items()}
                 if self._paged_stats is not None else {})
        spec = self.spec.snapshot() if self.spec_enabled else {}
        return {
            **prefix,
            **paged,
            **spec,
            "elapsed_s": elapsed,
            "completed": self.completed,
            "chunks": self._chunk_idx,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "expired": self.expired,
            "evicted": self.evicted,
            "tokens_total": self.tokens_total,
            "tokens_per_sec": (self.tokens_total / self.decode_seconds
                               if self.decode_seconds > 0 else 0.0),
            "ttft_ms_p50": self.ttft_ms.percentile(50),
            "ttft_ms_p95": self.ttft_ms.percentile(95),
            "tpot_ms_p50": self.tpot_ms.percentile(50),
            "tpot_ms_p95": self.tpot_ms.percentile(95),
        }
