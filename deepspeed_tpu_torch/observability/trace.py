"""Hierarchical wall-clock span tracer with request-scoped context.

Counterpart of ``deepspeed_tpu/observability/trace.py``, the part the serving
column uses: the scheduler records every stage of a request (queue wait,
prefix lookup, bind or restore, prefill, decode chunks, retire) as spans that
share one trace id per request. The tracer is a process-global that starts
disabled; while disabled every call returns at once (``begin`` and
``start_span`` return ``None``), with no allocation and no clock read.
Finished spans land in a drop-oldest ring of ``max_spans``; drops are
counted. Timestamps are wall-anchored microseconds advanced by the monotonic
clock. The cross-process pieces (``ingest``, ``drain``, streaming, sinks)
and the Chrome-trace export belong to the fleet (ROADMAP.md queue 1 item 9).
"""

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

CAT_SERVING = "serving"


class SpanContext:
    """The cross-boundary identity of a span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


class OpenSpan:
    """A started-but-unfinished span (kept on the owning handle)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id", "t0", "attrs", "tid")

    def __init__(self, name, cat, trace_id, span_id, parent_id, t0, attrs, tid):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.attrs = attrs or {}
        self.tid = tid


def _parent_of(parent) -> tuple:
    """(trace_id, span_id) from an OpenSpan, a SpanContext or None."""
    if parent is None:
        return None, None
    return parent.trace_id, getattr(parent, "span_id", None)


class Tracer:
    """Process-wide span recorder. ``enable()`` before the run; instrumented
    sites call through unconditionally and pay nearly nothing while disabled."""

    def __init__(self, max_spans: int = 200_000):
        self.enabled = False
        self.dropped = 0
        self._spans: "deque[Dict]" = deque(maxlen=int(max_spans))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pid_label = f"pid{os.getpid()}"
        self._mono0 = time.monotonic()
        self._wall0 = time.time()

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def ts_us(self, mono: Optional[float] = None) -> float:
        """Wall-anchored timestamp in µs from a ``time.monotonic`` reading."""
        m = time.monotonic() if mono is None else mono
        return (self._wall0 + (m - self._mono0)) * 1e6

    def _new_id(self) -> str:
        return f"{os.getpid():x}.{next(self._ids):x}"

    def begin(self, name: str, cat: str = CAT_SERVING, ctx: Optional[SpanContext] = None,
              attrs: Optional[Dict] = None, t0: Optional[float] = None) -> Optional[OpenSpan]:
        """Open a root-scoped span: under ``ctx`` when a parent is propagated,
        else with a fresh trace id (the request scope boundary)."""
        if not self.enabled:
            return None
        trace_id, parent_id = _parent_of(ctx)
        if trace_id is None:
            trace_id = f"t{os.getpid():x}.{next(self._ids):x}.{os.urandom(3).hex()}"
        return OpenSpan(name, cat, trace_id, self._new_id(), parent_id,
                        time.monotonic() if t0 is None else t0, attrs,
                        threading.current_thread().name)

    def start_span(self, name: str, parent=None, cat: Optional[str] = None,
                   attrs: Optional[Dict] = None,
                   t0: Optional[float] = None) -> Optional[OpenSpan]:
        """Open a child span under ``parent`` (OpenSpan or SpanContext)."""
        if not self.enabled or parent is None:
            return None
        trace_id, parent_id = _parent_of(parent)
        return OpenSpan(name, cat or getattr(parent, "cat", CAT_SERVING), trace_id,
                        self._new_id(), parent_id, time.monotonic() if t0 is None else t0,
                        attrs, threading.current_thread().name)

    def end_span(self, open_span: Optional[OpenSpan], t1: Optional[float] = None,
                 attrs: Optional[Dict] = None) -> None:
        if open_span is None:
            return
        if attrs:
            open_span.attrs.update(attrs)
        t1 = time.monotonic() if t1 is None else t1
        self._commit(open_span.name, open_span.cat, open_span.trace_id, open_span.span_id,
                     open_span.parent_id, self.ts_us(open_span.t0),
                     max((t1 - open_span.t0) * 1e6, 0.0), open_span.attrs, open_span.tid)

    def record_span(self, name: str, parent, t0: float, t1: float, cat: Optional[str] = None,
                    attrs: Optional[Dict] = None) -> None:
        """Retroactive span between two ``time.monotonic`` readings."""
        if not self.enabled or parent is None:
            return
        trace_id, parent_id = _parent_of(parent)
        self._commit(name, cat or getattr(parent, "cat", CAT_SERVING), trace_id,
                     self._new_id(), parent_id, self.ts_us(t0), max((t1 - t0) * 1e6, 0.0),
                     attrs or {}, threading.current_thread().name)

    def instant(self, name: str, parent, cat: Optional[str] = None,
                attrs: Optional[Dict] = None) -> None:
        if not self.enabled or parent is None:
            return
        now = time.monotonic()
        self.record_span(name, parent, now, now, cat=cat, attrs=attrs)

    def _commit(self, name, cat, trace_id, span_id, parent_id, ts, dur, attrs, tid) -> None:
        span = {"name": name, "cat": cat, "trace_id": trace_id, "span_id": span_id,
                "parent_id": parent_id, "ts": ts, "dur": dur, "pid": self._pid_label,
                "tid": tid, "attrs": attrs}
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    @property
    def spans(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer
