"""Continuous-batching serving on one device, over a paged (or slot-row) KV pool.

Counterpart of ``deepspeed_tpu/inference/serving``, single replica. Layers,
bottom up:

- :mod:`kv_pool`: :class:`PagedKVPool` (default), global fixed-size KV pages
  behind per-slot page tables, page-count admission, refcounted zero-copy
  prefix sharing with a copy-on-write boundary page; :class:`SlotKVPool`, one
  cap-row reservation per slot;
- :mod:`executor`: :class:`ChunkedDecodeExecutor`, bucketed prefill into a
  slot, K-step decode chunks and speculative verify rounds over the
  slot-batch, with an optional per-chunk watchdog (:class:`ChunkTimeoutError`);
- :mod:`prefix_cache`: :class:`PrefixCache`, a radix trie over token-ID
  prefixes, LRU under a device byte budget with an optional host tier;
- :mod:`scheduler`: :class:`ContinuousBatchingScheduler`, a bounded queue with
  admission control, backpressure, deadlines, cancellation and slot recycling
  between chunks, and speculative decoding (``ServingConfig(speculate=True)``,
  ``inference.speculative``);
- :mod:`telemetry`: :class:`ServingTelemetry`, TTFT, TPOT, queue depth,
  occupancy and tokens/s.

The router, replica hosts, network transport, autoscaler and chaos harness
are ROADMAP.md queue 1 item 9.
"""

from .executor import ChunkedDecodeExecutor, ChunkTimeoutError
from .kv_pool import PagedKVPool, SlotKVPool
from .prefix_cache import PrefixCache, PrefixCacheConfig
from .scheduler import (ContinuousBatchingScheduler, QueueFullError, RequestHandle,
                        RequestState, ServingConfig, validate_admission)
from .telemetry import ServingTelemetry

__all__ = [
    "ChunkedDecodeExecutor", "ChunkTimeoutError", "SlotKVPool", "PagedKVPool",
    "PrefixCache", "PrefixCacheConfig", "ContinuousBatchingScheduler", "QueueFullError",
    "RequestHandle", "RequestState", "ServingConfig", "ServingTelemetry",
    "validate_admission",
]
