"""The declared metric-tag schema, for the tags the serving column publishes.

Counterpart of ``deepspeed_tpu/observability/schema.py``: every tag a
telemetry emitter records is declared here with its instrument kind and a
help text, and the registry refuses an undeclared tag. The single-replica
``serving/*`` tags are ported, speculation's among them (emitted by
``inference/serving/telemetry.py`` and ``inference/speculative.py``); the
router, fleet and training tags come with their emitters (ROADMAP.md queue 1
item 9).
"""

from typing import Dict, Tuple

COUNTER = "counter"      # cumulative total; emissions carry the running value
GAUGE = "gauge"          # last-write-wins sampled value
HISTOGRAM = "histogram"  # per-event observation into fixed log buckets

#: tag -> (kind, help text)
TAGS: Dict[str, Tuple[str, str]] = {
    "serving/ttft_ms": (HISTOGRAM, "queue wait + prefill per finished request"),
    "serving/tpot_ms": (HISTOGRAM, "seconds-per-token (ms) per finished request"),
    "serving/tokens_per_sec": (GAUGE, "decode throughput per chunk"),
    "serving/queue_depth": (GAUGE, "admission queue depth per scheduler tick"),
    "serving/slot_occupancy": (GAUGE, "fraction of KV slots in use per tick"),
    "serving/completed_total": (COUNTER, "requests finished"),
    "serving/rejected_total": (COUNTER, "requests rejected (backpressure)"),
    "serving/prefix_hit_rate": (GAUGE, "admission-level prefix-cache hit rate"),
    "serving/prefix_cached_bytes": (GAUGE, "resident prefix-slab bytes"),
    "serving/prefix_evicted_total": (COUNTER, "prefix-cache LRU evictions"),
    "serving/prefix_spilled_bytes": (GAUGE, "host-RAM rung residency: bytes of spilled "
                                            "prefix slabs"),
    "serving/prefix_spills_total": (COUNTER, "device->host spills at LRU eviction"),
    "serving/prefix_promotions_total": (COUNTER, "host->device promotes at lookup (slab "
                                                 "copy instead of re-prefill)"),
    "serving/pages_in_use": (GAUGE, "allocated KV pages per scheduler tick"),
    "serving/page_fragmentation": (GAUGE, "allocation-granularity waste: fraction of "
                                          "allocated page rows beyond slot reservations"),
    "serving/prefix_shared_pages": (GAUGE, "pages referenced more than once (zero-copy "
                                           "prefix sharing)"),
    "serving/cow_copies_total": (COUNTER, "copy-on-write boundary-page copies at prefix "
                                          "bind"),
    "serving/spec_acceptance_rate": (GAUGE, "cumulative draft-token acceptance rate per "
                                            "verify round"),
    "serving/spec_proposed_total": (COUNTER, "draft tokens offered to the verifier"),
    "serving/spec_accepted_total": (COUNTER, "draft tokens accepted by the verify pass"),
    "serving/spec_draft_ms": (GAUGE, "proposer wall time of the last round"),
}

#: the modules that emit these tags (as the JAX schema lists its own)
EMITTER_MODULES = (
    "deepspeed_tpu_torch/inference/serving/telemetry.py",
    "deepspeed_tpu_torch/inference/speculative.py",
)


def kind_of(tag: str) -> str:
    """Instrument kind of a declared tag; ``KeyError`` for an undeclared one."""
    if tag not in TAGS:
        raise KeyError(f"metric tag {tag!r} is not declared in observability.schema.TAGS "
                       "— declare it (kind + help) before emitting it")
    return TAGS[tag][0]
