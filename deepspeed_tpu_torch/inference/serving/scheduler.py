"""Continuous-batching scheduler: bounded queue → slot-recycled decode chunks.

Counterpart of ``deepspeed_tpu/inference/serving/scheduler.py``. Requests
arrive at any time, wait in a bounded FIFO queue, are prefilled into a free
KV slot between decode chunks, and decode alongside whatever else is in
flight. A finished sequence releases its slot at the next chunk boundary and
a pending prompt is prefilled into it while the other slots keep decoding:
continuous batching in the sense of Orca and vLLM, built from two shapes
(bucketed prefill and the K-step chunk).

Semantics:

- **admission control**: ``submit`` validates prompt and budget against the
  pool cap up front (fail fast, never poison the queue);
- **backpressure**: a full queue raises :class:`QueueFullError` carrying a
  ``retry_after`` hint: the request is rejected, never silently dropped;
- **deadlines / cancellation**: checked at every chunk boundary, for queued
  and in-flight requests alike; an expired or cancelled in-flight request
  keeps its partial tokens and frees its slot;
- **transient faults**: prefill and chunk run under ``retry_with_backoff``
  with the fault points ``serving.prefill`` and ``serving.decode_chunk``.

Token parity: greedy decode through the scheduler gives the tokens of
per-request ``InferenceEngine.generate`` (the same prefill and decode math,
shared through ``decode_fns``). Sampled decode is deterministic per request
``seed`` and independent of slot placement and co-batching, but it is not
``generate``'s stream.

Threading: single-threaded by design; drive it with ``step()`` / ``run()``
from one thread. ``RequestHandle.cancel`` only sets a flag and is safe from
anywhere.

Speculative decoding (``speculate=True``): every decode chunk becomes one
draft-propose / one-pass-verify round (``inference.speculative``): the
proposer drafts each active slot's window on the host from the request's
prompt and tokens, and the executor's ``run_spec_round`` verifies all of them
in one target forward. Greedy output is the non-speculative output wherever
the verify pass and the decode step pick the same argmax (everywhere in the
f32 CPU tests); sampled output keeps each position's distribution.
"""

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Deque, List, Optional

import numpy as np

from ...observability.trace import CAT_SERVING, get_tracer
from ...utils.fault_injection import fault_point, retry_with_backoff
from ...utils.logging import logger
from ..speculative import SpeculativeConfig, make_proposer
from .executor import ChunkedDecodeExecutor
from .prefix_cache import PrefixCache, PrefixCacheConfig
from .telemetry import ServingTelemetry, adaptive_retry_after


class RequestState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    EVICTED = "evicted"     # replica death/drain: partial tokens kept for retry


class QueueFullError(RuntimeError):
    """Backpressure: the admission queue is at capacity. ``retry_after`` is the
    scheduler's hint (seconds) for when to resubmit."""

    def __init__(self, retry_after: float):
        super().__init__(f"serving queue full; retry after {retry_after:.3f}s")
        self.retry_after = float(retry_after)


@dataclass
class ServingConfig:
    slots: int = 2                      # concurrent sequences in the slot-batch
    chunk_size: int = 8                 # decode steps per compiled chunk
    max_queue: int = 16                 # admission queue bound (backpressure)
    max_seq_len: Optional[int] = None   # KV cap; default engine max_out_tokens
    max_prompt_len: Optional[int] = None
    default_max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    retry_after_s: float = 0.25         # backpressure hint FLOOR (the emitted
    #   hint is load-adaptive: queue depth / observed drain rate)
    retry_after_max_s: float = 8.0
    transient_retries: int = 2          # retry_with_backoff budget per dispatch
    retry_base_delay: float = 0.02
    base_seed: int = 0
    chunk_deadline_s: Optional[float] = None   # per-chunk watchdog (None = off)
    prefix_cache: Optional[PrefixCacheConfig] = None   # None = cache off
    # KV memory shape: "paged" (default) = global fixed-size pages behind
    # per-slot page tables, page-count admission, zero-copy refcounted prefix
    # sharing; "slots" = the legacy slot-row pool (one cap-row reservation
    # per slot). Greedy output is bit-identical either way.
    kv_pool: str = "paged"
    kv_page_size: int = 16
    kv_total_pages: Optional[int] = None   # device budget in pages (None = match
    #   the slot-row pool's bytes: slots * ceil(cap/page) + the null page)
    # speculative decoding: every decode chunk becomes ONE draft-propose /
    # one-pass-verify round (see inference.speculative)
    speculate: bool = False
    spec_k: int = 4                     # draft tokens per verify window
    spec_proposer: str = "ngram"        # "ngram" | "draft_model"
    spec_ngram_max: int = 4
    spec_ngram_min: int = 1
    spec_draft_engine: object = None    # engine for "draft_model"


def validate_admission(prompt, max_new_tokens: Optional[int],
                       default_max_new: int, max_prompt_len: int, cap: int):
    """The admission contract: normalize the prompt and budget, raise
    ``ValueError`` for anything that could never fit. One owner, so a
    router's pre-check cannot drift from what a replica accepts."""
    prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
    max_new = int(default_max_new if max_new_tokens is None else max_new_tokens)
    if prompt.size < 1:
        raise ValueError("prompt must contain at least one token")
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    if prompt.size > max_prompt_len:
        raise ValueError(f"prompt length {prompt.size} exceeds "
                         f"max_prompt_len={max_prompt_len}")
    if prompt.size + max_new > cap:
        raise ValueError(f"prompt ({prompt.size}) + max_new_tokens "
                         f"({max_new}) exceeds KV capacity {cap}")
    return prompt, max_new


@dataclass
class RequestHandle:
    """Caller's view of a submitted request (filled in by the scheduler)."""
    id: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    deadline_s: Optional[float]
    seed: int
    arrival: float
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)
    ttft: Optional[float] = None        # queue wait + prefill, seconds
    tpot: Optional[float] = None        # seconds per decode token
    finish_reason: Optional[str] = None  # eos | length | cancelled | deadline
    slot: Optional[int] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    prefix_hit_tokens: int = 0          # prefill tokens skipped via the
    #   prefix cache (0 = cold miss); loadgen splits TTFT on this
    _cancel: bool = False
    _span: Optional[object] = None      # request-scoped trace root (OpenSpan)

    @property
    def trace_id(self) -> Optional[str]:
        return self._span.trace_id if self._span is not None else None

    def cancel(self) -> None:
        self._cancel = True

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.CANCELLED,
                              RequestState.EXPIRED, RequestState.EVICTED)

    def result(self) -> np.ndarray:
        """Generated tokens (EOS included when emitted; partial if cancelled)."""
        return np.asarray(self.tokens, dtype=np.int32)

    def output_ids(self) -> np.ndarray:
        return np.concatenate([self.prompt.astype(np.int32), self.result()])


class ContinuousBatchingScheduler:
    """Admission queue + slot tables driving a :class:`ChunkedDecodeExecutor`."""

    def __init__(self, engine, config: Optional[ServingConfig] = None,
                 monitor=None):
        self.config = cfg = config or ServingConfig()
        cap = int(cfg.max_seq_len or engine._config.max_out_tokens)
        self.executor = ChunkedDecodeExecutor(
            engine, slots=cfg.slots, cap=cap, chunk_size=cfg.chunk_size,
            do_sample=cfg.do_sample, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p,
            max_prompt_len=cfg.max_prompt_len, base_seed=cfg.base_seed,
            chunk_deadline_s=cfg.chunk_deadline_s, kv_pool=cfg.kv_pool,
            kv_page_size=cfg.kv_page_size, kv_total_pages=cfg.kv_total_pages)
        self.cap = cap
        self.proposer = None
        self._spec_cfg: Optional[SpeculativeConfig] = None
        if cfg.speculate:
            self._spec_cfg = SpeculativeConfig(
                k=cfg.spec_k, proposer=cfg.spec_proposer,
                ngram_max=cfg.spec_ngram_max, ngram_min=cfg.spec_ngram_min,
                draft_engine=cfg.spec_draft_engine)
            self.proposer = make_proposer(self._spec_cfg)
            draft = cfg.spec_draft_engine
            if cfg.spec_proposer == "draft_model" and draft.device != engine.device:
                raise ValueError(f"the draft engine is on {draft.device}, the target on "
                                 f"{engine.device}: keep both on one device")
        self.telemetry = ServingTelemetry(monitor)
        self._tracer = get_tracer()
        self.prefix_cache: Optional[PrefixCache] = None
        if cfg.prefix_cache is not None and cfg.prefix_cache.enabled:
            self.prefix_cache = PrefixCache(cfg.prefix_cache)
            if self.executor.paged:
                # LRU eviction of a page entry decrefs against the CURRENT
                # pool (any pool swap clears the cache first, so an entry's
                # pages always belong to the pool this resolves to)
                self.prefix_cache.page_release = \
                    lambda pages: self.executor.pool.release_shared(pages)
                # spill path: gather an evicted entry's pages as a dense host
                # slab (the gather_prefix wire format) before the refs drop
                self.prefix_cache.page_gather = \
                    lambda pages, rows: self.executor.pool.gather_pages(
                        pages, rows)
        self.queue: Deque[RequestHandle] = deque()
        self._ids = itertools.count()
        S = cfg.slots
        self._slot_req: List[Optional[RequestHandle]] = [None] * S
        self._toks = np.zeros(S, np.int32)
        self._lens = np.zeros(S, np.int32)
        self._active = np.zeros(S, bool)
        self._remaining = np.zeros(S, np.int32)
        self._eos = np.full(S, -1, np.int32)
        self._seeds = np.zeros(S, np.int32)
        self._steps = np.zeros(S, np.int32)

    # ---------------------------------------------------------------- frontend
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None, seed: int = 0,
               trace_ctx=None) -> RequestHandle:
        """Enqueue a request. Raises ``ValueError`` on inadmissible shapes and
        :class:`QueueFullError` (with ``retry_after``) under backpressure.

        ``trace_ctx`` (an ``observability.trace.SpanContext`` or ``None``)
        joins this request's spans to a propagated parent trace."""
        prompt, max_new = validate_admission(
            prompt, max_new_tokens, self.config.default_max_new_tokens,
            self.executor.max_prompt_len, self.cap)
        if len(self.queue) >= self.config.max_queue:
            self.telemetry.on_rejected()
            raise QueueFullError(self.retry_after_hint())
        handle = RequestHandle(
            id=next(self._ids), prompt=prompt, max_new_tokens=max_new,
            eos_token_id=eos_token_id, deadline_s=deadline_s, seed=int(seed),
            arrival=time.monotonic())
        handle._span = self._tracer.begin(
            "replica_request", cat=CAT_SERVING, ctx=trace_ctx,
            t0=handle.arrival,
            attrs={"request_id": handle.id, "prompt_tokens": int(prompt.size),
                   "max_new_tokens": max_new})
        self.queue.append(handle)
        return handle

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def retry_after_hint(self, now: Optional[float] = None) -> float:
        """Load-adaptive backpressure hint (see
        :func:`~.telemetry.adaptive_retry_after`)."""
        cfg = self.config
        return adaptive_retry_after(cfg.retry_after_s, cfg.retry_after_max_s,
                                    len(self.queue), cfg.max_queue,
                                    self.telemetry.drain_rate(now))

    @property
    def active_requests(self) -> List[RequestHandle]:
        return [h for h in self._slot_req if h is not None]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(h is not None for h in self._slot_req)

    # ------------------------------------------------------------------- loop
    def step(self) -> bool:
        """One scheduler iteration: sweep deadlines/cancellations, admit pending
        prompts into free slots, run one decode chunk, retire finished slots.
        Returns True when any request made progress."""
        now = time.monotonic()
        self._sweep_queue(now)
        self._sweep_running(now)
        admitted = self._admit()
        decoded = self._decode_chunk()
        pool = self.executor.pool
        self.telemetry.on_step(
            len(self.queue), pool.occupancy,
            prefix_stats=(None if self.prefix_cache is None
                          else self.prefix_cache.stats()),
            paged_stats=(pool.stats() if pool.paged else None))
        return admitted or decoded

    def run(self, max_steps: int = 100000) -> dict:
        """Drive ``step()`` until queue and slots drain; returns the telemetry
        snapshot."""
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.telemetry.snapshot()

    # ------------------------------------------------------------ prefix cache
    def _insert_prefix(self, handle: RequestHandle, slot: int) -> None:
        """Index the slot's prompt KV in the trie under the full prompt token
        path. Paged pool: SHARE the slot's prompt-covering pages (refcount
        bump — zero-copy, no device gather at all). Slot-row pool: gather a
        slab copy (padded to the prompt bucket) as before."""
        if self.prefix_cache is None:
            return
        P = int(handle.prompt.size)
        if P < self.prefix_cache.config.min_insert_tokens:
            self.prefix_cache.insert_skipped += 1
            return                   # skip the device gather, not just the insert
        if self.prefix_cache.contains(handle.prompt):
            return                   # resident (LRU refreshed): same tokens ⇒
            #   bit-identical slab, don't pay the gather to drop it
        pool = self.executor.pool
        if pool.paged:
            nbytes = pool.pages_for(P) * pool.page_nbytes
            if nbytes > self.prefix_cache.config.max_bytes:
                self.prefix_cache.insert_skipped += 1
                return
            pages = pool.share_prefix(slot, P)
            if not self.prefix_cache.insert_pages(handle.prompt, pages,
                                                  nbytes):
                pool.release_shared(pages)   # resident/refused: drop our refs
            return
        rows = self.executor.bucket_for(P)
        if pool.slab_nbytes(rows) > self.prefix_cache.config.max_bytes:
            self.prefix_cache.insert_skipped += 1
            return                   # could never fit: skip the gather too
        slab = pool.gather_prefix(slot, rows)
        self.prefix_cache.insert(handle.prompt, slab)

    def _retire_prefix(self, handle: RequestHandle, slot: int) -> None:
        """Completion-path insert hook: runs for every request leaving a slot
        through a healthy retirement (finished / cancelled / expired — the
        prefill was paid, so its prompt KV is worth keeping). Eviction paths
        (``evict_all``) deliberately skip it: the pool may be poisoned there.
        """
        if (self.prefix_cache is not None
                and self.prefix_cache.config.insert_on == "completion"):
            self._insert_prefix(handle, slot)

    @property
    def prefix_hit_rate(self) -> float:
        """ADMISSION-level hit rate (successful prefills) — everything named
        ``prefix_hit_rate`` (this, the monitor tags, the snapshot) derives
        from the same counters; the trie's lookup-level rate (which also
        counts failed/retried admissions) is only in
        :meth:`prefix_cache_report`."""
        if self.prefix_cache is None:
            return 0.0
        t = self.telemetry
        n = t.prefix_hits + t.prefix_misses
        return t.prefix_hits / n if n else 0.0

    def prefix_cache_report(self) -> dict:
        """``weight_stream_report()``-style summary of the prefix cache: hit
        accounting, resident slab bytes against budget, and the modeled
        prefill-compute saving (skipped prefill tokens / total prompt tokens
        seen). The ``hits``/``misses``/``hit_rate`` here are the trie's
        LOOKUP-level counters (they also tick on admissions that later fail
        and retry) — everything published as ``prefix_hit_rate`` elsewhere is
        admission-level."""
        if self.prefix_cache is None:
            return {"enabled": False}
        s = self.prefix_cache.stats()
        seen = max(1, s["lookup_tokens"])
        return {
            "enabled": True,
            **s,
            "budget_fill": s["cached_bytes"] / max(1, s["max_bytes"]),
            "prefill_tokens_skipped_frac": s["hit_tokens"] / seen,
        }

    def _rebuild_pool(self) -> None:
        """Discard and rebuild the KV pool after a failure that may have left it
        half-written (or still being written by an abandoned chunk). On the
        paged pool the prefix cache's shared pages live inside the discarded
        tensors, so its device rung is dropped with it, without spilling:
        gathering from a poisoned pool is not trustworthy. Host-rung entries
        are independent host slabs and survive to serve promote hits against
        the rebuilt pool, as the slot pool's independent gathered slabs do."""
        if self.executor.paged and self.prefix_cache is not None:
            self.prefix_cache.drop_device()
        self.executor.reset_pool()

    # --------------------------------------------------------------- eviction
    def evict_all(self, reason: str = "evicted") -> List[RequestHandle]:
        """Evict every queued and in-flight request with its generated-so-far
        prefix: each handle finalizes as ``EVICTED`` (tokens kept), the slot
        tables are cleared and the KV pool rebuilt.

        An evicted handle can be re-enqueued as ``prompt + tokens`` with the
        remaining budget, and greedy decode continues prefix-consistently: the
        request, not a checkpoint, is the unit of recovery (a router's
        checkpointless retry, ROADMAP.md queue 1 item 9).
        """
        now = time.monotonic()
        out: List[RequestHandle] = []
        for h in self.queue:
            self._finalize(h, RequestState.EVICTED, reason, now)
            out.append(h)
        self.queue.clear()
        for slot, h in enumerate(self._slot_req):
            if h is None:
                continue
            self._finalize(h, RequestState.EVICTED, reason, now)
            out.append(h)
            self._slot_req[slot] = None
        self._active[:] = False
        self._remaining[:] = 0
        self._steps[:] = 0
        self._eos[:] = -1
        # rebuild rather than per-slot zero-fill: on the death path the old
        # buffers may be inside a failed/wedged dispatch and cannot be trusted
        self._rebuild_pool()
        return out

    # ----------------------------------------------------------------- sweeps
    def _expired(self, handle: RequestHandle, now: float) -> bool:
        return (handle.deadline_s is not None
                and now - handle.arrival > handle.deadline_s)

    def _sweep_queue(self, now: float) -> None:
        kept = deque()
        for h in self.queue:
            if h._cancel:
                self._finalize(h, RequestState.CANCELLED, "cancelled", now)
            elif self._expired(h, now):
                self._finalize(h, RequestState.EXPIRED, "deadline", now)
            else:
                kept.append(h)
        self.queue = kept

    def _sweep_running(self, now: float) -> None:
        for slot, h in enumerate(self._slot_req):
            if h is None:
                continue
            if h._cancel:
                self._retire_prefix(h, slot)   # prefill was paid: keep its KV
                self._finalize(h, RequestState.CANCELLED, "cancelled", now)
                self._release(slot)
            elif self._expired(h, now):
                self._retire_prefix(h, slot)
                self._finalize(h, RequestState.EXPIRED, "deadline", now)
                self._release(slot)

    # -------------------------------------------------------------- admission
    def _admit(self) -> bool:
        admitted = False
        cfg = self.config
        tracer = self._tracer
        while self.queue:
            pool = self.executor.pool    # re-read: a failed hit-prefill below
            head = self.queue[0]         # rebuilds the pool mid-loop
            # page-count admission: the paged pool admits when the request's
            # OWN reservation (prompt + budget, page-granular) fits — not when
            # a whole cap-row slot frees up. Conservative (all-fresh) check:
            # a prefix hit can only need fewer pages. The slot pool reduces
            # to its free-slot check. FIFO: a head that doesn't fit waits.
            need_tokens = int(head.prompt.size) + int(head.max_new_tokens)
            if self.proposer is not None:
                # speculation headroom: a verify window writes up to spec_k
                # draft rows past the committed length before the accept
                # rule trims them; admit only when those rows fit too.
                # Clamped to the cap: the per-slot window limit already
                # shrinks the window near the cap edge.
                need_tokens = min(need_tokens + self._spec_cfg.k, self.cap)
            if not pool.can_admit(need_tokens):
                # admission-pressure eviction (paged): cached prefixes pin
                # real pool pages, so a full free list trades the coldest
                # cached prefixes for admission capacity before giving up —
                # a waiting request always outranks a cold cached prefix.
                # Only entries holding a refcount-1 page are worth dropping:
                # evicting one whose pages live slots still bind frees
                # nothing, and would just empty the cache for no capacity.
                # Peek the head's own prefix first (stats/LRU-free): its
                # matching entry must survive the sweep — evicting it would
                # trade the head's zero-copy hit for a full prefill — and a
                # hit shrinks the fresh-page need to the unshared suffix.
                # ... but ONLY when pages are the shortage: evicting cached
                # prefixes frees pages, never slots, so a queue blocked on a
                # full slot set must not drain the cache for zero gain.
                matched_hint = 0
                if pool.paged and self.prefix_cache is not None \
                        and pool.free_slots > 0:
                    matched_hint, keep = self.prefix_cache.peek(head.prompt)
                    if keep is not None and keep.pages is None:
                        # host-rung match: the promote path acquires all-fresh
                        # pages, so the hint must not shrink the page need
                        matched_hint = 0
                    frees = lambda e: e is not keep and \
                        e.pages is not None and any(  # noqa: E731
                            pool.page_ref(p) == 1 for p in e.pages)
                    while not pool.can_admit(need_tokens,
                                             matched=matched_hint) and \
                            self.prefix_cache.evict_lru(frees):
                        pass
                if not pool.can_admit(need_tokens, matched=matched_hint):
                    break
            handle = self.queue.popleft()
            admit_t = time.monotonic()
            tracer.record_span("queue_wait", handle._span,
                               handle.arrival, admit_t)
            matched, entry = 0, None
            if self.prefix_cache is not None:
                t_lk = time.monotonic()
                matched, entry = self.prefix_cache.lookup(handle.prompt)
                tracer.record_span("prefix_lookup", handle._span, t_lk,
                                   time.monotonic(),
                                   attrs={"hit": entry is not None,
                                          "matched_tokens": int(matched)})
            if pool.paged and entry is not None and entry.pages is not None:
                # zero-copy hit: bind the shared prefix pages into the fresh
                # slot's table (refcount bump + one COW boundary page) — the
                # paged replacement for the slab restore scatter
                slot = pool.acquire(need_tokens, prefix_pages=entry.pages,
                                    matched=matched)
            else:
                # miss, slot-pool hit, or host-rung PROMOTE hit (entry with a
                # spilled host slab): all-fresh pages; the promote restores
                # the slab into them inside prefill_into_slot
                slot = pool.acquire(need_tokens)
            if slot is None:   # can_admit is conservative, so only a racing
                self.queue.appendleft(handle)          # caller could land here
                break

            def attempt(h=handle, s=slot, m=matched, e=entry):
                fault_point("serving.prefill")
                if e is not None:
                    return self.executor.prefill_into_slot(
                        s, h.prompt, h.seed, prefix_len=m,
                        prefix_slab=e.slab, trace_ctx=h._span)
                return self.executor.prefill_into_slot(s, h.prompt, h.seed,
                                                       trace_ctx=h._span)

            prefill_span = tracer.start_span(
                "prefill", parent=handle._span,
                attrs={"slot": slot, "prefix_len": int(matched)
                       if entry is not None else 0})
            try:
                tok0, _ = retry_with_backoff(attempt,
                                             retries=cfg.transient_retries,
                                             base_delay=cfg.retry_base_delay)
            except Exception as e:
                tracer.end_span(prefill_span,
                                attrs={"outcome": "error",
                                       "error": type(e).__name__})
                # retry budget exhausted: fail THIS request, keep serving — the
                # slot must not leak and the loop must not die with the queue
                # still holding live requests
                logger.error(f"[serving] prefill failed for request "
                             f"{handle.id}: {type(e).__name__}: {e}")
                now = time.monotonic()
                self._finalize(handle, RequestState.CANCELLED, "error", now)
                if entry is not None:
                    # cache-hit path: the suffix prefill writes the pool
                    # itself (the miss path's prefill writes a batch-1 cache),
                    # so a failure here may have left it half-written. Same
                    # recovery as a failed decode chunk: fail the in-flight
                    # requests, rebuild the pool, keep serving.
                    logger.error("[serving] failed prefill was a prefix-cache "
                                 "hit (it writes the pool); failing "
                                 f"{sum(h is not None for h in self._slot_req)}"
                                 " in-flight request(s) and rebuilding the "
                                 "KV pool")
                    for s2, h2 in enumerate(self._slot_req):
                        if h2 is not None:
                            self._finalize(h2, RequestState.CANCELLED,
                                           "error", now)
                            self._slot_req[s2] = None
                    self._active[:] = False
                    self._remaining[:] = 0
                    self._steps[:] = 0
                    self._eos[:] = -1
                    self._rebuild_pool()
                else:
                    self._release(slot)
                continue
            now = time.monotonic()
            tracer.end_span(prefill_span, t1=now,
                            attrs={"outcome": "ok",
                                   "prefix_hit": entry is not None})
            handle.state = RequestState.RUNNING
            handle.slot = slot
            handle.tokens.append(int(tok0))
            handle.first_token_at = now
            handle.ttft = now - handle.arrival
            handle.prefix_hit_tokens = matched if entry is not None else 0
            self.telemetry.on_prefix(entry is not None,
                                     handle.prefix_hit_tokens,
                                     enabled=self.prefix_cache is not None)
            if (self.prefix_cache is not None
                    and self.prefix_cache.config.insert_on == "prefill"):
                self._insert_prefix(handle, slot)
            eos = -1 if handle.eos_token_id is None else int(handle.eos_token_id)
            if tok0 == eos or handle.max_new_tokens == 1:
                self._retire_prefix(handle, slot)
                self._finalize(handle, RequestState.FINISHED,
                               "eos" if tok0 == eos else "length", now)
                self._release(slot)
            else:
                self._slot_req[slot] = handle
                self._toks[slot] = tok0
                self._lens[slot] = handle.prompt.size
                self._active[slot] = True
                self._remaining[slot] = handle.max_new_tokens - 1
                self._eos[slot] = eos
                self._seeds[slot] = handle.seed
                self._steps[slot] = 1       # token 0 came from prefill
            admitted = True
        return admitted

    # ----------------------------------------------------------------- decode
    def _decode_chunk(self) -> bool:
        if not self._active.any():
            return False
        cfg = self.config
        steps_before = self._steps.copy()

        def attempt():
            fault_point("serving.decode_chunk")
            if self.proposer is not None:
                return self._spec_round()
            return self.executor.run_chunk(
                self._toks, self._lens, self._active, self._remaining,
                self._eos, self._seeds, self._steps)

        try:
            res = retry_with_backoff(attempt, retries=cfg.transient_retries,
                                     base_delay=cfg.retry_base_delay)
        except Exception as e:
            # retry budget exhausted mid-decode: the pool may be half-written
            # by a chunk that died (or still running, abandoned by the
            # watchdog), so it cannot be trusted: fail every in-flight
            # request, rebuild the pool, keep serving the queue (the same
            # never-kill-the-loop contract as admission)
            logger.error(f"[serving] decode chunk failed: "
                         f"{type(e).__name__}: {e}; failing "
                         f"{sum(h is not None for h in self._slot_req)} "
                         "in-flight request(s) and rebuilding the KV pool")
            now = time.monotonic()
            for slot, h in enumerate(self._slot_req):
                if h is not None:
                    self._finalize(h, RequestState.CANCELLED, "error", now)
                    self._slot_req[slot] = None
            self._active[:] = False
            self._remaining[:] = 0
            self._steps[:] = 0
            self._eos[:] = -1
            self._rebuild_pool()
            return False
        now = time.monotonic()
        counts = res.steps - steps_before
        total = 0
        chunk_t0 = now - res.elapsed
        chunk_idx = self.telemetry._chunk_idx + 1
        for slot, h in enumerate(self._slot_req):
            if h is None or counts[slot] <= 0:
                continue
            h.tokens.extend(res.buf[slot, :counts[slot]].tolist())
            total += int(counts[slot])
            # one span per participating request: the chunk is a batch-level
            # dispatch, but "where did THIS request's time go" needs it on the
            # request's own trace. Guarded: tracing-off must not build attrs
            # dicts on the hottest loop.
            if h._span is not None:
                self._tracer.record_span(
                    "decode_chunk", h._span, chunk_t0, now,
                    attrs={"chunk": chunk_idx, "slot": slot,
                           "tokens": int(counts[slot])})
        was_active = self._active.copy()
        self._toks = res.toks[:, 0].copy()
        self._lens = res.lens.copy()
        self._remaining = res.remaining.copy()
        self._steps = res.steps.copy()
        self._active = res.active.copy()
        for slot in np.nonzero(was_active & ~res.active)[0]:
            h = self._slot_req[int(slot)]
            if h is None:
                continue
            reason = ("eos" if h.eos_token_id is not None
                      and h.tokens and h.tokens[-1] == h.eos_token_id
                      else "length")
            self._retire_prefix(h, int(slot))
            self._finalize(h, RequestState.FINISHED, reason, now)
            self._release(int(slot))
        self.telemetry.on_chunk(total, res.elapsed)
        if self.proposer is not None:
            self.telemetry.on_spec(res.proposed, res.accepted, total, res.draft_s,
                                   res.elapsed)
        return True

    def _spec_round(self):
        """Draft each active slot's window on the host and run one verify
        round through the executor."""
        t0 = time.perf_counter()
        proposals, spec_lens = self._spec_windows()
        draft_s = time.perf_counter() - t0
        res = self.executor.run_spec_round(
            self._toks, self._lens, self._active, self._remaining,
            self._eos, self._seeds, self._steps, proposals, spec_lens)
        res.draft_s = draft_s
        return res

    def _spec_windows(self):
        """Each active slot's draft ``(proposals (S, k), spec_lens (S,))``. The
        proposer reads the request's prompt and tokens: host state, so a
        retry re-derives the same drafts."""
        k = self._spec_cfg.k
        S = self.config.slots
        proposals = np.zeros((S, k), np.int32)
        spec_lens = np.zeros(S, np.int32)
        for slot, h in enumerate(self._slot_req):
            if h is None or not self._active[slot]:
                continue
            # window rows [lens, lens + L] must fit the cap, and an L-token
            # draft can emit L + 1 tokens: slots at the cap or budget edge get
            # a shorter (possibly empty) window, the plain one-token step
            # through the same shape
            limit = min(k, self.cap - 1 - int(self._lens[slot]),
                        int(self._remaining[slot]) - 1)
            if limit <= 0:
                continue
            ctx = np.concatenate([h.prompt.astype(np.int32), np.asarray(h.tokens, np.int32)])
            draft = np.asarray(self.proposer.propose(ctx, limit), np.int32)
            L = min(int(draft.size), limit)
            if L > 0:
                proposals[slot, :L] = draft[:L]
                spec_lens[slot] = L
        return proposals, spec_lens

    # --------------------------------------------------------------- lifecycle
    def _finalize(self, handle: RequestHandle, state: RequestState,
                  reason: str, now: float) -> None:
        handle.state = state
        handle.finish_reason = reason
        handle.finished_at = now
        if (handle.first_token_at is not None and len(handle.tokens) > 1
                and now > handle.first_token_at):
            handle.tpot = (now - handle.first_token_at) / (len(handle.tokens) - 1)
        if handle._span is not None:
            self._tracer.instant("retire", handle._span,
                                 attrs={"state": state.value,
                                        "reason": reason})
            self._tracer.end_span(
                handle._span, t1=now,
                attrs={"state": state.value, "reason": reason,
                       "tokens": len(handle.tokens)})
            handle._span = None
        self.telemetry.on_finished(handle)

    def _release(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._active[slot] = False
        self._remaining[slot] = 0
        self._steps[slot] = 0
        self._eos[slot] = -1
        self.executor.pool.release(slot)
