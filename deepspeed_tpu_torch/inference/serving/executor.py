"""Chunked decode executor: fixed-shape decode chunks over a slot-batch.

Counterpart of ``deepspeed_tpu/inference/serving/executor.py``. Decode runs in
chunks of K steps over a fixed slot-batch and returns to the host between
chunks: the window in which the continuous-batching scheduler retires
finished requests, recycles their KV slots and prefills pending prompts,
while the other slots keep decoding. Prompts are right-padded to
power-of-two buckets (``prompt_buckets``), as in JAX, so prefill shapes stay
few.

PyTorch runs eagerly, so there is nothing to compile or cache; a chunk is a
Python loop (``decode_fns``) whose per-slot state stays on the device, and
its one host synchronisation is the harvest at its end. The pools are
updated in place (JAX donates them into each dispatch and rebinds the
outputs): a chunk writes into the tensors of the pool object it started
with, and :meth:`reset_pool` builds a new pool with new tensors rather than
zeroing the old ones, which a chunk abandoned by the watchdog may still be
writing.

Watchdog: with ``chunk_deadline_s`` set, each chunk (launch and harvest) runs
on a worker thread and an overrun raises :class:`ChunkTimeoutError` instead of
blocking the scheduler forever. The timed region declares the
``serving.chunk_compute`` fault point, and :meth:`stall_next` models a hang
deterministically. After a timeout the caller must :meth:`reset_pool` (the
scheduler's decode-failure path does). A speculative verify round
(:meth:`run_spec_round`) runs under the same watchdog, with the fault point
``serving.spec_verify``.
"""

import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...models.causal_lm import init_cache
from ...observability import profiler as obs_profiler
from ...observability.trace import get_tracer
from ...ops.paged_attention import gather_kv_dense
from ...utils.fault_injection import fault_point
from ...utils.nvtx import annotate
from ..decode_fns import (decode_chunk, make_slot_select_fn, paged_decode_chunk,
                          paged_spec_verify, prefill, prefix_prefill, spec_verify)
from ..speculative import accept_drawn, window_draws
from .kv_pool import PagedKVPool, SlotKVPool


class ChunkTimeoutError(RuntimeError):
    """A decode chunk exceeded its wall-clock deadline. Not a retryable
    transient: the chunk may still be writing the pool, so the only safe
    recovery is to evict and rebuild the pool."""

    def __init__(self, deadline_s: float):
        super().__init__(f"decode chunk exceeded its {deadline_s:.3f}s deadline")
        self.deadline_s = float(deadline_s)


def prompt_buckets(max_prompt_len: int, smallest: int = 8) -> Tuple[int, ...]:
    """Power-of-two right-pad buckets covering ``[1, max_prompt_len]``."""
    buckets = []
    b = smallest
    while b < max_prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_prompt_len)
    return tuple(buckets)


@dataclass
class ChunkResult:
    """Host view of one decode chunk (everything already fetched)."""
    buf: np.ndarray          # (S, K) emitted tokens; per-slot real prefix only
    toks: np.ndarray         # (S, 1) each slot's last token
    lens: np.ndarray         # (S,) KV append positions
    active: np.ndarray       # (S,) bool
    remaining: np.ndarray    # (S,) decode budget left
    steps: np.ndarray        # (S,) per-request tokens emitted so far
    elapsed: float           # wall seconds for launch + harvest


@dataclass
class SpecResult(ChunkResult):
    """One speculative verify round, harvest-compatible with a chunk: ``buf``
    is ``(S, k + 1)`` wide and a slot's real tokens are the prefix of length
    ``steps_out - steps_in``, so the scheduler's chunk harvest works
    unchanged. ``proposed``/``accepted`` feed the ``serving/spec_*``
    telemetry; the scheduler fills ``draft_s`` (the proposer runs on the host
    before the launch)."""
    proposed: int = 0        # real draft tokens offered this round
    accepted: int = 0        # draft tokens that survived accept/reject
    draft_s: float = 0.0     # host proposer wall seconds


class ChunkedDecodeExecutor:
    """Drives prefill-into-slot and K-step decode chunks for a scheduler, on
    the engine's device."""

    def __init__(self, engine, slots: int, cap: int, chunk_size: int,
                 do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, max_prompt_len: Optional[int] = None,
                 base_seed: int = 0, chunk_deadline_s: Optional[float] = None,
                 cold_chunk_grace_s: float = 120.0, kv_pool: str = "paged",
                 kv_page_size: int = 16, kv_total_pages: Optional[int] = None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if chunk_deadline_s is not None and chunk_deadline_s <= 0:
            raise ValueError("chunk_deadline_s must be positive when set, got "
                             f"{chunk_deadline_s}")
        if kv_pool not in ("paged", "slots"):
            raise ValueError(f"kv_pool must be 'paged' or 'slots', got {kv_pool!r}")
        self.engine = engine
        self.device = engine.device
        self.slots = int(slots)
        self.cap = int(cap)
        self.chunk_size = int(chunk_size)
        self.max_prompt_len = int(max_prompt_len or cap - 1)
        if self.max_prompt_len >= self.cap:
            raise ValueError("max_prompt_len must leave room for at least one "
                             f"generated token (cap={self.cap})")
        self.sampling = (bool(do_sample), float(temperature), int(top_k), float(top_p))
        self.buckets = prompt_buckets(self.max_prompt_len)
        self.kv_pool_kind = kv_pool
        self.kv_page_size = int(kv_page_size)
        self.kv_total_pages = kv_total_pages
        self.pool = self._build_pool()
        self._select = make_slot_select_fn(*self.sampling)
        self.base_seed = int(base_seed)
        # the fused paged chunk attends through the paged kernel; ALiBi, whose
        # bias the kernel does not take, gathers the dense view once a chunk
        self.fused = engine.model_config.pos_emb != "alibi"
        self.chunk_deadline_s = chunk_deadline_s
        self.cold_chunk_grace_s = float(cold_chunk_grace_s)
        self._warm_chunk = False        # the first successful chunk marks warm
        self._stall_next = 0.0
        self._restore_kill = None       # chaos hook between bind/restore and prefill

    @property
    def chunk_warm(self) -> bool:
        """True once a chunk has completed: from then ``chunk_deadline_s`` holds
        at face value (the first chunk gets ``cold_chunk_grace_s``, for the
        kernels' first build)."""
        return self._warm_chunk

    def arm_restore_kill(self, callback) -> None:
        """Chaos hook: call ``callback`` once, between the prefix bind/restore and
        the suffix prefill of the next cache-hit admission, then abort that
        admission attempt."""
        self._restore_kill = callback

    def stall_next(self, seconds: float) -> None:
        """Chaos hook: make the next chunk stall ``seconds`` inside the timed
        region, a stand-in for a hung kernel. With ``chunk_deadline_s`` set the
        watchdog turns it into a :class:`ChunkTimeoutError`."""
        self._stall_next = float(seconds)

    def _build_pool(self):
        cfg, dtype = self.engine.model_config, self.engine.dtype
        if self.kv_pool_kind == "paged":
            return PagedKVPool(cfg, self.slots, self.cap, page_size=self.kv_page_size,
                               dtype=dtype, total_pages=self.kv_total_pages,
                               device=self.device)
        return SlotKVPool(cfg, self.slots, self.cap, dtype=dtype, device=self.device)

    @property
    def paged(self) -> bool:
        return self.kv_pool_kind == "paged"

    def reset_pool(self) -> None:
        """Discard the pool and build a new one, every slot free. The old
        tensors are left to whoever still holds them (a chunk the watchdog
        abandoned), never zeroed in place. On the paged pool this voids every
        page the prefix cache refers to; the scheduler drops its device rung
        alongside (``_rebuild_pool``)."""
        self.pool = self._build_pool()

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds max_prompt_len="
                         f"{self.max_prompt_len}")

    def _dispatch_watched(self, timed):
        """Run ``timed`` under the chunk watchdog when one is armed: on a worker
        thread, :class:`ChunkTimeoutError` on overrun. The first chunk is
        granted ``cold_chunk_grace_s``."""
        if self.chunk_deadline_s is None:
            return timed()
        deadline = (self.chunk_deadline_s if self._warm_chunk
                    else max(self.chunk_deadline_s, self.cold_chunk_grace_s))
        box = {}

        def runner():
            try:
                box["out"] = timed()
            except BaseException as e:          # surfaced on the caller's thread
                box["exc"] = e

        th = threading.Thread(target=runner, daemon=True, name="ds-serve-chunk-watchdog")
        th.start()
        th.join(deadline)
        if th.is_alive():
            raise ChunkTimeoutError(deadline)
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def _first_token(self, logits: torch.Tensor, seed: int) -> int:
        """The request's token 0 from ``(1, V)`` logits, synchronised to the
        host on purpose: the scheduler's TTFT stops here."""
        tok0 = self._select(logits, self.base_seed, self._i32([seed]), self._i32([0]))
        return int(tok0[0, 0])

    # -------------------------------------------------------------------- steps
    def prefill_into_slot(self, slot: int, prompt: np.ndarray, seed: int = 0,
                          prefix_len: int = 0, prefix_slab=None,
                          trace_ctx=None) -> Tuple[int, float]:
        """Prefill ``prompt`` (1-D int tokens) into ``slot``.

        With ``prefix_len > 0`` (a prefix-cache hit) the slot already holds the
        prefix (paged: its pages were bound at admission; a host-tier
        ``prefix_slab`` is promoted into them here; slot pool: ``prefix_slab``
        is restored here) and only the suffix ``prompt[prefix_len:]`` is
        prefilled, bucketed by its own length. The ``serving.prefix_restore``
        fault point sits between the restore/bind and the suffix prefill.

        Returns ``(first_token, prefill_seconds)``."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        t = prompt.shape[0]
        tracer = get_tracer()
        if prefix_len:
            return self._suffix_prefill(slot, prompt, seed, prefix_len, prefix_slab,
                                        trace_ctx)
        bucket = self.bucket_for(t)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :t] = prompt
        t0 = time.perf_counter()
        tb0 = time.monotonic()
        with annotate("serving.prefill"), torch.no_grad():
            one = init_cache(self.engine.model_config, 1, self.cap, dtype=self.engine.dtype,
                             device=self.device)
            logits = prefill(self.engine.module, torch.from_numpy(ids).to(self.device), one,
                             self._i32([t]))
            tok0 = self._first_token(logits, seed)
        tracer.record_span("bucket_prefill", trace_ctx, tb0, time.monotonic(),
                           attrs={"bucket": bucket, "prompt_tokens": int(t)})
        dt = time.perf_counter() - t0
        self.pool.scatter_prefill(slot, one)
        obs_profiler.tick("prefill")
        return tok0, dt

    def _suffix_prefill(self, slot, prompt, seed, prefix_len, prefix_slab, trace_ctx):
        t = prompt.shape[0]
        if not 0 < prefix_len < t:
            raise ValueError(f"prefix_len must be in (0, prompt_len={t}), got {prefix_len}")
        tracer = get_tracer()
        pool = self.pool
        suffix = prompt[prefix_len:]
        bucket = self.bucket_for(suffix.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :suffix.size] = suffix
        t0 = time.perf_counter()
        tr0 = time.monotonic()
        if self.paged and prefix_slab is None:
            # zero-copy hit: the prefix pages were bound into the slot's table
            # at admission (refcount bump, one copy-on-write page)
            tracer.record_span("bind_prefix", trace_ctx, tr0, time.monotonic(),
                               attrs={"slot": slot, "prefix_len": int(prefix_len)})
        else:
            with annotate("serving.restore_prefix"):
                if self.paged:   # host-tier promote into all-fresh pages
                    pool.promote_prefix(slot, prefix_slab, prefix_len)
                else:
                    pool.restore_prefix(slot, prefix_slab)
            tracer.record_span("restore_prefix", trace_ctx, tr0, time.monotonic(),
                               attrs={"slot": slot, "prefix_len": int(prefix_len),
                                      "promoted": self.paged})
        fault_point("serving.prefix_restore")
        if self._restore_kill is not None:
            cb, self._restore_kill = self._restore_kill, None
            cb()
            raise RuntimeError("chaos: replica killed between prefix restore/bind and "
                               "suffix prefill")
        ts0 = time.monotonic()
        with annotate("serving.suffix_prefill"), torch.no_grad():
            if self.paged:
                # the slot's pages gathered into a dense batch-1 view; the suffix
                # forward writes its rows there, and only the suffix's own rows
                # [prefix_len, t) go back, into pages the slot owns (shared
                # prefix pages are read, never written)
                table = self._i32(pool.page_table[slot:slot + 1])
                one = [dict(zip(("k", "v"), (x.contiguous() for x in gather_kv_dense(
                    c["k"], c["v"], table, self.cap)))) for c in pool.caches]
            else:
                # a view of the slot's own row: the forward writes the pool
                one = [{"k": c["k"][slot:slot + 1], "v": c["v"][slot:slot + 1]}
                       for c in pool.caches]
            logits = prefix_prefill(self.engine.module, torch.from_numpy(ids).to(self.device),
                                    one, self._i32([prefix_len]), self._i32([suffix.size]))
            if self.paged:
                rows = np.arange(prefix_len, t)
                pages = pool.page_table[slot, rows // pool.page_size]
                pidx = torch.as_tensor(pages.astype(np.int64), device=self.device)
                off = torch.as_tensor(rows % pool.page_size, device=self.device)
                rows_t = torch.as_tensor(rows, device=self.device)
                for c, o in zip(pool.caches, one):
                    c["k"][pidx, :, off] = o["k"][0][:, rows_t].transpose(0, 1)
                    c["v"][pidx, :, off] = o["v"][0][:, rows_t].transpose(0, 1)
            tok0 = self._first_token(logits, seed)
        tracer.record_span("suffix_prefill", trace_ctx, ts0, time.monotonic(),
                           attrs={"bucket": bucket, "suffix_tokens": int(suffix.size)})
        obs_profiler.tick("prefill")
        return tok0, time.perf_counter() - t0

    def run_chunk(self, toks: np.ndarray, lens: np.ndarray, active: np.ndarray,
                  remaining: np.ndarray, eos_ids: np.ndarray, seeds: np.ndarray,
                  steps: np.ndarray) -> ChunkResult:
        """One K-step chunk over the slot-batch, writing the pool in place; the
        other state comes in and goes out as host numpy, uploaded once at the
        start and fetched once at the end.

        With ``chunk_deadline_s`` set, launch and harvest run on a watchdog
        thread; an overrun raises :class:`ChunkTimeoutError` and the pool must
        be rebuilt (``reset_pool``)."""
        # the pool this chunk writes, taken on this thread: if the watchdog
        # abandons the chunk and the caller rebuilds the pool, the late chunk
        # goes on writing the old tensors, never the new pool's
        pool = self.pool
        dev = self.device
        args = (self._i32(toks).reshape(-1, 1), self._i32(lens),
                torch.as_tensor(np.asarray(active, bool), device=dev), self._i32(remaining),
                self._i32(eos_ids), self._i32(seeds), self._i32(steps))
        # the table is host state bound at admission; uploaded once a chunk
        table = self._i32(pool.page_table) if self.paged else None
        t0 = time.perf_counter()

        def timed():
            # what a deadline must cover: injected stalls, the launches and the
            # harvest (a hung kernel shows at the harvest)
            fault_point("serving.chunk_compute")
            if self._stall_next > 0:
                stall, self._stall_next = self._stall_next, 0.0
                time.sleep(stall)
            with annotate("serving.decode_chunk"), torch.no_grad():
                toks_d, lens_d, active_d, remaining_d, eos_d, seeds_d, steps_d = args
                if self.paged:
                    out = paged_decode_chunk(self.engine.module, self._select,
                                             self.chunk_size, self.cap, self.fused, toks_d,
                                             pool.caches, table, lens_d, active_d,
                                             remaining_d, eos_d, seeds_d, steps_d,
                                             self.base_seed)
                else:
                    out = decode_chunk(self.engine.module, self._select, self.chunk_size,
                                       toks_d, pool.caches, lens_d, active_d, remaining_d,
                                       eos_d, seeds_d, steps_d, self.base_seed)
                # the chunk's harvest: its one host synchronisation
                return tuple(x.cpu().numpy() for x in out)

        buf, toks_d, lens_d, active_d, remaining_d, steps_d = self._dispatch_watched(timed)
        self._warm_chunk = True
        obs_profiler.tick("decode_chunk")
        return ChunkResult(buf=buf, toks=toks_d, lens=lens_d, active=active_d,
                           remaining=remaining_d, steps=steps_d,
                           elapsed=time.perf_counter() - t0)

    def run_spec_round(self, toks: np.ndarray, lens: np.ndarray, active: np.ndarray,
                       remaining: np.ndarray, eos_ids: np.ndarray, seeds: np.ndarray,
                       steps: np.ndarray, proposals: np.ndarray,
                       spec_lens: np.ndarray) -> SpecResult:
        """One draft-verify round over the slot-batch: a single target forward
        scores every slot's ``[cur_tok, draft...]`` window, writing the pool in
        place, the accept rule runs on the host, and committing is a
        per-slot ``lens`` advance.

        ``proposals (S, k)`` holds each slot's draft (pad past ``spec_lens[s]``
        is arbitrary: pad rows are neither committed nor written to pages,
        and their logits are never read). A slot with ``spec_lens == 0`` takes
        a plain one-token step through the same window shape: that is how
        the cap and budget edges and a dry proposer are served, with no
        other path. The round's one host synchronisation fetches what the
        accept rule reads (:func:`~..speculative.window_draws`; greedy: the
        ``(S, k + 1)`` argmax). Watchdog and recovery as :meth:`run_chunk`,
        with the fault point ``serving.spec_verify``."""
        pool = self.pool
        toks = np.asarray(toks, np.int32).reshape(-1)
        S = toks.size
        proposals = np.asarray(proposals, np.int32).reshape(S, -1)
        k = int(proposals.shape[1])
        spec_lens = np.asarray(spec_lens, np.int32)
        args = (self._i32(np.concatenate([toks[:, None], proposals], axis=1)),
                self._i32(lens), self._i32(spec_lens + 1),
                torch.as_tensor(np.asarray(active, bool), device=self.device),
                self._i32(seeds), self._i32(steps))
        table = self._i32(pool.page_table) if self.paged else None
        t0 = time.perf_counter()

        def timed():
            # the seam between the proposer's window and the verify launch
            fault_point("serving.spec_verify")
            if self._stall_next > 0:
                stall, self._stall_next = self._stall_next, 0.0
                time.sleep(stall)
            with annotate("serving.spec_verify"), torch.no_grad():
                ids_d, lens_d, valid_d, active_d, seeds_d, steps_d = args
                if self.paged:
                    logits = paged_spec_verify(self.engine.module, ids_d, pool.caches, table,
                                               lens_d, valid_d, active_d, self.cap)
                else:
                    logits = spec_verify(self.engine.module, ids_d, pool.caches, lens_d)
                # the round's harvest: its one host synchronisation
                return window_draws(logits, ids_d[:, 1:], self.sampling, self.base_seed,
                                    seeds_d, steps_d)

        draws = self._dispatch_watched(timed)
        self._warm_chunk = True
        obs_profiler.tick("spec_verify")

        buf = np.zeros((S, k + 1), np.int32)
        toks_out = toks.copy()
        lens_out = np.asarray(lens, np.int32).copy()
        active_out = np.asarray(active, bool).copy()
        remaining_out = np.asarray(remaining, np.int32).copy()
        steps_out = np.asarray(steps, np.int32).copy()
        proposed = accepted = 0
        for s in range(S):
            if not active_out[s]:
                continue
            L = int(spec_lens[s])
            proposed += L
            emitted, acc = accept_drawn(proposals[s, :L], draws, s)
            accepted += acc
            # the chunk's semantics on the emitted stream: clamp to the
            # budget, cut at the first EOS (inclusive), then commit
            r = int(remaining_out[s])
            emitted = emitted[:r]
            eos = int(eos_ids[s])
            if eos >= 0 and eos in emitted:
                emitted = emitted[:emitted.index(eos) + 1]
            e = len(emitted)
            buf[s, :e] = emitted
            toks_out[s] = emitted[-1]
            lens_out[s] += e
            steps_out[s] += e
            remaining_out[s] = r - e
            if remaining_out[s] <= 0 or (eos >= 0 and emitted[-1] == eos):
                active_out[s] = False
        return SpecResult(buf=buf, toks=toks_out.reshape(-1, 1), lens=lens_out,
                          active=active_out, remaining=remaining_out, steps=steps_out,
                          elapsed=time.perf_counter() - t0, proposed=proposed,
                          accepted=accepted)
