"""The port's continuous-batching serving against the JAX package's, on the CPU.

The same weights (``causal_lm_params_from_jax``) serve the same requests
through JAX's ``ContinuousBatchingScheduler`` and the port's, f32 on the
CPU, for gpt2, llama with GQA and bloom with ALiBi: a miss, a page-aligned
prefix hit, an unaligned hit that copies its boundary page, and mixed
lengths, on the paged pool and on the slot-row pool. Greedy tokens must
equal JAX's and the port's own ``generate`` exactly. The model's paged
decode step and suffix prefill are held to JAX's at the logits (1e-4, the
port's model tolerance). The rest is the scheduler's own contract:
backpressure, cancellation, deadlines, the chunk watchdog and pool rebuild,
and sampling that depends on a request's seed and nothing else.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.inference.serving import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.models import causal_lm as jax_lm
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference import decode_fns
from deepspeed_tpu_torch.inference.serving import (ChunkTimeoutError,
                                                   ContinuousBatchingScheduler,
                                                   PrefixCacheConfig, QueueFullError,
                                                   RequestState, ServingConfig)
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.paged_attention import gather_kv_dense

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
CAP = 48
FAMILIES = {"gpt2": ("gpt2", {}), "llama-gqa": ("llama", {"n_kv_head": 2}),
            "bloom-alibi": ("bloom", {})}


def _engines(name):
    family, extra = FAMILIES[name]
    jcfg = jax_lm.FAMILIES[family](**TINY, **extra, dtype=jnp.float32)
    jeng = JaxInferenceEngine(jcfg, JaxInferenceConfig(dtype="float32", max_out_tokens=CAP))
    tcfg = torch_lm.FAMILIES[family](**TINY, **extra, dtype=torch.float32)
    params = causal_lm_params_from_jax(jax.device_get(jeng.params), tcfg)
    teng = dst.init_inference((tcfg, params), {"dtype": "float32", "max_out_tokens": CAP},
                              device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def gpt2():
    return _engines("gpt2")


def _serving(cls, cache_cls, kv_pool="paged", **over):
    kw = dict(slots=2, chunk_size=3, max_seq_len=CAP, retry_base_delay=0.001, kv_pool=kv_pool,
              kv_page_size=8, prefix_cache=cache_cls(min_hit_tokens=4, min_insert_tokens=4,
                                                     insert_on="prefill"))
    kw.update(over)
    return cls(**kw)


def _requests(seed):
    """A miss, a page-aligned hit (16 of page 8), an unaligned hit (13), a
    short miss and a long miss, each with its own budget."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 96, size=16).astype(np.int32)

    def tail(n):
        return rng.integers(0, 96, size=n).astype(np.int32)

    prompts = [np.concatenate([shared, tail(4)]), np.concatenate([shared, tail(6)]),
               np.concatenate([shared[:13], tail(5)]), tail(9), tail(30)]
    return prompts, [8, 6, 7, 5, 10]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_serving_matches_jax_and_generate(name):
    jeng, teng = _engines(name)
    prompts, budgets = _requests(len(name))
    jsched = JaxScheduler(jeng, _serving(JaxServingConfig, JaxPrefixCacheConfig))
    jh = [jsched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    jsched.run()
    assert [h.prefix_hit_tokens for h in jh] == [0, 16, 13, 0, 0]
    for kv_pool in ("paged", "slots"):
        sched = ContinuousBatchingScheduler(
            teng, _serving(ServingConfig, PrefixCacheConfig, kv_pool=kv_pool))
        th = [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
        op_builder.reset_launch_counts()
        snap = sched.run()
        assert all(n == 0 for n in op_builder.launch_counts().values())   # CPU: plain
        assert [h.prefix_hit_tokens for h in th] == [0, 16, 13, 0, 0]
        assert snap["completed"] == len(prompts) and snap["prefix_hits"] == 2
        for h, j, p, m in zip(th, jh, prompts, budgets):
            assert h.state == RequestState.FINISHED and h.finish_reason == "length"
            np.testing.assert_array_equal(h.result(), j.result())
            np.testing.assert_array_equal(h.result(),
                                          teng.generate(p[None], max_new_tokens=m)[0, p.size:])
        if kv_pool == "paged":
            assert sched.executor.pool.cow_copies_total == 1
            assert snap["paged_cow_copies_total"] == 1.0


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_paged_decode_step_and_suffix_prefill_match_jax(name):
    """One model call of each new branch: a paged decode step over a shuffled
    page table, and a suffix prefill at a nonzero offset, against the JAX
    model's on the same caches; logits within 1e-4."""
    jeng, teng = _engines(name)
    cfg = teng.model_config
    rng = np.random.default_rng(3)
    b, page, mp = 2, 8, 4
    n_pages = b * mp + 1
    shape = (n_pages, cfg.kv_heads, page, cfg.head_dim)
    pages = [{"k": rng.standard_normal(shape).astype(np.float32),
              "v": rng.standard_normal(shape).astype(np.float32)} for _ in range(cfg.n_layer)]
    table = np.zeros((b, mp), np.int32)
    table[0, :3] = [5, 2, 7]
    table[1, :2] = [8, 1]
    lens = np.array([19, 10], np.int32)
    ids = rng.integers(0, 96, size=(b, 1)).astype(np.int32)
    jlogits, jcaches = jeng.module.apply(
        {"params": jeng.params}, jnp.asarray(ids), positions=jnp.asarray(lens[:, None]),
        caches=[{k: jnp.asarray(v) for k, v in c.items()} for c in pages],
        cache_lens=jnp.asarray(lens), page_table=jnp.asarray(table), kv_cap=30)
    tcaches = [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in pages]
    with torch.no_grad():
        tlogits, _ = teng.module(torch.from_numpy(ids), positions=torch.from_numpy(lens[:, None]),
                                 caches=tcaches, cache_lens=torch.from_numpy(lens),
                                 page_table=torch.from_numpy(table), kv_cap=30)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    for jc, tc in zip(jcaches, tcaches):
        np.testing.assert_allclose(tc["k"].numpy()[1:], np.asarray(jc["k"])[1:], atol=1e-5,
                                   rtol=0)

    # suffix prefill: 6 suffix tokens (bucket 8) at offset 14 of a dense cap-24 cache
    dense = [dict(zip(("k", "v"), (x.contiguous() for x in gather_kv_dense(
        c["k"], c["v"], torch.from_numpy(table[:1]), 24)))) for c in tcaches]
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :6] = rng.integers(0, 96, size=6)
    pos = np.arange(14, 22)[None]
    jlogits, jdense = jeng.module.apply(
        {"params": jeng.params}, jnp.asarray(suffix), positions=jnp.asarray(pos),
        caches=[{k: jnp.asarray(v.numpy()) for k, v in c.items()} for c in dense],
        cache_lens=jnp.asarray([14]), logits_positions=jnp.asarray([5]), prefix_fill=True)
    with torch.no_grad():
        tlogits, _ = teng.module(torch.from_numpy(suffix), positions=torch.from_numpy(pos),
                                 caches=dense, cache_lens=torch.tensor([14]),
                                 logits_positions=torch.tensor([5]), prefix_fill=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    for jc, tc in zip(jdense, dense):      # rows 22, 23 written; the pads past 24 dropped
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=1e-5, rtol=0)


def test_backpressure_cancel_and_deadline(gpt2):
    _, teng = gpt2
    rng = np.random.default_rng(0)
    p0, p1, p2 = (rng.integers(0, 96, size=s).astype(np.int32) for s in (8, 5, 3))
    sched = ContinuousBatchingScheduler(teng, ServingConfig(slots=2, chunk_size=3,
                                                            max_queue=2, max_seq_len=CAP))
    h0 = sched.submit(p0, max_new_tokens=7)
    h1 = sched.submit(p1, max_new_tokens=20)
    sched.step()
    assert h0.state == h1.state == RequestState.RUNNING
    hq1 = sched.submit(p2, max_new_tokens=2)
    hq2 = sched.submit(p2, max_new_tokens=2)
    with pytest.raises(QueueFullError) as ei:
        sched.submit(p2, max_new_tokens=2)
    assert ei.value.retry_after > 0 and sched.queue_depth == 2
    assert sched.telemetry.rejected == 1
    hq1.cancel()
    sched.step()
    assert hq1.state == RequestState.CANCELLED and hq2.state != RequestState.CANCELLED
    got = len(h1.tokens)
    h1.cancel()                     # in flight: keeps its tokens, frees its slot
    sched.step()
    assert h1.state == RequestState.CANCELLED and len(h1.tokens) >= got
    sched.run()
    assert h0.state == hq2.state == RequestState.FINISHED
    h_dead = sched.submit(p0, max_new_tokens=4, deadline_s=0.0)
    sched.step()
    assert h_dead.state == RequestState.EXPIRED and h_dead.finish_reason == "deadline"
    with pytest.raises(ValueError):
        sched.submit(np.arange(CAP, dtype=np.int32))
    with pytest.raises(ValueError):
        sched.submit(p0, max_new_tokens=CAP)


def test_chunk_watchdog_then_reset_pool_serves_again(gpt2):
    """``stall_next`` under ``chunk_deadline_s`` raises ChunkTimeoutError from
    the executor; through the scheduler the in-flight request fails, the pool
    is rebuilt with new tensors, and the next request is served exactly."""
    _, teng = gpt2
    rng = np.random.default_rng(5)
    p0, p1 = (rng.integers(0, 96, size=s).astype(np.int32) for s in (7, 6))
    sched = ContinuousBatchingScheduler(teng, ServingConfig(
        slots=2, chunk_size=2, max_seq_len=CAP, chunk_deadline_s=0.3, transient_retries=0,
        prefix_cache=PrefixCacheConfig(min_hit_tokens=4, min_insert_tokens=4,
                                       insert_on="prefill")))
    ex = sched.executor
    warm = sched.submit(p1, max_new_tokens=3)
    sched.run()
    assert warm.state == RequestState.FINISHED and ex.chunk_warm
    S = ex.slots
    ex.stall_next(0.8)
    with pytest.raises(ChunkTimeoutError):
        ex.run_chunk(np.zeros(S), np.zeros(S), np.zeros(S, bool), np.zeros(S), np.full(S, -1),
                     np.zeros(S), np.zeros(S))
    sched._rebuild_pool()           # what the scheduler does on a failed chunk
    old = ex.pool.caches[0]["k"]
    h = sched.submit(p0, max_new_tokens=6)
    sched.step()                    # admitted, first chunk ok
    ex.stall_next(0.8)
    sched.step()                    # the stalled chunk times out: fail, rebuild
    assert h.state == RequestState.CANCELLED and h.finish_reason == "error"
    assert ex.pool.caches[0]["k"] is not old and sched.prefix_cache.entries == 0
    h2 = sched.submit(p0, max_new_tokens=6)
    sched.run()
    assert h2.state == RequestState.FINISHED
    np.testing.assert_array_equal(h2.result(),
                                  teng.generate(p0[None], max_new_tokens=6)[0, p0.size:])
    # the abandoned chunks finish on their own threads, writing only the old pools
    for th in threading.enumerate():
        if th.name == "ds-serve-chunk-watchdog":
            th.join(timeout=30)
            assert not th.is_alive()


def test_sampling_depends_on_seed_only(gpt2):
    """Seeded sampling gives one stream per (base_seed, seed), whatever slot
    the request lands in, whoever shares the batch, and on either pool."""
    _, teng = gpt2
    rng = np.random.default_rng(13)
    p, other = (rng.integers(0, 96, size=s).astype(np.int32) for s in (9, 11))

    def run(kv_pool, with_neighbours, seed=17):
        sched = ContinuousBatchingScheduler(teng, ServingConfig(
            slots=3, chunk_size=3, max_seq_len=CAP, kv_pool=kv_pool, kv_page_size=8,
            do_sample=True, temperature=0.9, top_k=40, base_seed=5))
        if with_neighbours:
            sched.submit(other, max_new_tokens=12, seed=1)
            sched.submit(other[:5], max_new_tokens=4, seed=2)
        h = sched.submit(p, max_new_tokens=10, seed=seed)
        sched.run()
        assert h.state == RequestState.FINISHED
        return h.result(), h.slot

    alone, slot_alone = run("paged", False)
    crowded, slot_crowded = run("paged", True)
    assert slot_alone != slot_crowded
    np.testing.assert_array_equal(alone, crowded)
    np.testing.assert_array_equal(alone, run("slots", True)[0])
    assert not np.array_equal(alone, run("paged", False, seed=18)[0])


def test_gumbel_noise_finite_at_extreme_hashes():
    """The noise stays finite at the smallest and largest hashes."""
    h = torch.tensor([0, 1, 511, 512, 0x80000000, 0xFFFFFE00, 0xFFFFFFDC, 0xFFFFFFFF])
    noise = decode_fns.gumbel_from_hash(h)
    assert noise.dtype == torch.float32 and bool(torch.isfinite(noise).all())
    assert bool((noise[1:] >= noise[:-1]).all())   # monotone in the hash


def test_sampled_token_never_masked_at_top_hash():
    """At (base_seed 0, seed 0, step 84) token 5285 of GPT-2's 50304-token
    vocabulary hashes to 0xFFFFFFDC, the top value of 24 hash bits. Masked by
    top-k there, it must still never be drawn."""
    vocab, top_k, masked = 50304, 4, 5285
    seeds, steps = torch.tensor([0], dtype=torch.int32), torch.tensor([84], dtype=torch.int32)
    assert int(decode_fns.token_hashes(0, seeds, steps, vocab)[0, masked]) == 0xFFFFFFDC
    noise = decode_fns.gumbel_noise(0, seeds, steps, vocab)
    assert bool(torch.isfinite(noise).all())
    logits = torch.linspace(0.0, -1.0, vocab)[None]     # the top k are tokens 0 .. k-1
    select = decode_fns.make_slot_select_fn(True, 1.0, top_k, 1.0)
    tok = int(select(logits, 0, seeds, steps)[0, 0])
    assert 0 <= tok < top_k


def test_speculate_raises(gpt2):
    """Speculation serves (``tests/test_torch_speculative.py``); the
    draft-model proposer without a draft engine is refused, as in JAX, and
    so is a draft engine on another device than the target's."""
    with pytest.raises(ValueError, match="needs a draft_engine"):
        ContinuousBatchingScheduler(gpt2[1], ServingConfig(speculate=True,
                                                           spec_proposer="draft_model"))
    other = type("Engine", (), {"device": torch.device("meta"),
                                "_config": gpt2[1]._config})()
    with pytest.raises(ValueError, match="keep both on one device"):
        ContinuousBatchingScheduler(gpt2[1], ServingConfig(
            speculate=True, spec_proposer="draft_model", spec_draft_engine=other))


def test_transient_faults_spans_and_metrics(gpt2):
    """A transient fault at the decode chunk is retried and the request still
    matches ``generate``; one that outlasts the retry budget fails the
    in-flight request and the scheduler keeps serving. The tracer records the
    request's stages, and the registry the scheduler's counters."""
    from deepspeed_tpu_torch.observability.metrics import get_registry
    from deepspeed_tpu_torch.observability.trace import get_tracer
    from deepspeed_tpu_torch.utils.fault_injection import FaultSpec, inject
    _, teng = gpt2
    p = np.random.default_rng(21).integers(0, 96, size=7).astype(np.int32)
    sched = ContinuousBatchingScheduler(teng, ServingConfig(
        slots=2, chunk_size=3, max_seq_len=CAP, transient_retries=2, retry_base_delay=0.001))
    tracer = get_tracer().enable()
    tracer.reset()
    try:
        with inject("serving.decode_chunk", FaultSpec(max_faults=1)) as once:
            h = sched.submit(p, max_new_tokens=6)
            sched.run()
        assert once.fired == 1 and h.state == RequestState.FINISHED
        np.testing.assert_array_equal(h.result(),
                                      teng.generate(p[None], max_new_tokens=6)[0, p.size:])
        names = {s["name"] for s in tracer.spans}
        assert {"replica_request", "queue_wait", "prefill", "bucket_prefill", "decode_chunk",
                "retire"} <= names
        assert len({s["trace_id"] for s in tracer.spans}) == 1
        with inject("serving.decode_chunk", FaultSpec()) as always:
            h2 = sched.submit(p, max_new_tokens=6)
            sched.run()
        assert always.fired == 3 and h2.state == RequestState.CANCELLED
        assert h2.finish_reason == "error"
    finally:
        tracer.disable()
        tracer.reset()
    h3 = sched.submit(p, max_new_tokens=6)
    sched.run()
    np.testing.assert_array_equal(h3.result(), h.result())
    snap = get_registry().snapshot()
    assert snap["serving/completed_total"]["value"] >= 2
    assert snap["serving/ttft_ms"]["count"] >= 2


@pytest.mark.parametrize("kv_pool", ["paged", "slots"])
def test_host_tier_promote_hit_matches_generate(gpt2, kv_pool):
    """A prefix whose device entry was spilled to the host tier comes back as a
    promote hit (the host slab restored into the new slot) and decodes
    exactly as ``generate``."""
    _, teng = gpt2
    rng = np.random.default_rng(17)
    s, t = (rng.integers(0, 96, size=16).astype(np.int32) for _ in range(2))

    def tail():
        return rng.integers(0, 96, size=4).astype(np.int32)

    sched = ContinuousBatchingScheduler(teng, _serving(
        ServingConfig, PrefixCacheConfig, kv_pool=kv_pool,
        prefix_cache=PrefixCacheConfig(min_hit_tokens=4, min_insert_tokens=4,
                                       insert_on="prefill", max_bytes=20_000,
                                       host_tier_bytes=1 << 20)))
    for prompt in (np.concatenate([s, tail()]), np.concatenate([t, tail()])):
        sched.submit(prompt, max_new_tokens=4)
        sched.run()
    assert sched.prefix_cache.host_entries == 1 and sched.prefix_cache.spills == 1
    p = np.concatenate([s, tail()])
    h = sched.submit(p, max_new_tokens=6)
    sched.run()
    assert h.prefix_hit_tokens == 16 and sched.prefix_cache.promotions == 1
    np.testing.assert_array_equal(h.result(),
                                  teng.generate(p[None], max_new_tokens=6)[0, p.size:])
