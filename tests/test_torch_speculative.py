"""The port's speculative decoding against the JAX package's, on the CPU.

The same weights (``causal_lm_params_from_jax``) go through JAX's and the
port's verify passes, proposers and schedulers, f32 on the CPU: n-gram and
draft-model proposals, the greedy accept rule, the slot-row and paged verify
passes (logits within 1e-4, the port's model tolerance; caches equal on the
rows written and untouched elsewhere) for gpt2, llama with GQA and bloom with
ALiBi, and the scheduler's greedy output and spec counters on both pools with
the prefix cache on and off, which must also equal the port's own
non-speculative output. JAX's edge cases follow in the port's own terms: EOS
inside a window, the cap edge, a rejection on the copy-on-write boundary
page, a prefix hit, and a fault at ``serving.spec_verify``. The sampled path
runs on the port's own hashed key stream, not JAX's threefry, so it is held
to its contract inside the port: the target distribution kept, the bonus of
a full acceptance equal to ``make_slot_select_fn``'s draw, and the output a
function of the request's seed only.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import decode_fns as jax_fns
from deepspeed_tpu.inference import speculative as jax_spec
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.inference.serving import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.models import causal_lm as jax_lm
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference import decode_fns, speculative
from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler,
                                                   PrefixCacheConfig, RequestState,
                                                   ServingConfig)
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.observability import schema
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.paged_attention import NULL_PAGE
from deepspeed_tpu_torch.utils.fault_injection import FaultSpec, inject

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
CAP = 48
V = TINY["vocab_size"]
FAMILIES = {"gpt2": ("gpt2", {}), "llama-gqa": ("llama", {"n_kv_head": 2}),
            "bloom-alibi": ("bloom", {})}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _engines(name, cap=CAP, n_layer=TINY["n_layer"]):
    """JAX's engine and the port's on its weights; a non-default ``n_layer``
    makes a draft model with weights of its own (JAX seed 7)."""
    family, extra = FAMILIES[name]
    kw = {**TINY, **extra, "n_layer": n_layer}
    over = n_layer != TINY["n_layer"]
    jcfg = jax_lm.FAMILIES[family](**kw, dtype=jnp.float32)
    jeng = JaxInferenceEngine(jcfg, JaxInferenceConfig(dtype="float32", max_out_tokens=cap),
                              seed=7 if over else 0)
    tcfg = torch_lm.FAMILIES[family](**kw, dtype=torch.float32)
    params = causal_lm_params_from_jax(jax.device_get(jeng.params), tcfg)
    teng = dst.init_inference((tcfg, params), {"dtype": "float32", "max_out_tokens": cap},
                              device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def gpt2():
    return _engines("gpt2")


@pytest.fixture(scope="module")
def draft():
    """A one-layer draft of the tiny GPT-2 (its own weights), cap 16: the
    context tail is cut to 16 - k tokens."""
    return _engines("gpt2", cap=16, n_layer=1)


def _serving(cls, cache_cls, kv_pool="paged", cache=True, **over):
    kw = dict(slots=2, chunk_size=3, max_seq_len=CAP, retry_base_delay=0.001, kv_pool=kv_pool,
              kv_page_size=8, speculate=True, spec_k=4,
              prefix_cache=(cache_cls(min_hit_tokens=4, min_insert_tokens=4,
                                      insert_on="prefill") if cache else None))
    kw.update(over)
    return cls(**kw)


def _rep(rng, unit=4, reps=4, tail=0):
    """A prompt with a repetitive suffix: the n-gram proposer's home turf."""
    p = np.tile(rng.integers(0, V, size=unit).astype(np.int32), reps)
    return np.concatenate([p, rng.integers(0, V, size=tail).astype(np.int32)])


def _requests(seed):
    """Repetitive prompts (high acceptance), a random one (a dry proposer),
    and three behind a shared 16-token prefix: the first inserts it, then a
    hit of 13 tokens (it copies its boundary page) and a page-aligned one of
    16; with their budgets."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, V, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, _rep(rng, 4, 3)]), _rep(rng, 3, 4, tail=2),
               rng.integers(0, V, size=7).astype(np.int32),
               np.concatenate([shared[:13], _rep(rng, 3, 3)]),
               np.concatenate([shared, _rep(rng)])]
    return prompts, [12, 10, 8, 9, 14]


def _ref(engine, prompt, n, **kw):
    return np.asarray(engine.generate(prompt[None], max_new_tokens=n, **kw))[0, prompt.size:]


def _run(sched, prompts, budgets, **kw):
    hs = [sched.submit(p, max_new_tokens=m, **kw) for p, m in zip(prompts, budgets)]
    snap = sched.run()
    return hs, snap


# -------------------------------------------------------------- proposer units
@pytest.mark.parametrize("seed", range(6))
def test_ngram_proposals_match_jax(seed):
    """Short streams over a few symbols (matches everywhere) and long ones
    over many (rare matches), every prefix length."""
    rng = np.random.default_rng(seed)
    stream = np.concatenate([_rep(rng, int(rng.integers(2, 6)), 3),
                             rng.integers(0, 6, size=40).astype(np.int32)])
    if seed % 2:
        stream = rng.integers(0, 40, size=300).astype(np.int32)
    for lo, hi in ((1, 4), (2, 3), (1, 1)):
        ours, theirs = speculative.NgramProposer(hi, lo), jax_spec.NgramProposer(hi, lo)
        for t in range(0, stream.size + 1, 3 + 4 * (seed % 2)):
            for k in (1, 3, 4):
                np.testing.assert_array_equal(ours.propose(stream[:t], k),
                                              theirs.propose(stream[:t], k))


def test_ngram_proposer_units_and_config_validation():
    p = speculative.NgramProposer(ngram_max=3, ngram_min=1)
    ctx = np.array([7, 8, 1, 2, 7, 8, 9, 1, 7, 8], np.int32)
    np.testing.assert_array_equal(p.propose(ctx, 2), [9, 1])
    np.testing.assert_array_equal(p.propose(np.array([2, 7, 8, 5, 0, 2, 7, 8]), 2), [5, 0])
    np.testing.assert_array_equal(p.propose(np.array([3, 3, 3]), 2), [3])
    assert p.propose(np.array([1, 2, 3, 4]), 4).size == 0
    assert p.propose(np.array([], np.int32), 4).size == 0
    for bad in (dict(k=0), dict(proposer="magic"), dict(ngram_min=3, ngram_max=2)):
        with pytest.raises(ValueError):
            speculative.SpeculativeConfig(**bad)
    with pytest.raises(ValueError):
        speculative.make_proposer(speculative.SpeculativeConfig(proposer="draft_model"))


def test_draft_model_proposals_match_jax(draft):
    jd, td = draft
    ours, theirs = speculative.DraftModelProposer(td), jax_spec.DraftModelProposer(jd)
    rng = np.random.default_rng(4)
    for t, k in ((5, 4), (30, 4), (9, 1)):     # the second tail cut to 16 - k
        ctx = rng.integers(0, V, size=t).astype(np.int32)
        np.testing.assert_array_equal(ours.propose(ctx, k), theirs.propose(ctx, k))
    assert ours.calls == 3 and ours.propose(np.zeros(0, np.int32), 4).size == 0


# ----------------------------------------------------------------- accept rule
def test_greedy_accept_matches_jax():
    rng = np.random.default_rng(8)
    greedy = (False, 1.0, 0, 1.0)
    for _ in range(40):
        L = int(rng.integers(0, 5))
        logits = rng.standard_normal((L + 1, 8)).astype(np.float32)
        tgt = logits.argmax(-1)
        draft = np.where(rng.random(L) < 0.7, tgt[:L], rng.integers(0, 8, L)).astype(np.int32)
        assert speculative.greedy_accept(draft, tgt) == jax_spec.greedy_accept(draft, tgt)
        ours = speculative.accept_tokens(draft, logits, sampling=greedy, base_seed=0, seed=3,
                                         step0=5)
        theirs = jax_spec.accept_tokens(draft, logits, sampling=greedy,
                                        base_key=jax.random.PRNGKey(0), seed=3, step0=5)
        assert ours == theirs


# --------------------------------------------------------------- verify passes
def _jax_caches(caches):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in caches]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_spec_verify_matches_jax(name):
    """Slot-row verify: logits at every window position and the whole caches
    (JAX writes every window row, the pads too, and drops rows past T)."""
    jeng, teng = _engines(name)
    cfg = teng.model_config
    rng = np.random.default_rng(11)
    S, T, t = 3, 24, 5
    shape = (S, cfg.kv_heads, T, cfg.head_dim)
    caches = [{"k": rng.standard_normal(shape).astype(np.float32),
               "v": rng.standard_normal(shape).astype(np.float32)} for _ in range(cfg.n_layer)]
    ids = rng.integers(0, V, size=(S, t)).astype(np.int32)
    lens = np.array([7, 15, 21], np.int32)                      # slot 2 runs past T
    jlogits, jcaches = jax.jit(jax_fns.build_spec_verify(jeng.module, jeng._dequant))(
        jeng.params, jnp.asarray(ids), _jax_caches(caches), jnp.asarray(lens))
    tcaches = [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in caches]
    with torch.no_grad():
        tlogits = decode_fns.spec_verify(teng.module, torch.from_numpy(ids), tcaches,
                                         torch.from_numpy(lens))
    assert tlogits.shape == (S, t, V)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    for jc, tc in zip(jcaches, tcaches):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_paged_spec_verify_matches_jax(name):
    """Paged verify over a shuffled page table: logits within 1e-4 of JAX's;
    the pages equal JAX's (the null page aside, where the port routes the
    rows JAX drops) and equal the input everywhere but the valid window rows
    of live slots below ``kv_cap``."""
    jeng, teng = _engines(name)
    cfg = teng.model_config
    rng = np.random.default_rng(12)
    S, page, mp, t, kv_cap = 4, 8, 4, 5, 30
    P = S * mp + 1
    shape = (P, cfg.kv_heads, page, cfg.head_dim)
    pages = [{"k": rng.standard_normal(shape).astype(np.float32),
              "v": rng.standard_normal(shape).astype(np.float32)} for _ in range(cfg.n_layer)]
    table = np.zeros((S, mp), np.int32)
    table[0, :3] = [5, 2, 7]
    table[1, :2] = [8, 1]
    table[2] = [3, 9, 12, 4]           # a slot at the cap edge: rows 30, 31 are not written
    table[3, :2] = [6, 10]             # an inactive slot
    lens = np.array([19, 10, 27, 4], np.int32)
    valid = np.array([4, 2, 5, 5], np.int32)
    active = np.array([True, True, True, False])
    ids = rng.integers(0, V, size=(S, t)).astype(np.int32)
    jfn = jax.jit(jax_fns.build_paged_spec_verify(jeng.module, jeng._dequant, kv_cap=kv_cap))
    jlogits, jpages = jfn(jeng.params, jnp.asarray(ids), _jax_caches(pages), jnp.asarray(table),
                          jnp.asarray(lens), jnp.asarray(valid), jnp.asarray(active))
    tpages = [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in pages]
    with torch.no_grad():
        tlogits = decode_fns.paged_spec_verify(
            teng.module, torch.from_numpy(ids), tpages, torch.from_numpy(table),
            torch.from_numpy(lens), torch.from_numpy(valid), torch.from_numpy(active), kv_cap)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    written = np.zeros((P, page), bool)
    for s in range(S):
        for j in range(int(valid[s])):
            r = int(lens[s]) + j
            if active[s] and r < kv_cap:
                written[table[s, r // page], r % page] = True
    assert written.sum() == 4 + 2 + 3
    for jc, tc, c in zip(jpages, tpages, pages):
        for key in ("k", "v"):
            ours = tc[key].numpy()
            np.testing.assert_allclose(ours[1:], np.asarray(jc[key])[1:], atol=1e-5, rtol=0)
            keep = ~written
            keep[NULL_PAGE] = False
            np.testing.assert_array_equal(ours.transpose(0, 2, 1, 3)[keep],
                                          c[key].transpose(0, 2, 1, 3)[keep])


# -------------------------------------------------------- the scheduler, greedy
@pytest.mark.parametrize("kv_pool", ["paged", "slots"])
def test_greedy_spec_serving_matches_jax_and_plain(gpt2, kv_pool):
    """Greedy speculative serving, prefix cache on and off: tokens equal to
    JAX's speculative run and to the port's own non-speculative run, and the
    spec counters equal to JAX's."""
    jeng, teng = gpt2
    prompts, budgets = _requests(5)
    for cache in (True, False):
        jsched = JaxScheduler(jeng, _serving(JaxServingConfig, JaxPrefixCacheConfig,
                                             kv_pool, cache))
        jh, jsnap = _run(jsched, prompts, budgets)
        sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig,
                                                           kv_pool, cache))
        op_builder.reset_launch_counts()
        th, snap = _run(sched, prompts, budgets)
        assert all(n == 0 for n in op_builder.launch_counts().values())   # CPU: plain
        plain = ContinuousBatchingScheduler(teng, _serving(
            ServingConfig, PrefixCacheConfig, kv_pool, cache, speculate=False))
        ph, psnap = _run(plain, prompts, budgets)
        assert "spec_rounds" not in psnap
        for h, j, p in zip(th, jh, ph):
            assert h.state == RequestState.FINISHED and h.finish_reason == "length"
            np.testing.assert_array_equal(h.result(), j.result())
            np.testing.assert_array_equal(h.result(), p.result())
        keys = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_tokens")
        assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
        assert snap["chunks"] == snap["spec_rounds"]
        assert snap["spec_accepted"] > 0 and snap["spec_passes_per_token"] < 1.0
        if cache:
            assert [h.prefix_hit_tokens for h in th] == [j.prefix_hit_tokens for j in jh]
            assert [h.prefix_hit_tokens for h in th] == [0, 0, 0, 13, 16]


def test_draft_model_serving_matches_jax(gpt2, draft):
    """The draft-model proposer through the scheduler: tokens and counters
    equal to JAX's, tokens equal to plain decode."""
    (jeng, teng), (jd, td) = gpt2, draft
    prompts, budgets = _requests(6)
    jsched = JaxScheduler(jeng, _serving(JaxServingConfig, JaxPrefixCacheConfig,
                                         spec_proposer="draft_model", spec_draft_engine=jd))
    jh, jsnap = _run(jsched, prompts[:3], budgets[:3])
    sched = ContinuousBatchingScheduler(teng, _serving(
        ServingConfig, PrefixCacheConfig, spec_proposer="draft_model", spec_draft_engine=td))
    th, snap = _run(sched, prompts[:3], budgets[:3])
    for h, j, p, m in zip(th, jh, prompts, budgets):
        np.testing.assert_array_equal(h.result(), j.result())
        np.testing.assert_array_equal(h.result(), _ref(teng, p, m))
    keys = ("spec_rounds", "spec_proposed", "spec_accepted")
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert sched.proposer.calls > 0 and snap["spec_proposed"] >= sched.proposer.calls


# ------------------------------------------------------------------ edge cases
class _WrongProposer:
    """Always drafts a token the verify argmax cannot match: every round
    rejects at position 0."""
    deterministic = True

    def propose(self, context, k):
        return np.full(k, (int(context[-1]) + 1) % V, np.int32)


class _OracleProposer:
    """Drafts the true greedy continuation: every round accepts in full."""
    deterministic = True

    def __init__(self, full):
        self.full = np.asarray(full, np.int32)

    def propose(self, context, k):
        return self.full[len(context):len(context) + k]


def test_rejection_on_cow_boundary_page(gpt2):
    """Rejected windows whose rows lie on the copied boundary page of a
    prefix hit (21-token prompt, page 8: pages 0-1 shared, page 2 copied,
    decode from row 21): the stream stays exact."""
    _, teng = gpt2
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, V, size=21).astype(np.int32)
    ref = _ref(teng, prompt, 6)
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig))
    sched.proposer = _WrongProposer()
    for _ in range(2):
        h = sched.submit(prompt, max_new_tokens=6)
        sched.run()
        np.testing.assert_array_equal(h.result(), ref)
    assert h.prefix_hit_tokens > 0 and sched.executor.pool.cow_copies_total >= 1
    snap = sched.telemetry.snapshot()
    assert snap["spec_accepted"] == 0 and snap["spec_proposed"] > 0


def test_eos_inside_speculated_block(gpt2):
    _, teng = gpt2
    prompt = np.random.default_rng(31).integers(0, V, size=12).astype(np.int32)
    ref10 = _ref(teng, prompt, 10)
    eos = int(next(t for t in ref10[1:] if t != ref10[0]))
    ref = _ref(teng, prompt, 10, eos_token_id=eos)
    assert ref.size < 10 or ref[-1] == eos
    for kv_pool in ("paged", "slots"):
        sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig,
                                                           kv_pool))
        sched.proposer = _OracleProposer(np.concatenate([prompt, ref10]))
        h = sched.submit(prompt, max_new_tokens=10, eos_token_id=eos)
        sched.run()
        assert h.finish_reason == "eos" and h.tokens[-1] == eos
        np.testing.assert_array_equal(h.result(), ref[:list(ref).index(eos) + 1])
        assert sched.telemetry.spec.accepted > 0


def test_cap_edge_truncation_of_proposal_window(gpt2):
    """prompt + budget == CAP: near the edge the window shrinks to nothing
    (the plain step through the same shape) and the stream stays exact."""
    _, teng = gpt2
    max_new = 8
    prompt = np.tile(np.random.default_rng(33).integers(0, V, size=4).astype(np.int32),
                     (CAP - max_new) // 4)
    assert prompt.size + max_new == CAP
    ref = _ref(teng, prompt, max_new)
    for kv_pool in ("paged", "slots"):
        sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig,
                                                           kv_pool))
        h = sched.submit(prompt, max_new_tokens=max_new)
        sched.run()
        assert h.state == RequestState.FINISHED and h.finish_reason == "length"
        np.testing.assert_array_equal(h.result(), ref)


def test_spec_prefix_cache_hit_parity(gpt2):
    _, teng = gpt2
    rng = np.random.default_rng(41)
    prompt = np.concatenate([rng.integers(0, V, size=16).astype(np.int32), _rep(rng, 3, 2)])
    ref = _ref(teng, prompt, 8)
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig))
    hs = []
    for _ in range(2):
        hs.append(sched.submit(prompt, max_new_tokens=8))
        sched.run()
    assert hs[0].prefix_hit_tokens == 0 and hs[1].prefix_hit_tokens > 0
    for h in hs:
        np.testing.assert_array_equal(h.result(), ref)


def test_spec_verify_fault_retried_then_rebuilt(gpt2):
    """A fault at ``serving.spec_verify`` inside the retry budget is retried
    to the same stream; one that outlasts it fails the in-flight request
    through the rebuild path (never a plain chunk), and the next request is
    served exactly by speculation again."""
    _, teng = gpt2
    p = _rep(np.random.default_rng(31), 4, 3)
    ref = _ref(teng, p, 12)
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig,
                                                       transient_retries=1))
    with inject("serving.spec_verify", FaultSpec(after_n=2, max_faults=1)) as once:
        h = sched.submit(p, max_new_tokens=12)
        sched.run()
    assert once.fired == 1 and h.state == RequestState.FINISHED
    np.testing.assert_array_equal(h.result(), ref)
    old = sched.executor.pool.caches[0]["k"]
    chunks = sched.telemetry._chunk_idx
    with inject("serving.spec_verify", FaultSpec(after_n=1)) as always:
        h2 = sched.submit(p, max_new_tokens=12)
        sched.run()
    assert always.fired == 2 and h2.state == RequestState.CANCELLED
    assert h2.finish_reason == "error" and sched.executor.pool.caches[0]["k"] is not old
    assert sched.telemetry._chunk_idx == chunks + 1      # one round, then the failure
    h3 = sched.submit(p, max_new_tokens=12)
    sched.run()
    np.testing.assert_array_equal(h3.result(), ref)
    assert sched.telemetry.spec.rounds == sched.telemetry._chunk_idx


# ---------------------------------------------------------------- sampled path
def test_rejection_sampling_keeps_the_target_distribution():
    """Monte Carlo over seeds: the first token emitted at a speculated
    position is distributed as the target softmax, for the likeliest and the
    least likely draft (TV < 0.05, as JAX's test); one ``window_draws`` over
    all the seeds, spot-checked against ``accept_tokens``."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy((rng.normal(size=(2, 6)) * 1.5).astype(np.float32))
    target = torch.softmax(logits[0], -1).numpy()
    N = 1500
    sampling = (True, 1.0, 0, 1.0)
    for tok in (int(target.argmax()), int(target.argmin())):
        draft = np.array([tok], np.int32)
        draws = speculative.window_draws(
            logits[None].expand(N, 2, 6), torch.full((N, 1), tok), sampling, 3,
            torch.arange(N), torch.zeros(N, dtype=torch.long))
        first = [speculative.accept_drawn(draft, draws, s)[0][0] for s in range(N)]
        tv = 0.5 * np.abs(np.bincount(first, minlength=6) / N - target).sum()
        assert tv < 0.05, f"TV distance {tv:.3f} from the target"
        for s in (0, 7, 1499):
            assert speculative.accept_tokens(draft, logits, sampling=sampling, base_seed=3,
                                             seed=s, step0=0) == \
                speculative.accept_drawn(draft, draws, s)


def test_full_acceptance_bonus_is_the_slot_select_draw():
    """Drafts the target is sure of are accepted in full, and the bonus at
    position L is ``make_slot_select_fn``'s draw for step ``step0 + L``, bit
    for bit, under temperature, top-k and top-p."""
    rng = np.random.default_rng(9)
    for sampling in ((True, 1.0, 0, 1.0), (True, 0.8, 20, 0.9)):
        select = decode_fns.make_slot_select_fn(*sampling)
        for seed, step0 in ((1, 0), (2, 5), (77, 31)):
            L = 3
            logits = torch.from_numpy(rng.normal(size=(L + 1, V)).astype(np.float32))
            draft = rng.integers(0, V, size=L).astype(np.int32)
            logits[torch.arange(L), torch.from_numpy(draft).long()] = 60.0
            emitted, acc = speculative.accept_tokens(draft, logits, sampling=sampling,
                                                     base_seed=4, seed=seed, step0=step0)
            assert acc == L and emitted[:L] == draft.tolist()
            want = select(logits[L:], 4, torch.tensor([seed]), torch.tensor([step0 + L]))
            assert emitted[L] == int(want[0, 0])


def test_sampled_spec_depends_on_seed_only(gpt2):
    """Sampled speculative serving: one stream per (base_seed, seed), whatever
    the slot, the neighbours or the pool."""
    _, teng = gpt2
    rng = np.random.default_rng(21)
    p, other = _rep(rng), rng.integers(0, V, size=6).astype(np.int32)

    def run(kv_pool, crowded, seed=7):
        sched = ContinuousBatchingScheduler(teng, _serving(
            ServingConfig, PrefixCacheConfig, kv_pool, slots=3, do_sample=True,
            temperature=0.9, top_k=40, base_seed=5))
        if crowded:
            sched.submit(other, max_new_tokens=12, seed=1)
            sched.submit(other[:5], max_new_tokens=4, seed=2)
        h = sched.submit(p, max_new_tokens=10, seed=seed)
        snap = sched.run()
        assert h.state == RequestState.FINISHED and snap["spec_rounds"] > 0
        return h.result(), h.slot

    alone, slot_alone = run("paged", False)
    crowded, slot_crowded = run("paged", True)
    assert slot_alone != slot_crowded
    np.testing.assert_array_equal(alone, crowded)
    np.testing.assert_array_equal(alone, run("slots", True)[0])
    assert not np.array_equal(alone, run("paged", False, seed=8)[0])


# ------------------------------------------------------------------- telemetry
def test_spec_tags_declared_and_published(gpt2):
    """Every ``serving/*`` tag literal in the emitter modules is declared, and
    a speculative run publishes the spec tags to the registry."""
    from deepspeed_tpu_torch.observability.metrics import get_registry
    assert "deepspeed_tpu_torch/inference/speculative.py" in schema.EMITTER_MODULES
    for rel in schema.EMITTER_MODULES:
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.startswith("serving/") and " " not in node.value:
                schema.kind_of(node.value)
    _, teng = gpt2
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig))
    sched.submit(_rep(np.random.default_rng(9)), max_new_tokens=10)
    snap = sched.run()
    assert snap["spec_rounds"] == sched.telemetry.spec.rounds > 0
    assert 0.0 < snap["spec_acceptance_rate"] <= 1.0
    reg = get_registry().snapshot()
    assert reg["serving/spec_proposed_total"]["value"] >= snap["spec_proposed"]
    assert "serving/spec_draft_ms" in reg
