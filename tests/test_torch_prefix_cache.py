"""The port's prefix cache against the JAX package's, on the CPU.

One seeded sequence of inserts (gathered slabs, as on the slot-row pool, and
refcounted pages, as on the paged pool), lookups, peeks and LRU evictions
goes through both caches, with and without the host tier. After every step
the two must agree on what a lookup returns (matched tokens, hit or miss,
device or host rung), on every counter and byte count of ``stats()``, and on
the pages released back to the pool. Slabs are f32, so byte counts are
comparable; the port keeps host slabs as CPU tensors where JAX keeps numpy.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving.prefix_cache import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference.serving.prefix_cache import PrefixCacheConfig as JaxConfig
from deepspeed_tpu_torch.inference.serving import PrefixCache, PrefixCacheConfig

HK, D, LAYERS = 2, 8, 2


def _slab(rows, seed):
    rng = np.random.default_rng(seed)
    return [{"k": rng.standard_normal((HK, rows, D)).astype(np.float32),
             "v": rng.standard_normal((HK, rows, D)).astype(np.float32)} for _ in range(LAYERS)]


def _to_torch(slab):
    return [{k: torch.from_numpy(v) for k, v in s.items()} for s in slab]


class _Pair:
    """The two caches, driven in lock step."""

    def __init__(self, **cfg):
        self.j = JaxPrefixCache(JaxConfig(**cfg))
        self.t = PrefixCache(PrefixCacheConfig(**cfg))
        self.released = ([], [])
        self.j.page_release = lambda pages: self.released[0].append(list(map(int, pages)))
        self.t.page_release = lambda pages: self.released[1].append(list(map(int, pages)))
        # the spill path's gather: a seeded slab per (pages, rows), the same on both sides
        self.j.page_gather = lambda pages, rows: _slab(rows, int(pages[0]))
        self.t.page_gather = lambda pages, rows: _to_torch(_slab(rows, int(pages[0])))

    def same(self):
        assert self.t.stats() == self.j.stats()
        assert self.released[1] == self.released[0]
        assert (self.t.entries, self.t.host_entries) == (self.j.entries, self.j.host_entries)

    def lookup(self, prompt):
        (mj, ej), (mt, et) = self.j.lookup(prompt), self.t.lookup(prompt)
        assert mt == mj and (et is None) == (ej is None)
        if ej is not None:
            assert (et.pages is None) == (ej.pages is None) and et.tokens == ej.tokens
            assert (et.slab is None) == (ej.slab is None)
            if ej.slab is not None:
                for a, b in zip(ej.slab, et.slab):
                    np.testing.assert_array_equal(b["k"].numpy(), np.asarray(a["k"]))
        self.same()
        return mj, ej


def _prompts(seed):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 500, size=40).astype(np.int32)
    return [np.concatenate([system[:n], rng.integers(0, 500, size=s).astype(np.int32)])
            for n, s in ((40, 10), (40, 25), (25, 9), (40, 3), (12, 30), (0, 20), (40, 17),
                         (33, 8))]


@pytest.mark.parametrize("host_tier_bytes", [0, 60_000])
def test_slab_entries_match_jax(host_tier_bytes):
    pair = _Pair(max_bytes=40_000, min_hit_tokens=8, min_insert_tokens=8,
                 host_tier_bytes=host_tier_bytes)
    prompts = _prompts(1)
    for i, p in enumerate(prompts):
        pair.lookup(p)
        slab = _slab(len(p), i)
        assert pair.t.insert(p, _to_torch(slab)) == pair.j.insert(p, slab)
        pair.same()
    for p in prompts[::-1] + [prompts[0][:5], prompts[1][:39]]:
        pair.lookup(p)
        assert pair.t.peek(p)[0] == pair.j.peek(p)[0]
        assert pair.t.contains(p) == pair.j.contains(p)
    while pair.j.evict_lru():
        assert pair.t.evict_lru()
        pair.same()
    assert not pair.t.evict_lru()
    pair.same()
    if host_tier_bytes:
        assert pair.j.spills > 0 and pair.j.promotions > 0


@pytest.mark.parametrize("host_tier_bytes", [0, 50_000])
def test_page_entries_match_jax(host_tier_bytes):
    """Paged-pool entries: page indices with their byte counts; eviction drops
    page references (and spills a gathered slab when the host tier is on)."""
    pair = _Pair(max_bytes=30_000, min_hit_tokens=8, min_insert_tokens=8,
                 host_tier_bytes=host_tier_bytes, insert_on="prefill")
    page_bytes = 2 * LAYERS * HK * 8 * D * 4
    prompts = _prompts(2)
    for i, p in enumerate(prompts):
        pair.lookup(p)
        pages = np.arange(10 * i + 1, 10 * i + 1 + -(-len(p) // 8))
        nbytes = len(pages) * page_bytes
        assert pair.t.insert_pages(p, pages, nbytes) == pair.j.insert_pages(p, pages, nbytes)
        pair.same()
    for p in prompts:
        pair.lookup(p)
    keep = pair.j.peek(prompts[-1])[1]
    tkeep = pair.t.peek(prompts[-1])[1]
    while pair.j.evict_lru(lambda e: e is not keep):
        assert pair.t.evict_lru(lambda e: e is not tkeep)
        pair.same()
    pair.t.drop_device()
    pair.j.drop_device()
    pair.same()
    pair.t.clear()
    pair.j.clear()
    pair.same()
