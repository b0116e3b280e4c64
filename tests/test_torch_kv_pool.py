"""The port's KV pools against the JAX package's, on the CPU.

One sequence of acquire / scatter / share / release / copy-on-write bind /
gather / restore / promote goes through both pools. After every step the host
allocator state must be identical (page table, refcounts, free lists, page
counts, ``stats()``), and the page contents must be equal on every page but
the null page 0 (the JAX movers also write the dead null page, the port's
never do). Slabs must survive a gather / restore round trip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving.kv_pool import PagedKVPool as JaxPagedKVPool
from deepspeed_tpu.inference.serving.kv_pool import SlotKVPool as JaxSlotKVPool
from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu_torch.inference.serving import PagedKVPool, SlotKVPool
from deepspeed_tpu_torch.models import causal_lm as torch_lm

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)


def _cfgs(**extra):
    return (jax_lm.gpt2_cfg(**TINY, **extra, dtype=jnp.float32),
            torch_lm.gpt2_cfg(**TINY, **extra, dtype=torch.float32))


def _one_caches(seed, cfg, cap):
    rng = np.random.default_rng(seed)
    shape = (1, cfg.kv_heads, cap, cfg.head_dim)
    return [{"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)} for _ in range(cfg.n_layer)]


def _jax(caches):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in caches]


def _torch(caches):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in c.items()} for c in caches]


def _same_slab(a, b):
    for x, y in zip(a, b):
        for name in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(y[name]), np.asarray(x[name]))


def _same_paged(jp, tp):
    np.testing.assert_array_equal(tp.page_table, jp.page_table)
    np.testing.assert_array_equal(tp._ref, jp._ref)
    np.testing.assert_array_equal(tp._slot_npages, jp._slot_npages)
    np.testing.assert_array_equal(tp._slot_tokens, jp._slot_tokens)
    assert tp._free_pages == jp._free_pages and tp._free_slots == jp._free_slots
    assert tp.stats() == jp.stats()
    assert (tp.pages_in_use, tp.shared_pages, tp.occupancy, tp.free_pages) == \
        (jp.pages_in_use, jp.shared_pages, jp.occupancy, jp.free_pages)
    for jc, tc in zip(jp.caches, tp.caches):
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy()[1:], np.asarray(jc[name])[1:])


@pytest.mark.parametrize("page_size,cap", [(8, 32), (8, 30), (5, 32)])
def test_paged_pool_sequence_matches_jax(page_size, cap):
    jcfg, tcfg = _cfgs()
    jp = JaxPagedKVPool(jcfg, slots=3, cap=cap, page_size=page_size, dtype=jnp.float32)
    tp = PagedKVPool(tcfg, slots=3, cap=cap, page_size=page_size, dtype=torch.float32,
                     device="cpu")
    assert (tp.max_pages, tp.total_pages, tp.page_nbytes) == \
        (jp.max_pages, jp.total_pages, jp.page_nbytes)
    _same_paged(jp, tp)

    def both(method, *args, **kw):
        a = getattr(jp, method)(*args, **kw)
        b = getattr(tp, method)(*args, **kw)
        _same_paged(jp, tp)
        return a, b

    donor, _ = both("acquire", tokens=21)
    one = _one_caches(1, tcfg, cap)
    jp.scatter_prefill(donor, _jax(one))
    tp.scatter_prefill(donor, _torch(one))
    _same_paged(jp, tp)
    other, _ = both("acquire", tokens=cap)
    jp.scatter_prefill(other, _jax(_one_caches(2, tcfg, cap)))
    tp.scatter_prefill(other, _torch(_one_caches(2, tcfg, cap)))
    _same_paged(jp, tp)
    shared, tshared = both("share_prefix", donor, 19)
    np.testing.assert_array_equal(tshared, shared)
    both("release", donor)
    # a hit on 19 tokens: full pages bind shared, the boundary page is copied
    reader, treader = both("acquire", tokens=26, prefix_pages=shared, matched=19)
    assert reader == treader and tp.cow_copies_total == 1
    assert (tp.page_ref(int(shared[0])), tp.page_ref(int(shared[-1]))) == \
        (jp.page_ref(int(shared[0])), jp.page_ref(int(shared[-1])))
    _same_paged(jp, tp)
    both("release_shared", shared)
    slab = jp.gather_prefix(reader, 19)
    tslab = tp.gather_prefix(reader, 19)
    _same_slab(slab, tslab)
    _same_slab(jp.gather_pages(jp.table_row(other), 13), tp.gather_pages(tp.table_row(other), 13))
    both("release", other)
    # the slab round trip: restore into a fresh slot, gather back
    fresh, _ = both("acquire", tokens=19)
    jp.restore_prefix(fresh, slab)
    tp.restore_prefix(fresh, tslab)
    _same_paged(jp, tp)
    _same_slab(tslab, tp.gather_prefix(fresh, 19))
    # a host-tier promote of 11 matched rows into all-fresh pages
    promoted, _ = both("acquire", tokens=cap)
    host = [{k: np.asarray(v) for k, v in s.items()} for s in slab]
    jp.promote_prefix(promoted, host, 11)
    tp.promote_prefix(promoted, [{k: v.cpu() for k, v in s.items()} for s in tslab], 11)
    _same_paged(jp, tp)
    for s in (reader, fresh, promoted):
        both("release", s)
    assert tp.pages_in_use == 0
    with pytest.raises(ValueError, match="already free"):
        tp.release(reader)
    with pytest.raises(AssertionError, match="underflow"):
        tp._decref(int(shared[0]))
    with pytest.raises(ValueError, match="exceeds cap"):
        tp.acquire(tokens=cap + 1)


def test_paged_pool_gqa_and_validation():
    jcfg, tcfg = _cfgs(n_kv_head=2)
    jp = JaxPagedKVPool(jcfg, slots=2, cap=16, page_size=4, dtype=jnp.float32)
    tp = PagedKVPool(tcfg, slots=2, cap=16, page_size=4, dtype=torch.float32, device="cpu")
    assert tuple(tp.caches[0]["k"].shape) == tuple(jp.caches[0]["k"].shape) == (9, 2, 4, 8)
    with pytest.raises(ValueError, match="total_pages"):
        PagedKVPool(tcfg, slots=1, cap=32, page_size=8, total_pages=3, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        PagedKVPool(tcfg, slots=1, cap=32, page_size=0, device="cpu")


def test_slot_pool_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = JaxSlotKVPool(jcfg, slots=2, cap=24, dtype=jnp.float32)
    tp = SlotKVPool(tcfg, slots=2, cap=24, dtype=torch.float32, device="cpu")

    def same():
        assert tp._free == jp._free and tp.occupancy == jp.occupancy
        _same_slab(jp.caches, tp.caches)

    a, b = jp.acquire(), tp.acquire()
    assert a == b
    one = _one_caches(3, tcfg, 24)
    jp.scatter_prefill(a, _jax(one))
    tp.scatter_prefill(b, _torch(one))
    same()
    slab, tslab = jp.gather_prefix(a, 10), tp.gather_prefix(b, 10)
    _same_slab(slab, tslab)
    assert tp.slab_nbytes(10) == jp.slab_nbytes(10)
    c, d = jp.acquire(), tp.acquire()
    jp.restore_prefix(c, slab)
    tp.restore_prefix(d, tslab)
    same()
    _same_slab(tslab, tp.gather_prefix(d, 10))
    jp.release(a)
    tp.release(b)
    same()
    assert not tp.caches[0]["k"][b].any()          # release zero-fills the row
    assert jp.acquire() == tp.acquire()
    assert jp.acquire() is None and tp.acquire() is None
