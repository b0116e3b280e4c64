"""The dense decode kernel's split walk, emulated on the CPU, against the JAX
package's decode attention; and the split rule it shares with the paged
kernel.

K2 (``deepspeed_tpu_torch/ops/csrc/decode_attention.cu`` over
``decode_split.cuh``) runs the paged kernel's split body over 64-row tiles of
a (sequence, kv head)'s contiguous cache rows: tile u holds rows [64 u, 64 u
+ rows(u)), rows(u) = min(64, len - 64 u) with len = min(cache_len, T), so a
copy stops at cache_len and never passes the capacity T; locating a tile
reads nothing (no table). Block r of a cluster of S takes the tiles [r *
share, (r + 1) * share), share = cdiv(cdiv(len, 64), S). A dense cache is
thus a page-64 pool whose table row is 0, 1, 2, ...: the emulation below
lays each sequence's tiles out so and walks them with
``tests/test_torch_paged_split.py``'s emulation of the body (stages, warps,
lane groups, their merges), then merges the ranks in order. The pool holds
NaN past each tile's rows, so a walk that used a row the copy did not bring
would show.

Held against JAX's ``decode_attention`` (the Pallas kernel, interpret mode,
as the JAX tests run it on the CPU) on every sequence and
``decode_attention_xla`` on every sequence with rows (for cache_len 0 the TPU
kernel gives zeros, the dense ground truth the mean of its masked rows), f32,
tolerance 2e-5 (the JAX tests' own for kernel against ground truth). The
caches hold 1e4 past each length, as ``ops/kernel_checks.py``'s do.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.ops.attention.decode import decode_attention, decode_attention_xla
from deepspeed_tpu_torch.ops import kernel_checks
from deepspeed_tpu_torch.ops.attention.decode import (SPLITS, cluster_split, decode_split,
                                                      heads_a_block, resident_blocks)
from test_torch_paged_split import _block_partial, merge_ranks

TOL = 2e-5
TILE = 64


def dense_tiles(n, cap):
    """The kernel's tiles of a sequence of n valid rows, as the paged
    emulation's units (first row, rows, table column, row offset): rows cut
    at n, which is at most cap."""
    tiles = [(u * TILE, min(TILE, n - u * TILE), u, 0) for u in range(-(-n // TILE))]
    assert all(first + rows <= min(n, cap) for first, rows, _, _ in tiles)
    return tiles


def emulate_dense_walk(q, k, v, lens, splits):
    """K2's walk at S = splits, f32: per (sequence, kv head) and head block
    of up to 4 heads, each rank's contiguous share of the tiles, merged in
    rank order; zeros where no row is valid."""
    b, h, d = q.shape
    hk, cap = k.shape[1], k.shape[2]
    g = h // hk
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, d), np.float32)
    for i in range(b):
        n = min(max(int(lens[i]), 0), cap)
        tiles = dense_tiles(n, cap)
        share = -(-len(tiles) // splits)
        # tile u is page u of a page-64 pool; past its rows, NaN
        pool_k = np.full((max(len(tiles), 1), hk, TILE, d), np.nan, np.float32)
        pool_v = np.full_like(pool_k, np.nan)
        for first, rows, u, _ in tiles:
            pool_k[u, :, :rows] = k[i, :, first:first + rows]
            pool_v[u, :, :rows] = v[i, :, first:first + rows]
        table_row = np.arange(len(tiles))
        for kh in range(hk):
            for j0 in range(0, g, 4):           # a block's heads
                heads = slice(kh * g + j0, kh * g + min(j0 + 4, g))
                qs = (q[i, heads] * scale).astype(np.float32)
                parts = [_block_partial(qs, pool_k, pool_v, table_row, n, kh, TILE,
                                        (tiles[r * share:(r + 1) * share], 1), d)
                         for r in range(splits)]
                out[i, heads] = merge_ranks(parts)
    return out


def _dense_inputs(seed, b, h, hk, d, cap, lens):
    """q (b, h, d) and caches (b, hk, cap, d) from numpy, 1e4 in every row at
    or past a sequence's length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, cap, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, cap, d)).astype(np.float32)
    for i, n in enumerate(lens):
        k[i, :, n:] = 1e4
        v[i, :, n:] = 1e4
    return q, k, v, np.asarray(lens, np.int32)


CASES = {
    # name: (b, h, hk, d, cap, lens)
    "empty-seq-g4": (3, 8, 2, 64, 256, (0, 200, 33)),
    "cap-off-64-g1": (2, 4, 4, 64, 300, (300, 77)),
    "g7-two-head-blocks-d128": (2, 14, 2, 128, 192, (192, 70)),
    "g1-d128-one-tile": (2, 2, 2, 128, 128, (64, 5)),
}


@functools.lru_cache(maxsize=None)
def _jax_outputs(b, h, hk, d, cap, lens, seed):
    q, k, v, lens = _dense_inputs(seed, b, h, hk, d, cap, lens)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    return ((q, k, v, lens), np.asarray(decode_attention(jq, jk, jv, jl)),
            np.asarray(decode_attention_xla(jq, jk, jv, jl)))


def _hold(out, kernel, xla, lens):
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, kernel, atol=TOL, rtol=TOL)
    live = lens > 0
    np.testing.assert_allclose(out[live], xla[live], atol=TOL, rtol=TOL)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_split_walk_matches_jax(name, splits):
    (q, k, v, lens), kernel, xla = _jax_outputs(*CASES[name], seed=len(name))
    _hold(emulate_dense_walk(q, k, v, lens, splits), kernel, xla, lens)


@pytest.mark.parametrize("splits", SPLITS)
def test_dense_split_walk_short_sequences(splits):
    """Lengths 1, 64 S - 1 and the capacity: the first sequence's splits but
    the first walk nothing, the second has S tiles, its last one row short,
    and the third fills a capacity that is no multiple of 64, so its last
    tile is cut at T."""
    cap = 64 * 8 + 20
    (q, k, v, lens), kernel, xla = _jax_outputs(3, 4, 1, 64, cap, (1, 64 * splits - 1, cap),
                                                seed=50 + splits)
    _hold(emulate_dense_walk(q, k, v, lens, splits), kernel, xla, lens)


def test_dense_tiles_stop_at_length_and_capacity():
    """The tiles cover the valid rows once, in order, each of 64 rows but the
    last, which ends at row len - 1; none reaches past len or T."""
    for n, cap in ((300, 300), (77, 300), (64, 64), (1, 1000), (0, 64), (129, 129)):
        tiles = dense_tiles(n, cap)
        rows = [r for first, cnt, _, _ in tiles for r in range(first, first + cnt)]
        assert rows == list(range(n))
        assert all(cnt == TILE for _, cnt, _, _ in tiles[:-1])


def test_decode_split_reads_shapes_only():
    """decode_split takes shapes, never cache_len, and returns one of SPLITS."""
    assert list(inspect.signature(decode_split).parameters) == ["b", "hk", "g", "cap", "d",
                                                                 "itemsize"]
    for args in ((1, 1, 1, 1, 64, 2), (64, 32, 4, 4096, 128, 2), (3, 7, 7, 300, 64, 4)):
        assert decode_split(*args) in SPLITS


@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("d,itemsize", [(64, 2), (128, 2), (64, 4), (128, 4)])
def test_split_falls_as_pairs_grow(g, d, itemsize):
    """More (sequence, kv head) pairs never take more splits; no more
    splits than a pair has tiles."""
    picks = [decode_split(b, hk, g, 2048, d, itemsize) for b, hk in
             ((1, 1), (2, 2), (4, 4), (8, 4), (16, 4), (16, 12), (64, 16))]
    assert picks == sorted(picks, reverse=True)
    assert picks[0] == 8 and picks[-1] == 1
    assert decode_split(1, 1, g, 100, d, itemsize) == 2       # two tiles


def test_split_counts_head_blocks_and_registers():
    """A 16-bit four-head block at d 128 (288 threads of more than 112
    registers) fills an SM's registers, so the card holds 132 of them,
    where shared memory alone would hold 264 two-head blocks; and more than
    four heads a group take cdiv(g, 4) head blocks a pair."""
    assert resident_blocks(2, 128, 4) == 132
    assert resident_blocks(2, 128, 2) == 264
    assert resident_blocks(2, 64, 1) == 396
    assert resident_blocks(2, 128, 1) == 264
    assert [heads_a_block(g) for g in (1, 2, 3, 4, 7, 8)] == [1, 2, 4, 4, 4, 4]
    assert cluster_split(16, 32, 2048, 128, 4, 2) == 8       # 128 blocks
    assert cluster_split(16, 32, 2048, 128, 8, 2) == 4       # 2 head blocks: 128 at S 4


def test_split_picks_at_the_check_cases():
    """The picks at ``kernel_checks``' cases, the fastest of the ``[split]``
    sweep at each 16-bit one: the paged kernel's six earlier cases as before
    this rule counted registers, head blocks and full cards; K2's main path
    4 ways (8 would fill the card with walks of 128 rows a block), Qwen2-7B's
    shape likewise, and Mistral-7B's 32 pairs of four-head blocks 4 ways (a
    count of two such blocks an SM would take 8)."""
    picks = {(c.kernel, c.name): kernel_checks.case_splits(c) for c in kernel_checks.CASES
             if c.kernel in ("decode_attention", "paged_decode_attention")}
    assert {name: s for (kernel, name), s in picks.items()
            if kernel == "paged_decode_attention" and name != "qwen2-g7-d128"} == {
        "gpt2-serve": 2, "gqa-d128": 8, "fp32-gqa-page8-cap300": 8, "fp16-page1": 8,
        "bf16-page5-d128": 8, "bf16-gqa-empty-slot": 8}
    assert picks[("decode_attention", "gpt2-decode")] == 4
    assert picks[("decode_attention", "gqa-d128")] == 8
    assert picks[("decode_attention", "bf16-gqa-empty-slot")] == 8
    assert picks[("decode_attention", "mistral7b-b4-d128")] == 4
    assert picks[("decode_attention", "qwen2-g7-d128")] == 4
    assert picks[("paged_decode_attention", "qwen2-g7-d128")] == 4
