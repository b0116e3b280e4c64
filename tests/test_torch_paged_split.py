"""The paged decode kernel's split walk, emulated on the CPU, against the JAX
package's paged attention.

K5 (``deepspeed_tpu_torch/ops/csrc/paged_decode_attention.cu`` over
``decode_split.cuh``) splits each (slot, kv head) over the S blocks of a
thread-block cluster: block r takes the live pages [r * share, (r + 1) *
share), share = cdiv(cdiv(cache_len, page), S), computed on the device from
cache_len; a stage holds 64 // page pages (a page longer than 64 rows comes in
64-row pieces); a block takes G = 1, 2 or 4 of a group's query heads, and at
G = 4 has 8 consumer warps, else 4; consumer warp w takes rows [w * R, (w +
1) * R) of a stage (R = 64 / warps), and within it each group of LPR lanes
the rows w * R + t * RPI + its group index (LPR = d / 4 lanes a row at f32,
RPI = 32 / LPR), with its own online softmax over sub-tiles of up to 4 of
its rows. The partials merge by shuffles across
lane groups, in warp order, then in rank order. The emulation below walks the
same ranges, stages, warps and lane groups in f32 numpy, so the split's
arithmetic (empty splits, the -inf guards, the masking of rows past
cache_len, the merge) is held here; the kernel itself is held to the plain
version on the card (``tests/test_torch_kernels_cuda.py``). It lives in this
file only: nothing on the port's path carries it.

Held against JAX's ``paged_attention_fused`` (the Pallas kernel, interpret
mode) on every slot and ``paged_attention_xla`` on every slot with rows (for
a slot with cache_len 0 the TPU kernel gives zeros, the dense ground truth the
mean of its masked rows), f32, tolerance 2e-5 (the JAX tests' own for kernel
against ground truth), on ``tests/test_torch_paged_attention.py``'s inputs:
shuffled physical pages, 1e4 in the null page and past each length.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.ops.paged_attention import paged_attention_fused, paged_attention_xla
from deepspeed_tpu_torch.ops.attention.decode import SPLITS
from deepspeed_tpu_torch.ops.paged_attention import paged_split
from test_torch_paged_attention import _paged_inputs

TOL = 2e-5
STAGE_ROWS = 64


def _consumer_warps(g):
    """The consumer warps of a block of the kernel for g query heads a kv
    head (a block takes G = 1, 2 or 4 of them)."""
    return 8 if g > 2 else 4


def _rescale(m, m_new):
    """exp(m - m_new), 0 where m is -inf (also where m_new is)."""
    m = np.asarray(m, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(m == -np.inf, np.float32(0),
                        np.exp(m - np.asarray(m_new, np.float32))).astype(np.float32)


def _units(n, page):
    """The kernel's live units of a slot of n rows: (first row, rows, page
    column, row offset in the page) in row order, and the units a stage."""
    spp = -(-page // STAGE_ROWS)
    npg = -(-n // page)
    units = []
    for c in range(npg):
        for piece in range(spp):
            first = c * page + piece * STAGE_ROWS
            if first >= n:
                break
            units.append((first, min(STAGE_ROWS, page - piece * STAGE_ROWS), c,
                          piece * STAGE_ROWS))
    return units, (STAGE_ROWS // page if page <= STAGE_ROWS else 1)


def _block_partial(q, k, v, table_row, n, kh, page, share_units, d):
    """One block's partial (m, l, acc) over its units: (g,), (g,), (g, d), after
    its lane groups' and warps' merges."""
    units, pps = share_units
    g = q.shape[0]
    ncw = _consumer_warps(g)
    warp_rows = STAGE_ROWS // ncw
    lpr = d // 4
    rpi = 32 // lpr
    ni = warp_rows // rpi
    ts = min(ni, 4)
    # state of each (warp, lane group)
    m = np.full((ncw, rpi, g), -np.inf, np.float32)
    l = np.zeros((ncw, rpi, g), np.float32)
    acc = np.zeros((ncw, rpi, g, d), np.float32)
    for s0 in range(0, len(units), pps):
        stage = units[s0:s0 + pps]
        unit_rows = min(page, STAGE_ROWS)
        rows_k = np.zeros((STAGE_ROWS, d), np.float32)
        rows_v = np.zeros((STAGE_ROWS, d), np.float32)
        for i, (_, rows, col, off) in enumerate(stage):
            phys = table_row[col]
            rows_k[i * unit_rows:i * unit_rows + rows] = k[phys, kh, off:off + rows]
            rows_v[i * unit_rows:i * unit_rows + rows] = v[phys, kh, off:off + rows]
        stage_rows = (len(stage) - 1) * unit_rows + stage[-1][1]
        nvalid = min(stage_rows, n - stage[0][0])
        for w in range(ncw):
            for sub in range(ni // ts):
                r0 = w * warp_rows + sub * ts * rpi
                if r0 >= nvalid:
                    break
                for lg in range(rpi):
                    idx = [r0 + t * rpi + lg for t in range(ts)]
                    sc = (q @ rows_k[idx].T).astype(np.float32)           # (g, ts)
                    sc[:, [i >= nvalid for i in idx]] = -np.inf
                    mx = np.maximum(m[w, lg], sc.max(axis=1))
                    alpha = _rescale(m[w, lg], mx)
                    p = _rescale(sc, mx[:, None])
                    l[w, lg] = l[w, lg] * alpha + p.sum(axis=1)
                    acc[w, lg] = acc[w, lg] * alpha[:, None] + p @ rows_v[idx]
                    m[w, lg] = mx
    # lane groups merge by the butterfly, then warps in warp order
    wm = m.max(axis=1)
    sc = _rescale(m, wm[:, None])
    wl = (l * sc).sum(axis=1)
    wacc = (acc * sc[..., None]).sum(axis=1)
    bm = wm.max(axis=0)
    bl = np.zeros_like(bm)
    bacc = np.zeros((g, d), np.float32)
    for w in range(ncw):
        s = _rescale(wm[w], bm)
        bl = bl + wl[w] * s
        bacc = bacc + wacc[w] * s[:, None]
    return bm, bl, bacc


def emulate_split_walk(q, k, v, table, lens, splits):
    """The kernel's walk at S = splits, f32: per (slot, kv head), each rank's
    contiguous share of the live units, merged in rank order; zeros where no
    row is live."""
    b, h, d = q.shape
    hk, page = k.shape[1], k.shape[2]
    g = h // hk
    cap_rows = table.shape[1] * page
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((b, h, d), np.float32)
    for i in range(b):
        n = min(max(int(lens[i]), 0), cap_rows)
        units, pps = _units(n, page)
        share = -(-len(units) // splits)
        for kh in range(hk):
            for j0 in range(0, g, 4):           # a block's heads
                heads = slice(kh * g + j0, kh * g + min(j0 + 4, g))
                qs = (q[i, heads] * scale).astype(np.float32)
                parts = [_block_partial(qs, k, v, table[i], n, kh, page,
                                        (units[r * share:(r + 1) * share], pps), d)
                         for r in range(splits)]
                out[i, heads] = merge_ranks(parts)
    return out


def merge_ranks(parts):
    """The cluster's merge of its blocks' partials (m, l, acc), in rank
    order: the output rows of the block's heads, zeros where no row was
    seen."""
    mx = np.max([p[0] for p in parts], axis=0)
    a = np.zeros_like(parts[0][2])
    ls = np.zeros_like(mx)
    for pm, pl, pacc in parts:          # rank order
        s = _rescale(pm, mx)
        a = a + pacc * s[:, None]
        ls = ls + pl * s
    return np.where(ls[:, None] > 0, a / np.where(ls > 0, ls, 1)[:, None], 0)


CASES = {
    # name: (b, h, hk, d, page, cap, lens, shuffled physical pages)
    "empty-slot-gqa": (3, 8, 2, 64, 16, 256, (0, 200, 33), True),
    "gqa-8-heads-two-blocks": (2, 8, 1, 128, 16, 160, (160, 70), True),
    "page-1": (2, 4, 4, 64, 1, 130, (130, 41), True),
    "cap-not-page-multiple": (2, 4, 2, 64, 8, 300, (300, 77), True),
    "page-5-d128": (2, 4, 4, 128, 5, 200, (200, 11), True),
    "page-96-pieces": (2, 4, 2, 64, 96, 400, (400, 97), True),
    "contiguous-pages": (2, 4, 4, 64, 16, 160, (160, 5), False),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's numpy inputs and JAX's two outputs, computed once."""
    b, h, hk, d, page, cap, lens, shuffle = CASES[name]
    q, k, v, table, lens = _paged_inputs(len(name), b, h, hk, d, page, cap, lens, shuffle)
    jq, jk, jv, jt, jl = map(jnp.asarray, (q, k, v, table, lens))
    fused = np.asarray(paged_attention_fused(jq, jk, jv, jt, jl))
    xla = np.asarray(paged_attention_xla(jq, jk, jv, jt, jl, cap))
    return (q, k, v, table, lens), fused, xla


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_walk_matches_jax(name, splits):
    (q, k, v, table, lens), fused, xla = _case(name)
    out = emulate_split_walk(q, k, v, table, lens, splits)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, fused, atol=TOL, rtol=TOL)
    live = lens > 0
    np.testing.assert_allclose(out[live], xla[live], atol=TOL, rtol=TOL)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("splits", SPLITS)
def test_split_walk_short_slots_leave_splits_empty(splits):
    """Lengths 1 and page * S - 1: with 16-row pages the second slot has S
    live pages but one row short, the first a single row, so all splits but
    the first walk nothing there, and with S > 1 the last page of the second
    is partly masked; held to JAX as above."""
    page = 16
    lens = (1, page * splits - 1)
    q, k, v, table, lens = _paged_inputs(40 + splits, 2, 4, 2, 64, page, 8 * page, lens)
    jq, jk, jv, jt, jl = map(jnp.asarray, (q, k, v, table, lens))
    out = emulate_split_walk(q, k, v, table, lens, splits)
    np.testing.assert_allclose(out, np.asarray(paged_attention_fused(jq, jk, jv, jt, jl)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, np.asarray(paged_attention_xla(jq, jk, jv, jt, jl, 8 * page)),
                               atol=TOL, rtol=TOL)


def test_split_walk_balances_each_pair():
    """The ranks' shares cover the live units once, in order; every rank
    before the last busy one takes cdiv(units, S), so the longest walk of a
    pair is 1/S of its slot's, whatever the length; the last unit holds row
    len - 1."""
    for n, page, splits in ((630, 16, 2), (2048, 16, 8), (101, 16, 8), (200, 1, 4), (97, 96, 2)):
        units, _ = _units(n, page)
        share = -(-len(units) // splits)
        shares = [units[r * share:(r + 1) * share] for r in range(splits)]
        busy = [len(x) for x in shares if x]
        assert sum(shares, []) == units
        assert busy[:-1] == [share] * (len(busy) - 1) and 0 < busy[-1] <= share
        assert units[-1][0] < n <= units[-1][0] + units[-1][1]


def test_paged_split_reads_shapes_only():
    """paged_split takes shapes, never cache_len: its arguments are seven
    integers (the query heads of a group and the element size too, which
    set the blocks an SM holds), and it returns one of SPLITS."""
    assert list(inspect.signature(paged_split).parameters) == ["b", "hk", "max_pages", "page",
                                                                "d", "g", "itemsize"]
    for args in ((1, 1, 1, 1, 64, 1, 2), (64, 32, 4096, 16, 128, 4, 2), (3, 7, 11, 5, 64, 7, 4)):
        assert paged_split(*args) in SPLITS


@pytest.mark.parametrize("max_pages,page,d", [(64, 16, 64), (128, 16, 128), (200, 1, 64),
                                              (103, 5, 128)])
def test_paged_split_grows_as_pairs_fall(max_pages, page, d):
    """Fewer (slot, kv head) pairs never take fewer splits, at any group."""
    for g, itemsize in ((1, 2), (4, 2), (7, 2), (4, 4)):
        picks = [paged_split(b, hk, max_pages, page, d, g, itemsize) for b, hk in
                 ((64, 16), (16, 12), (16, 4), (8, 4), (4, 4), (2, 2), (1, 1))]
        assert picks == sorted(picks)
        assert all(s in SPLITS for s in picks)


def test_paged_split_at_the_main_path_shapes():
    """The [serve] shape (16 slots, 12 kv heads, cap 1024, page 16, d 64)
    and kernel_checks' gqa-d128 (4 slots, 4 kv heads, cap 2048, d 128) both
    split, so the merge runs on the main path and its planted fault shows."""
    assert paged_split(16, 12, 64, 16, 64, 1, 2) == 2
    assert paged_split(4, 4, 128, 16, 128, 4, 2) == 8
