"""The block-sparse forward kernel's tile walk, on the CPU.

The bf16/fp16 forward kernel (``csrc/block_sparse_fwd.cu``, ``wgmma_bs_fwd``)
runs only on the card, but the rule it follows runs here:

- ``build_tile_tables`` reproduces the layout of every block-sparse check case
  of ``ops/kernel_checks.py`` at layout blocks 16, 32, 64 and 128 (tiles of 64
  rows): each (row unit, k unit) the layout holds is walked once, in
  ascending order, by the tile that holds the row; each entry a row does not
  own has its bit clear; padding repeats a real entry and is owned by no row;
  the launch order puts the longest walks first;
- ``emulate_tile_walk`` below, a plain f32 emulation of the kernel's walk
  (stage by stage, 64 columns a stage, with its two masks: an entry the row
  does not own is excluded, p = 0 and no part in the max; a causally masked
  entry scores -1e30), equals ``block_sparse_fwd_plain`` on each check case
  whose tiles hold entries that some of their rows do not own, and JAX's
  ``_bs_fwd`` (its Pallas kernel in interpret mode) on the hand-made layout,
  whose q-block 2 is empty and whose q-block 3 walks only k-block 5, past its
  diagonal (zeros, the mean of block 5's V rows, lse -1e30);
- ``block_sparse_fwd`` takes tile tables built from the forward table's
  layout, for every check case's layout, and refuses tile tables that walk
  another layout, miss an owner bit or a stage, or give a row an entry it
  does not own.

Tolerances: the emulation and the plain version both compute in f32, in
other orders (online over stages against one softmax over the row), so (atol
2e-5, rtol 2e-5), as ``tests/test_torch_block_sparse.py`` holds f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import block_sparse as jbs
from deepspeed_tpu_torch.ops import kernel_checks as kc
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs

NEG_INF = tbs.NEG_INF
ATOL, RTOL = 2e-5, 2e-5
D = 32
#: the forward kernel's check cases: their layouts, lengths and causality
CHECK_CASES = [c for c in kc.CASES if c.kernel == "block_sparse_fwd"]
HAND_MADE = next(c for c in CHECK_CASES if c.name == "hand-made-empty-past-diagonal")


def _layout(case, block: int, t: int) -> np.ndarray:
    """The case's layout class at another block and length."""
    name, kw = case.layout
    if name == "hand-made":
        return kc.hand_made_layout(case.dims["h"], t, block)
    return getattr(tsa, name)(**{**kw, "block": block}).make_layout(t)


def _table_cases():
    for case in CHECK_CASES:
        for block in tbs.BLOCKS:
            if case.dims["t"] % block:
                continue            # t 1040 takes block 16 only
            t = max(case.dims["t"], 8 * block)      # at least 8 blocks (hand-made needs 6)
            yield pytest.param(case, block, t, id=f"{case.name}-block{block}-t{t}")


@pytest.mark.parametrize("case,block,t", list(_table_cases()))
def test_tile_tables_walk_the_layout(case, block, t):
    layout = _layout(case, block, t) != 0
    tiles = tbs.build_tile_tables(layout, block)
    unit = min(block, 64)
    if block > unit:
        layout = layout.repeat(block // unit, 1).repeat(block // unit, 2)
    h, nu, _ = layout.shape
    per_tile = slots = tbs.TILE_ROWS // unit
    n_tiles = -(-t // tbs.TILE_ROWS)
    assert all(x.dtype == np.int32 for x in tiles)
    assert tiles.idx.shape[:2] == tiles.cnt.shape == (h, n_tiles)
    assert tiles.idx.shape[2] % slots == 0
    walked = np.zeros((h, n_tiles * per_tile, nu), np.int64)
    stages = np.zeros((h, n_tiles), np.int64)
    for hi in range(h):
        for ti in range(n_tiles):
            cnt = int(tiles.cnt[hi, ti])
            stages[hi, ti] = -(-cnt // slots)
            ents = tiles.idx[hi, ti, :stages[hi, ti] * slots].astype(np.int64)
            units, bits = ents >> 8, ents & 0xFF
            assert np.all(np.diff(units[:cnt]) > 0)          # ascending, each once
            assert np.all(bits[:cnt] != 0) and np.all(bits < 1 << per_tile)
            if cnt:     # padding: a repeat of a real entry, owned by no row
                assert np.all(units[cnt:] == units[cnt - 1]) and not bits[cnt:].any()
            for g in range(per_tile):
                walked[hi, ti * per_tile + g, units[:cnt]] += bits[:cnt] >> g & 1
    assert np.array_equal(walked[:, :nu], layout.astype(np.int64))
    assert not walked[:, nu:].any()
    order = tiles.order.astype(np.int64)
    assert np.array_equal(np.sort(order), np.arange(h * n_tiles))
    assert np.all(np.diff(stages.reshape(-1)[order]) <= 0)   # the longest walks first


# ------------------------------------------------------------------ the walk
def emulate_tile_walk(q3, k3, v3, tiles, block, scale, causal, n_heads):
    """The bf16/fp16 forward kernel's walk in plain f32 tensor code: each tile
    of 64 q rows walks its union stage by stage (64 columns), an entry a row
    does not own scores -inf (p = 0, no part in the max), a causally masked
    one -1e30; online softmax from m = -1e30; o = acc / l (l 0 → 1), lse =
    m + log l, -1e30 where l is 0 or m -1e30."""
    bh, t, d = q3.shape
    unit, rows = min(block, 64), tbs.TILE_ROWS
    slots = rows // unit
    o = torch.zeros(bh, t, d)
    lse = torch.full((bh, t), NEG_INF)
    for head in range(n_heads):
        sel = list(range(head, bh, n_heads))
        q, k, v = q3[sel].float(), k3[sel].float(), v3[sel].float()
        for tile in range(tiles.cnt.shape[1]):
            r0 = tile * rows
            n_live = min(rows, t - r0)
            r = torch.arange(r0, r0 + rows)
            unit_of_row = (np.arange(rows) // unit)[:, None]
            qt = torch.zeros(len(sel), rows, d)
            qt[:, :n_live] = q[:, r0:r0 + n_live]
            m = torch.full((len(sel), rows), NEG_INF)
            l = torch.zeros(len(sel), rows)
            acc = torch.zeros(len(sel), rows, d)
            n_st = -(-int(tiles.cnt[head, tile]) // slots)
            for st in range(n_st):
                ents = tiles.idx[head, tile, st * slots:(st + 1) * slots].astype(np.int64)
                cols = torch.from_numpy((ents[:, None] >> 8) * unit + np.arange(unit)).reshape(-1)
                own = torch.from_numpy((ents[None, :] & 0xFF) >> unit_of_row & 1 == 1)
                own = own.repeat_interleave(unit, 1)
                s = qt @ k[:, cols].transpose(1, 2) * scale
                if causal:
                    s = s.masked_fill(cols[None, None, :] > r[None, :, None], NEG_INF)
                s = s.masked_fill(~own[None], float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ v[:, cols]
                m = m_new
            l_safe = torch.where(l > 0, l, torch.ones_like(l))
            out_lse = torch.where((l > 0) & (m > NEG_INF), m + torch.log(l_safe),
                                  torch.full_like(m, NEG_INF))
            o[sel, r0:r0 + n_live] = (acc / l_safe[..., None])[:, :n_live]
            lse[sel, r0:r0 + n_live] = out_lse[:, :n_live]
    return o, lse


def _inputs(case, seed=0, b=1):
    """Seeded f32 q, k, v ``(b*h, t, D)`` and the layout of ``case``."""
    rng = np.random.default_rng(seed)
    h, t = case.dims["h"], case.dims["t"]
    q3, k3, v3 = (torch.from_numpy(rng.standard_normal((b * h, t, D)).astype(np.float32))
                  for _ in range(3))
    return q3, k3, v3, kc.case_layout(case)


def _plain(case, q3, k3, v3, layout):
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    return tbs.block_sparse_fwd_plain(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"],
                                      kc.case_block(case), D ** -0.5, case.causal,
                                      case.dims["h"])


def _emulate(case, q3, k3, v3, layout):
    block = kc.case_block(case)
    return emulate_tile_walk(q3, k3, v3, tbs.build_tile_tables(layout, block), block,
                             D ** -0.5, case.causal, case.dims["h"])


def _partly_owned(case) -> bool:
    """Whether some tile of the case walks an entry that one of its rows
    does not own, so that the ownership mask matters."""
    block = kc.case_block(case)
    tiles = tbs.build_tile_tables(kc.case_layout(case), block)
    per_tile = tbs.TILE_ROWS // min(block, 64)
    n_units = case.dims["t"] // min(block, 64)
    for (hi, ti), cnt in np.ndenumerate(tiles.cnt):
        live = min(per_tile, n_units - ti * per_tile)
        if np.any(tiles.idx[hi, ti, :cnt] & 0xFF != (1 << live) - 1):
            return True
    return False


@pytest.mark.parametrize("case", [c for c in CHECK_CASES if _partly_owned(c)],
                         ids=lambda c: c.name)
def test_tile_walk_equals_plain(case):
    q3, k3, v3, layout = _inputs(case)
    o, lse = _emulate(case, q3, k3, v3, layout)
    want_o, want_lse = _plain(case, q3, k3, v3, layout)
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=ATOL, rtol=RTOL)
    if case is HAND_MADE:
        block = kc.case_block(case)
        assert not o[:, 2 * block:3 * block].any()
        assert bool((lse[:, 2 * block:4 * block] == NEG_INF).all())
        mean = v3[:, 5 * block:6 * block].mean(1, keepdim=True)
        np.testing.assert_allclose(o[:, 3 * block:4 * block].numpy(),
                                   mean.expand(-1, block, -1).numpy(), atol=2e-6, rtol=1e-5)


def test_tile_walk_matches_jax_kernel_on_hand_made():
    """The emulated walk against the TPU kernel itself (``_bs_fwd`` in
    interpret mode), two batches of the hand-made layout."""
    q3, k3, v3, layout = _inputs(HAND_MADE, seed=1, b=2)
    o, lse = _emulate(HAND_MADE, q3, k3, v3, layout)
    tables = jbs.build_tables(layout)
    want_o, want_lse = jbs._bs_fwd(*(jnp.asarray(x.numpy()) for x in (q3, k3, v3)),
                                   jnp.asarray(tables["fwd_idx"]), jnp.asarray(tables["fwd_cnt"]),
                                   D ** -0.5, True, kc.case_block(HAND_MADE),
                                   HAND_MADE.dims["h"])
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ the wrapper's check
def _fwd(case, layout, tiles):
    q3, k3, v3, _ = _inputs(case)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    return tbs.block_sparse_fwd(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"],
                                kc.case_block(case), causal=case.causal,
                                n_heads=case.dims["h"], tiles=tiles.to("cpu"))


@pytest.mark.parametrize("case", CHECK_CASES, ids=lambda c: c.name)
def test_fwd_takes_tile_tables_of_its_layout(case):
    layout = kc.case_layout(case)
    o, lse = _fwd(case, layout, tbs.build_tile_tables(layout, kc.case_block(case)))
    q3, k3, v3, _ = _inputs(case)
    want_o, want_lse = _plain(case, q3, k3, v3, layout)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def _other_layout(tiles, layout):
    """Tile tables of another layout of the same shape: the hand-made
    layout with its one block of q-block 3 moved from k-block 5 to 4."""
    other = layout.copy()
    other[:, 3, 5], other[:, 3, 4] = 0, 1
    return tbs.build_tile_tables(other, kc.case_block(HAND_MADE))


def _bit_cleared(tiles, layout):
    idx = tiles.idx.copy()
    idx[0, 0, 0] &= ~(idx[0, 0, 0] & -idx[0, 0, 0] & 0xFF)      # its lowest owner bit
    return tiles._replace(idx=idx)


def _stage_dropped(tiles, layout):
    slots = tbs.TILE_ROWS // kc.case_block(HAND_MADE)
    cnt = tiles.cnt.copy()
    cnt[0, 0] = (cnt[0, 0] - 1) // slots * slots
    return tiles._replace(cnt=cnt)


def _owner_added(tiles, layout):
    idx = tiles.idx.copy()
    idx[0, 0, 0] |= 0xF                                          # every q-block of the tile
    return tiles._replace(idx=idx)


@pytest.mark.parametrize("fault", [_other_layout, _bit_cleared, _stage_dropped, _owner_added],
                         ids=lambda f: f.__name__.strip("_"))
def test_fwd_refuses_tile_tables_of_another_walk(fault):
    """Tile tables that do not walk the forward table's layout raise, as the
    backward kernels walk that table: the forward would otherwise use one
    layout and the gradients another."""
    layout = kc.case_layout(HAND_MADE)
    tiles = fault(tbs.build_tile_tables(layout, kc.case_block(HAND_MADE)), layout)
    with pytest.raises(ValueError, match="do not walk the layout"):
        _fwd(HAND_MADE, layout, tiles)
