"""The block-sparse dk/dv kernel's tile walk, on the CPU.

The bf16/fp16 dk/dv kernel (``csrc/block_sparse_bwd_dkv.cu``,
``wgmma_bs_dkv``) runs only on the card, but the rule it follows runs here:

- ``build_bwd_tile_tables`` covers the transposed layout of every
  ``block_sparse_bwd_dkv`` check case of ``ops/kernel_checks.py`` at layout
  blocks 16, 32, 64 and 128 (tiles of 64 k rows): each tile's members are
  k-units of one head, and the members of a head's tiles are its k-units,
  each once; each (k-unit, q-unit) pair the transposed layout holds is
  walked once, by the tile that holds the k-unit, with the member's bit set,
  and every other bit of the walk is clear (entries a member is not attended
  by, and the padding, a repeat of a real q-unit); the launch order puts the
  longest walks first; no head walks more stages than consecutive k-units
  would; at the training shape (``gpt2-train-fixed16``) the walk takes 846
  stages a layout against 1,632 for consecutive k-units;
- ``emulate_bwd_tile_walk`` below, a plain emulation of the kernel's walk
  (stage by stage, 64 q columns a stage, its two masks: an entry the member
  is not attended by scores -inf, p = 0 and ds = 0; a causally masked entry
  scores -1e30; p and ds split into hi = round(x) and lo = round(x - hi) in
  the input dtype, both summed in f32), equals ``block_sparse_bwd_dkv_plain``
  on every check case, and JAX's ``_bs_bwd`` (its Pallas kernel in interpret
  mode) on the hand-made layout, whose k-block 2 no q-block attends to
  (zeros) and whose q-block 3 walks only k-block 5, past its diagonal (lse
  -1e30, p = 1);
- ``block_sparse_bwd_dkv`` takes tile tables built from the transposed
  table's layout, and refuses tile tables that walk another layout, miss a
  member bit or a stage, or hold a k-unit twice.

Tolerance of the emulation, elementwise and derived: the split keeps each
term's p (or ds) to within 2**-16 of itself in bf16 (hi has 8 bits, lo the
next 8, rounded) and 2**-22 in fp16 (11 and 11), plus half fp16's
subnormal spacing (2**-25) absolutely, and nothing in f32; both sides sum
in f32 in other orders (2**-20 of the sum of the terms' sizes covers it);
each side rounds its f32 result to the dtype once, which can flip by one
ulp (2**-7 of the value in bf16, 2**-10 in fp16, 2**-23 in f32; at least
fp16's subnormal spacing, 2**-24). So |emulated - plain| <= (eps_split +
2**-20) * sum|p||do| (dv; |ds||q| for dk) + abs_split * sum|do| +
max(ulp * |plain|, ulp_min).
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
D = 32
#: the dk/dv kernel's check cases: their layouts, lengths, dtypes and causality
CHECK_CASES = [c for c in kc.CASES if c.kernel == "block_sparse_bwd_dkv"]
HAND_MADE = next(c for c in CHECK_CASES if c.name == "hand-made-empty-past-diagonal")
#: (relative error of the split, its absolute error, one rounding ulp
#: relative to the value, the smallest ulp) by dtype
SPLIT_EPS = {torch.bfloat16: (2.0 ** -16, 0.0, 2.0 ** -7, 0.0),
             torch.float16: (2.0 ** -22, 2.0 ** -25, 2.0 ** -10, 2.0 ** -24),
             torch.float32: (0.0, 0.0, 2.0 ** -23, 0.0)}
SUM_EPS = 2.0 ** -20


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


def _units(layout, block):
    unit = min(block, 64)
    layout = np.asarray(layout) != 0
    if block > unit:
        layout = layout.repeat(block // unit, 1).repeat(block // unit, 2)
    return layout, unit


def _stages(lt_head: np.ndarray, members: np.ndarray, slots: int) -> int:
    """Stages the tiles ``members`` ``(n_tiles, slots)`` of one head's
    transposed layout walk."""
    union = [lt_head[m[m >= 0]].any(0).sum() for m in members]
    return int(sum(-(-u // slots) for u in union))


@pytest.mark.parametrize("case,block,t", list(_table_cases()))
def test_bwd_tile_tables_walk_the_transposed_layout(case, block, t):
    layout, unit = _units(_layout(case, block, t), block)
    lt = layout.transpose(0, 2, 1)                 # [head, k-unit, q-unit]
    tiles = tbs.build_bwd_tile_tables(_layout(case, block, t), block)
    h, nu, _ = lt.shape
    slots = tbs.TILE_ROWS // unit
    n_tiles = -(-t // tbs.TILE_ROWS)
    assert all(x.dtype == np.int32 for x in tiles)
    assert tiles.members.shape == (h, n_tiles, slots)
    assert tiles.idx.shape[:2] == tiles.cnt.shape == (h, n_tiles)
    assert tiles.idx.shape[2] % slots == 0
    walked = np.zeros((h, nu, nu), np.int64)
    stages = np.zeros((h, n_tiles), np.int64)
    for hi in range(h):
        members = tiles.members[hi].astype(np.int64)
        assert np.array_equal(np.sort(members[members >= 0]), np.arange(nu))
        for ti in range(n_tiles):
            cnt = int(tiles.cnt[hi, ti])
            stages[hi, ti] = -(-cnt // slots)
            ents = tiles.idx[hi, ti, :stages[hi, ti] * slots].astype(np.int64)
            units, bits = ents >> 8, ents & 0xFF
            assert np.all(np.diff(units[:cnt]) > 0)          # ascending, each once
            if cnt:     # padding: a repeat of a real q-unit, owned by no member
                assert np.all(units[cnt:] == units[cnt - 1]) and not bits[cnt:].any()
            for g, m in enumerate(members[ti]):
                own = bits[:cnt] >> g & 1
                if m < 0:
                    assert not own.any()
                    continue
                # the bit is set exactly where the q-unit attends to the member
                assert np.array_equal(own == 1, lt[hi, m, units[:cnt]])
                walked[hi, m, units[:cnt]] += own
        contiguous = np.full(n_tiles * slots, -1)
        contiguous[:nu] = np.arange(nu)
        assert stages[hi].sum() <= _stages(lt[hi], contiguous.reshape(n_tiles, slots), slots)
    assert np.array_equal(walked, lt.astype(np.int64))
    order = tiles.order.astype(np.int64)
    assert np.array_equal(np.sort(order), np.arange(h * n_tiles))
    assert np.all(np.diff(stages.reshape(-1)[order]) <= 0)   # the longest walks first


def test_training_layout_walks_846_stages():
    """The training main path's layout (``GPT2_SPARSE``, t 1024): the grouped
    k-units walk 846 stages over the 12 heads, consecutive ones 1,632."""
    case = next(c for c in CHECK_CASES if c.name == "gpt2-train-fixed16")
    layout = kc.case_layout(case)
    tiles = tbs.build_bwd_tile_tables(layout, 16)
    assert int((-(-tiles.cnt // 4)).sum()) == 846
    lt = (layout != 0).transpose(0, 2, 1)
    contiguous = np.arange(64).reshape(16, 4)
    assert sum(_stages(lt[hi], contiguous, 4) for hi in range(12)) == 1632


# ------------------------------------------------------------------ the walk
def _split(x: torch.Tensor, dtype):
    """``(hi, lo)`` in f32: x rounded to ``dtype``, and the rest rounded."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def emulate_bwd_tile_walk(q3, k3, v3, do3, lse, delta, tiles, block, scale, causal, n_heads):
    """The bf16/fp16 dk/dv kernel's walk in plain tensor code: each tile of
    64 k rows (its members' units; a missing member's slot holds member 0's
    rows) walks its union stage by stage (64 q columns); an entry the member
    is not attended by scores -inf, a causally masked one -1e30; p =
    exp(s - lse), ds = p (dp - delta) scale in f32, each split into hi and lo
    in the input dtype and both summed into f32 dv and dk; each member's rows
    rounded once."""
    bh, t, d = q3.shape
    unit, dtype = min(block, 64), q3.dtype
    slots = tbs.TILE_ROWS // unit
    dk = torch.zeros(bh, t, d)
    dv = torch.zeros(bh, t, d)
    member_of_row = torch.arange(tbs.TILE_ROWS) // unit
    for head in range(n_heads):
        sel = list(range(head, bh, n_heads))
        q, k, v, do = (x[sel].float() for x in (q3, k3, v3, do3))
        ls, dl = lse[sel], delta[sel]
        for tile in range(tiles.cnt.shape[1]):
            members = tiles.members[head, tile].astype(np.int64)
            slot_units = np.where(members >= 0, members, members[0])
            kpos = torch.from_numpy((slot_units[:, None] * unit + np.arange(unit)).reshape(-1))
            kt, vt = k[:, kpos], v[:, kpos]
            dk_acc = torch.zeros(len(sel), tbs.TILE_ROWS, d)
            dv_acc = torch.zeros(len(sel), tbs.TILE_ROWS, d)
            for st in range(-(-int(tiles.cnt[head, tile]) // slots)):
                ents = tiles.idx[head, tile, st * slots:(st + 1) * slots].astype(np.int64)
                qpos = (ents >> 8)[:, None] * unit + np.arange(unit)
                qpos = torch.from_numpy(qpos.reshape(-1))
                own = torch.from_numpy(ents & 0xFF)[None, :] >> member_of_row[:, None] & 1 == 1
                own = own.repeat_interleave(unit, 1)
                s = kt @ q[:, qpos].transpose(1, 2) * scale
                if causal:
                    s = s.masked_fill(kpos[None, :, None] > qpos[None, None, :], NEG_INF)
                s = s.masked_fill(~own[None], float("-inf"))
                p = torch.exp(s - ls[:, None, qpos])
                dp = vt @ do[:, qpos].transpose(1, 2)
                ds = p * (dp - dl[:, None, qpos]) * scale
                for x, rhs, acc in ((p, do, dv_acc), (ds, q, dk_acc)):
                    hi, lo = _split(x, dtype)
                    acc += hi @ rhs[:, qpos] + lo @ rhs[:, qpos]
            for g, m in enumerate(members):
                if m >= 0:
                    rows = slice(m * unit, (m + 1) * unit)
                    dk[sel, rows] = dk_acc[:, g * unit:(g + 1) * unit]
                    dv[sel, rows] = dv_acc[:, g * unit:(g + 1) * unit]
    return dk.to(k3.dtype), dv.to(v3.dtype)


def _inputs(case, seed=0, b=1):
    """Seeded ``(b*h, t, D)`` q, k, v, do in the case's dtype (numpy draws),
    the layout, and o and lse of the plain forward."""
    rng = np.random.default_rng(seed)
    h, t = case.dims["h"], case.dims["t"]
    q3, k3, v3, do3 = (torch.from_numpy(rng.standard_normal((b * h, t, D)).astype(np.float32))
                       .to(case.dtype) for _ in range(4))
    layout = kc.case_layout(case)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    o3, lse = tbs.block_sparse_fwd_plain(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"],
                                         kc.case_block(case), D ** -0.5, case.causal, h)
    return q3, k3, v3, do3, o3, lse, layout


def _limit(case, q3, do3, p, ds, want):
    """The derived elementwise limit (module docstring) for dk and dv."""
    eps, abs_eps, ulp, ulp_min = SPLIT_EPS[case.dtype]

    def one(x, rhs, ref):
        terms = torch.einsum("nts,ntd->nsd", x.abs(), rhs.float().abs())
        size = torch.einsum("nts,ntd->nsd", (x != 0).float(), rhs.float().abs())
        return (eps + SUM_EPS) * terms + abs_eps * size + \
            torch.clamp_min(ulp * ref.float().abs(), ulp_min)

    return one(ds, q3, want[0]), one(p, do3, want[1])


def _probs(case, q3, k3, v3, do3, lse, delta, tables):
    return tbs._probs_and_ds(q3, k3, v3, do3, lse, delta, tables["bwd_idx"], tables["bwd_cnt"],
                             kc.case_block(case), D ** -0.5, case.causal, case.dims["h"],
                             transposed=True)


@pytest.mark.parametrize("case", CHECK_CASES, ids=lambda c: c.name)
def test_bwd_tile_walk_equals_plain(case):
    q3, k3, v3, do3, o3, lse, layout = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    block, h = kc.case_block(case), case.dims["h"]
    tiles = tbs.build_bwd_tile_tables(layout, block)
    got = emulate_bwd_tile_walk(q3, k3, v3, do3, lse, delta, tiles, block, D ** -0.5,
                                case.causal, h)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    want = tbs.block_sparse_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                          tables["bwd_cnt"], block, D ** -0.5, case.causal, h)
    p, ds = _probs(case, q3, k3, v3, do3, lse, delta, tables)
    for g, w, lim in zip(got, want, _limit(case, q3, do3, p, ds, want)):
        err = (g.float() - w.float()).abs()
        assert bool((err <= lim).all()), float((err / lim).max())
    if case.layout[0] == "hand-made":
        # k-block 2: no q-block attends to it
        assert not got[0][:, 2 * block:3 * block].any()
        assert not got[1][:, 2 * block:3 * block].any()


def test_bwd_tile_walk_matches_jax_kernel_on_hand_made():
    """The emulated walk against the TPU kernel itself (``_bs_bwd`` in
    interpret mode, fed JAX's own forward), two batches of the hand-made
    layout in bf16: zeros for k-block 2, which no q-block attends to, and
    p = 1 on q-block 3's rows (lse -1e30), whose only block lies past the
    diagonal."""
    q3, k3, v3, do3, _, _, layout = _inputs(HAND_MADE, seed=1, b=2)
    block, h = kc.case_block(HAND_MADE), HAND_MADE.dims["h"]
    jt = {n: jnp.asarray(x) for n, x in jbs.build_tables(layout).items()}
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q3, k3, v3, do3)]
    o3, lse = jbs._bs_fwd(*jx[:3], jt["fwd_idx"], jt["fwd_cnt"], D ** -0.5, True, block, h)
    _, jdk, jdv = jbs._bs_bwd(*jx[:3], o3, lse, jx[3], jt, D ** -0.5, True, block, h)
    lse = torch.from_numpy(np.array(lse))
    assert bool((lse[:, 3 * block:4 * block] == NEG_INF).all())
    o3 = torch.from_numpy(np.array(o3.astype(jnp.float32))).to(torch.bfloat16)
    delta = (do3.float() * o3.float()).sum(-1)
    got = emulate_bwd_tile_walk(q3, k3, v3, do3, lse, delta,
                                tbs.build_bwd_tile_tables(layout, block), block, D ** -0.5,
                                True, h)
    want = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
            for x in (jdk, jdv)]
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    p, ds = _probs(HAND_MADE, q3, k3, v3, do3, lse, delta, tables)
    # p = 1 on q-block 3's rows, for the keys of k-block 5
    assert bool((p[:, 3 * block:4 * block, 5 * block:6 * block] == 1).all())
    for g, w, lim in zip(got, want, _limit(HAND_MADE, q3, do3, p, ds, want)):
        err = (g.float() - w.float()).abs()
        assert bool((err <= lim).all()), float((err / lim).max())
        assert not g[:, 2 * block:3 * block].any() and not w[:, 2 * block:3 * block].any()


# ------------------------------------------------------------------ the wrapper's check
def _dkv(case, layout, tiles):
    q3, k3, v3, do3, o3, lse, _ = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    return tbs.block_sparse_bwd_dkv(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                    tables["bwd_cnt"], kc.case_block(case), causal=case.causal,
                                    n_heads=case.dims["h"], tiles=tiles.to("cpu"))


@pytest.mark.parametrize("case", CHECK_CASES, ids=lambda c: c.name)
def test_dkv_takes_tile_tables_of_its_layout(case):
    layout = kc.case_layout(case)
    got = _dkv(case, layout, tbs.build_bwd_tile_tables(layout, kc.case_block(case)))
    q3, k3, v3, do3, o3, lse, _ = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    want = tbs.block_sparse_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, tables["bwd_idx"],
                                          tables["bwd_cnt"], kc.case_block(case), D ** -0.5,
                                          case.causal, case.dims["h"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _other_layout(tiles, layout):
    """Tile tables of another layout of the same shape: the hand-made
    layout with its one block of q-block 3 moved from k-block 5 to 4."""
    other = layout.copy()
    other[:, 3, 5], other[:, 3, 4] = 0, 1
    return tbs.build_bwd_tile_tables(other, kc.case_block(HAND_MADE))


def _bit_cleared(tiles, layout):
    idx = tiles.idx.copy()
    idx[0, 0, 0] &= ~(idx[0, 0, 0] & -idx[0, 0, 0] & 0xFF)      # its lowest member bit
    return tiles._replace(idx=idx)


def _stage_dropped(tiles, layout):
    slots = tbs.TILE_ROWS // kc.case_block(HAND_MADE)
    cnt = tiles.cnt.copy()
    ti = int(np.argmax(cnt[0]))
    cnt[0, ti] = (cnt[0, ti] - 1) // slots * slots
    return tiles._replace(cnt=cnt)


def _member_twice(tiles, layout):
    members = tiles.members.copy()
    members[0, 0, 1] = members[0, 0, 0]
    return tiles._replace(members=members)


@pytest.mark.parametrize("fault", [_other_layout, _bit_cleared, _stage_dropped, _member_twice],
                         ids=lambda f: f.__name__.strip("_"))
def test_dkv_refuses_tile_tables_of_another_walk(fault):
    """Tile tables that do not walk the transposed table's layout raise: the
    bf16/fp16 kernel would otherwise give gradients of another layout than
    its float32 path and the forward."""
    layout = kc.case_layout(HAND_MADE)
    tiles = fault(tbs.build_bwd_tile_tables(layout, kc.case_block(HAND_MADE)), layout)
    with pytest.raises(ValueError, match="do not walk the layout of the transposed table"):
        _dkv(HAND_MADE, layout, tiles)
