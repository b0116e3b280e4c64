"""The block-sparse dq kernel's tile walk, on the CPU.

The bf16/fp16 dq kernel (``csrc/block_sparse_bwd_dq.cu``, ``wgmma_bs_dq``)
runs only on the card, but the rule it follows runs here:

- it walks the forward kernel's tile tables (``build_tile_tables``, whose
  cover of every check case's layout ``tests/test_torch_block_sparse_tiles.py``
  checks); at the training shape (``gpt2-train-fixed16``) that walk takes 624
  stages a layout, at most 5 a tile;
- ``emulate_dq_tile_walk`` below, a plain emulation of the kernel's walk
  (each tile of 64 q rows, stage by stage, 64 k columns a stage, its two
  masks: an entry the row does not own scores -inf, p = 0 and ds = 0; a
  causally masked entry scores -1e30; ds split into hi = round(ds) and lo =
  round(ds - hi) in the input dtype, both summed in f32), equals
  ``block_sparse_bwd_dq_plain`` on every ``block_sparse_bwd_dq`` check case,
  and JAX's ``_bs_bwd`` dq (its Pallas kernel in interpret mode) on the
  hand-made layout, whose q-block 2 is empty (zeros) and whose q-block 3
  walks only k-block 5, past its diagonal (lse -1e30, p = 1);
- ``block_sparse_bwd_dq`` takes tile tables built from the forward table's
  layout, and refuses tile tables that walk another layout, miss an owner bit
  or miss a stage; ``BlockSparseAttnFunction.backward`` hands it the
  forward's tile tables.

Tolerance of the emulation, elementwise and derived as for the dk/dv walk
(``tests/test_torch_block_sparse_bwd_tiles.py``): the split keeps each
term's ds to within 2**-16 of itself in bf16 (hi has 8 bits, lo the next 8,
rounded) and 2**-22 in fp16 (11 and 11), plus half fp16's subnormal spacing
(2**-25) absolutely, and nothing in f32; both sides sum in f32 in other
orders (2**-20 of the sum of the terms' sizes covers it, and the scores'
own order moves p by less); each side forms dp and delta by f32 dot
products in its own order (JAX forms its own delta), which moves dp - delta
by up to 2**-20 of its terms' sizes, |do||v| + |do||o|, and ds by p * scale
times that: on a row of one key dp - delta is nothing but that noise; each
side rounds its f32 result to the dtype once, which can flip by one ulp
(2**-7 of the value in bf16, 2**-10 in fp16, 2**-23 in f32; at least fp16's
subnormal spacing, 2**-24). So |emulated - plain| <= (eps_split + 2**-20) *
sum|ds||k| + 2**-20 * scale * sum p (|do||v| + |do||o|) |k| + abs_split *
sum|k| (over the terms with ds != 0) + max(ulp * |plain|, ulp_min).
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import block_sparse as jbs
from deepspeed_tpu_torch.ops import kernel_checks as kc
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs

NEG_INF = tbs.NEG_INF
D = 32
#: the dq kernel's check cases: their layouts, lengths, dtypes and causality
CHECK_CASES = [c for c in kc.CASES if c.kernel == "block_sparse_bwd_dq"]
HAND_MADE = next(c for c in CHECK_CASES if c.name == "hand-made-empty-past-diagonal")
#: (relative error of the split, its absolute error, one rounding ulp
#: relative to the value, the smallest ulp) by dtype
SPLIT_EPS = {torch.bfloat16: (2.0 ** -16, 0.0, 2.0 ** -7, 0.0),
             torch.float16: (2.0 ** -22, 2.0 ** -25, 2.0 ** -10, 2.0 ** -24),
             torch.float32: (0.0, 0.0, 2.0 ** -23, 0.0)}
SUM_EPS = 2.0 ** -20


def test_training_layout_walks_624_stages():
    """The training main path's layout (``GPT2_SPARSE``, t 1024) in the
    forward's tiles: 624 stages over the 12 heads, at most 5 a tile."""
    case = next(c for c in CHECK_CASES if c.name == "gpt2-train-fixed16")
    tiles = tbs.build_tile_tables(kc.case_layout(case), 16)
    stages = -(-tiles.cnt // 4)
    assert int(stages.sum()) == 624 and int(stages.max()) == 5


# ------------------------------------------------------------------ the walk
def _split(x: torch.Tensor, dtype):
    """``(hi, lo)`` in f32: x rounded to ``dtype``, and the rest rounded."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def emulate_dq_tile_walk(q3, k3, v3, do3, lse, delta, tiles, block, scale, causal, n_heads):
    """The bf16/fp16 dq kernel's walk in plain tensor code: each tile of 64 q
    rows (Q and dO past t zero, owning nothing) walks its union stage by
    stage (64 k columns); an entry the row does not own scores -inf, a
    causally masked one -1e30; p = exp(s - lse), ds = p (dp - delta) scale in
    f32, split into hi and lo in the input dtype and both summed into f32 dq;
    the rows below t rounded once (an empty walk gives zeros)."""
    bh, t, d = q3.shape
    unit, rows, dtype = min(block, 64), tbs.TILE_ROWS, q3.dtype
    slots = rows // unit
    dq = torch.zeros(bh, t, d)
    unit_of_row = (np.arange(rows) // unit)[:, None]
    for head in range(n_heads):
        sel = list(range(head, bh, n_heads))
        k, v = k3[sel].float(), v3[sel].float()
        for tile in range(tiles.cnt.shape[1]):
            r0 = tile * rows
            n_live = min(rows, t - r0)
            r = torch.arange(r0, r0 + rows)
            qt, dot = torch.zeros(len(sel), rows, d), torch.zeros(len(sel), rows, d)
            lt, dl = torch.zeros(len(sel), rows), torch.zeros(len(sel), rows)
            for dst, src in ((qt, q3), (dot, do3), (lt, lse), (dl, delta)):
                dst[:, :n_live] = src[sel, r0:r0 + n_live].float()
            acc = torch.zeros(len(sel), rows, d)
            for st in range(-(-int(tiles.cnt[head, tile]) // slots)):
                ents = tiles.idx[head, tile, st * slots:(st + 1) * slots].astype(np.int64)
                cols = torch.from_numpy((ents[:, None] >> 8) * unit + np.arange(unit)).reshape(-1)
                own = torch.from_numpy((ents[None, :] & 0xFF) >> unit_of_row & 1 == 1)
                own = own.repeat_interleave(unit, 1)
                s = qt @ k[:, cols].transpose(1, 2) * scale
                if causal:
                    s = s.masked_fill(cols[None, None, :] > r[None, :, None], NEG_INF)
                s = s.masked_fill(~own[None], float("-inf"))
                p = torch.exp(s - lt[..., None])
                dp = dot @ v[:, cols].transpose(1, 2)
                ds = p * (dp - dl[..., None]) * scale
                hi, lo = _split(ds, dtype)
                acc += hi @ k[:, cols] + lo @ k[:, cols]
            dq[sel, r0:r0 + n_live] = acc[:, :n_live]
    return dq.to(dtype)


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


def _limit(case, q3, k3, v3, do3, o3, lse, delta, want):
    """The derived elementwise limit (module docstring), from the plain
    version's p and ds; and p."""
    eps, abs_eps, ulp, ulp_min = SPLIT_EPS[case.dtype]
    tables = tbs.device_tables(tbs.build_tables(kc.case_layout(case)), "cpu")
    p, ds = tbs._probs_and_ds(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                              tables["fwd_cnt"], kc.case_block(case), D ** -0.5, case.causal,
                              case.dims["h"], transposed=False)
    k, v, do = (x.float().abs() for x in (k3, v3, do3))
    dp_size = torch.einsum("ntd,nsd->nts", do, v) + (do * o3.float().abs()).sum(-1)[..., None]
    terms = torch.einsum("nts,nsd->ntd", ds.abs(), k)
    noise = torch.einsum("nts,nsd->ntd", p * dp_size, k) * D ** -0.5
    size = torch.einsum("nts,nsd->ntd", (ds != 0).float(), k)
    return (eps + SUM_EPS) * terms + SUM_EPS * noise + abs_eps * size + \
        torch.clamp_min(ulp * want.float().abs(), ulp_min), p


@pytest.mark.parametrize("case", CHECK_CASES, ids=lambda c: c.name)
def test_dq_tile_walk_equals_plain(case):
    q3, k3, v3, do3, o3, lse, layout = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    block, h = kc.case_block(case), case.dims["h"]
    got = emulate_dq_tile_walk(q3, k3, v3, do3, lse, delta, tbs.build_tile_tables(layout, block),
                               block, D ** -0.5, case.causal, h)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    want = tbs.block_sparse_bwd_dq_plain(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                                         tables["fwd_cnt"], block, D ** -0.5, case.causal, h)
    err = (got.float() - want.float()).abs()
    lim, _ = _limit(case, q3, k3, v3, do3, o3, lse, delta, want)
    assert bool((err <= lim).all()), float((err / lim).max())
    if case.layout[0] == "hand-made":
        # q-block 2 walks nothing
        assert not got[:, 2 * block:3 * block].any()


def test_dq_tile_walk_matches_jax_kernel_on_hand_made():
    """The emulated walk against the TPU kernel itself (``_bs_bwd`` in
    interpret mode, fed JAX's own forward), two batches of the hand-made
    layout in bf16: zeros for q-block 2, which walks nothing, and p = 1 on
    q-block 3's rows (lse -1e30), whose only block lies past the diagonal."""
    q3, k3, v3, do3, _, _, layout = _inputs(HAND_MADE, seed=1, b=2)
    block, h = kc.case_block(HAND_MADE), HAND_MADE.dims["h"]
    jt = {n: jnp.asarray(x) for n, x in jbs.build_tables(layout).items()}
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q3, k3, v3, do3)]
    o3, lse = jbs._bs_fwd(*jx[:3], jt["fwd_idx"], jt["fwd_cnt"], D ** -0.5, True, block, h)
    jdq, _, _ = jbs._bs_bwd(*jx[:3], o3, lse, jx[3], jt, D ** -0.5, True, block, h)
    lse = torch.from_numpy(np.array(lse))
    assert bool((lse[:, 2 * block:4 * block] == NEG_INF).all())
    o3 = torch.from_numpy(np.array(o3.astype(jnp.float32))).to(torch.bfloat16)
    delta = (do3.float() * o3.float()).sum(-1)
    got = emulate_dq_tile_walk(q3, k3, v3, do3, lse, delta,
                               tbs.build_tile_tables(layout, block), block, D ** -0.5, True, h)
    want = torch.from_numpy(np.array(jdq.astype(jnp.float32))).to(torch.bfloat16)
    lim, p = _limit(HAND_MADE, q3, k3, v3, do3, o3, lse, delta, want)
    # p = 1 on q-block 3's rows, for the keys of k-block 5
    assert bool((p[:, 3 * block:4 * block, 5 * block:6 * block] == 1).all())
    err = (got.float() - want.float()).abs()
    assert bool((err <= lim).all()), float((err / lim).max())
    assert not got[:, 2 * block:3 * block].any() and not want[:, 2 * block:3 * block].any()
    assert got[:, 3 * block:4 * block].any()


# ------------------------------------------------------------------ the wrapper
def _dq(case, layout, tiles):
    q3, k3, v3, do3, o3, lse, _ = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    return tbs.block_sparse_bwd_dq(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                                   tables["fwd_cnt"], kc.case_block(case), causal=case.causal,
                                   n_heads=case.dims["h"], tiles=tiles.to("cpu"))


@pytest.mark.parametrize("case", CHECK_CASES, ids=lambda c: c.name)
def test_dq_takes_tile_tables_of_its_layout(case):
    layout = kc.case_layout(case)
    got = _dq(case, layout, tbs.build_tile_tables(layout, kc.case_block(case)))
    q3, k3, v3, do3, o3, lse, _ = _inputs(case)
    delta = (do3.float() * o3.float()).sum(-1)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    want = tbs.block_sparse_bwd_dq_plain(q3, k3, v3, do3, lse, delta, tables["fwd_idx"],
                                         tables["fwd_cnt"], kc.case_block(case), D ** -0.5,
                                         case.causal, case.dims["h"])
    assert torch.equal(got, want)


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
    ti = int(np.argmax(cnt[0]))
    cnt[0, ti] = (cnt[0, ti] - 1) // slots * slots
    return tiles._replace(cnt=cnt)


@pytest.mark.parametrize("fault", [_other_layout, _bit_cleared, _stage_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_dq_refuses_tile_tables_of_another_walk(fault):
    """Tile tables that do not walk the forward table's layout raise: the
    bf16/fp16 kernel would otherwise give dq of another layout than its
    float32 path and the forward."""
    layout = kc.case_layout(HAND_MADE)
    tiles = fault(tbs.build_tile_tables(layout, kc.case_block(HAND_MADE)), layout)
    with pytest.raises(ValueError, match="do not walk the layout of the forward table"):
        _dq(HAND_MADE, layout, tiles)


def test_backward_hands_the_forward_tiles_to_dq():
    """``BlockSparseAttnFunction`` keeps the forward's tile tables for the
    backward and hands them to ``block_sparse_bwd_dq`` (the transposed
    layout's to ``block_sparse_bwd_dkv``); the gradients are the plain
    versions'."""
    q3, k3, v3, do3, o_plain, lse, layout = _inputs(HAND_MADE)
    block, h = kc.case_block(HAND_MADE), HAND_MADE.dims["h"]
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    tiles = tbs.build_tile_tables(layout, block).to("cpu")
    bwd_tiles = tbs.build_bwd_tile_tables(layout, block).to("cpu")
    seen = {}

    def spy(name, fn):
        def run(*args, **kw):
            seen[name] = kw.get("tiles")
            return fn(*args, **kw)
        return run

    leaves = [x.clone().requires_grad_() for x in (q3, k3, v3)]
    with mock.patch.object(tbs, "block_sparse_bwd_dq", spy("dq", tbs.block_sparse_bwd_dq)), \
            mock.patch.object(tbs, "block_sparse_bwd_dkv", spy("dkv", tbs.block_sparse_bwd_dkv)):
        o3 = tbs.BlockSparseAttnFunction.apply(*leaves, *(tables[n] for n in tbs.TABLE_NAMES),
                                               block, None, True, h, tiles, bwd_tiles)
        got = torch.autograd.grad(o3, leaves, do3)
    assert seen["dq"] is tiles and seen["dkv"] is bwd_tiles
    want = tbs.block_sparse_bwd(q3, k3, v3, o_plain, lse, do3, tables, block, causal=True,
                                n_heads=h)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
