"""The selected-expert FFN kernel's walk, emulated on the CPU, against the JAX
package's kernel and the port's plain version.

K7 (``deepspeed_tpu_torch/ops/csrc/moe_decode_ffn.cu``) runs one of two FFN
kernels, as ``ops/moe/decode_ffn.py:moe_plan`` picks from the shapes, then
one reduction:

- the tensor-core kernel (one or two 16-bit tokens, where its shared
  memory fits): blocks (token, f-block); h's sums split over 8 warps by d's
  16-row steps, added in warp order, then b1, the activation and one
  rounding; the block's partial output is h @ w2's slab;
- the slab kernel (the first version's): blocks (token, f-block); h's sums
  over G = 256 / (nf / VEC) row groups (rows g, g + G, ... in order), the
  groups added in order; the partial output over the same kind of row
  groups of w2's slab where d / VEC < 256;
- the reduction: y = b2 + the sums over 8 thread groups g of the partials of
  f-blocks j = g, g + 8, ... in order, g in order.

The emulation below walks those splits in numpy f32 (inside a warp's
16-row step or a row group the sum is numpy's), rounding h where the kernel
does. Ids outside [0, e) are clamped, as the kernel clamps them; JAX's kernel
and the plain version get the clamped ids. Inputs come from a seeded numpy
generator, rounded to the dtype before either side sees them. Tolerances
are ``kernel_checks.MOE_TOLERANCES``: both sides take exact products of the
stored values with f32 sums in other orders, and round h once, which can
flip an element of h by one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu.ops import moe as jax_ops_moe
from deepspeed_tpu_torch.ops import kernel_checks
from deepspeed_tpu_torch.ops.moe import decode_ffn as port

THREADS, WARPS, RED_GROUPS = 256, 8, 8
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _round(a: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values rounded to dtype and widened back."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        TORCH_DTYPES[dtype]).float().numpy()


def _act(name: str, v: np.ndarray) -> np.ndarray:
    return port.ACTIVATIONS[name](torch.from_numpy(v)).numpy()


def reduce_partials(part, ids, b2):
    """y_i = b2[ids_i] + the sums over g < 8 (in order) of the partials of
    f-blocks g, g + 8, ... (in order)."""
    n, nfb, d = part.shape
    y = np.zeros((n, d), np.float32)
    for i in range(n):
        groups = []
        for g in range(RED_GROUPS):
            s = np.zeros(d, np.float32)
            for j in range(g, nfb, RED_GROUPS):
                s = s + part[i, j]
            groups.append(s)
        v = b2[ids[i]].copy()
        for s in groups:
            v = v + s
        y[i] = v
    return y


def mma_walk(x, ids, w1, b1, w2, act, dtype, bf):
    """The tensor-core kernel's partial outputs (n, nfb, d)."""
    n, d = x.shape
    f = w1.shape[2]
    nfb = -(-f // bf)
    part = np.full((n, nfb, d), np.nan, np.float32)
    ks_all = -(-d // 16)
    for i in range(n):
        ex = ids[i]
        for j in range(nfb):
            f0, nf = j * bf, min(bf, f - j * bf)
            hsum = np.zeros(nf, np.float32)
            for w in range(WARPS):
                r0, r1 = w * ks_all // WARPS * 16, min((w + 1) * ks_all // WARPS * 16, d)
                hsum = hsum + x[i, r0:r1] @ w1[ex, r0:r1, f0:f0 + nf]
            h = _round(_act(act, hsum + b1[ex, f0:f0 + nf]), dtype)
            part[i, j] = h @ w2[ex, f0:f0 + nf]
    return part


def _row_groups(m, rows, G):
    """sum over row groups g < G in order of (the rows g, g + G, ... of m)."""
    return sum((m[g:rows:G].sum(axis=0) for g in range(G)), np.zeros(m.shape[1:], np.float32))


def slab_walk(x, ids, w1, b1, w2, act, dtype, bf, vec):
    """The slab kernel's partial outputs (n, nfb, d)."""
    n, d = x.shape
    f = w1.shape[2]
    nfb = -(-f // bf)
    part = np.full((n, nfb, d), np.nan, np.float32)
    for i in range(n):
        ex = ids[i]
        for j in range(nfb):
            f0, nf = j * bf, min(bf, f - j * bf)
            G = THREADS // (nf // vec)
            terms = x[i, :, None] * w1[ex, :, f0:f0 + nf]            # (d, nf) exact products
            h = _round(_act(act, _row_groups(terms, d, G) + b1[ex, f0:f0 + nf]), dtype)
            terms = h[:, None] * w2[ex, f0:f0 + nf]                  # (nf, d)
            cvd = d // vec
            part[i, j] = terms.sum(axis=0) if cvd >= THREADS else \
                _row_groups(terms, nf, THREADS // cvd)
    return part


def walk(inp, act, dtype):
    """The kernel's y for these inputs, by the walk ``moe_plan`` picks."""
    x, w1, b1, w2, b2 = (inp[k] for k in ("x", "w1", "b1", "w2", "b2"))
    n, d = x.shape
    e, _, f = w1.shape
    ids = np.clip(inp["idx"], 0, e - 1)
    itemsize = torch.tensor([], dtype=TORCH_DTYPES[dtype]).element_size()
    bf, mode = port.moe_plan(n, d, f, itemsize)
    if mode == port.SLAB:
        vec = 16 // itemsize
        vec = vec if d % vec == 0 and f % vec == 0 and bf % vec == 0 else 1
        part = slab_walk(x, ids, w1, b1, w2, act, dtype, bf, vec)
    else:
        part = mma_walk(x, ids, w1, b1, w2, act, dtype, bf)
    assert not np.isnan(part).any(), "a partial output the walk never wrote"
    return reduce_partials(part, ids, b2), mode


def _inputs(seed, idx, e, d, f, dtype):
    """x, one row for each id, and stacked weights scaled so h and y are of
    order 1, all rounded to dtype."""
    rng = np.random.default_rng(seed)
    n = len(idx)
    raw = {"x": rng.standard_normal((n, d)),
           "w1": rng.standard_normal((e, d, f)) / np.sqrt(d),
           "b1": 0.5 * rng.standard_normal((e, f)),
           "w2": rng.standard_normal((e, f, d)) / np.sqrt(f),
           "b2": 0.5 * rng.standard_normal((e, d))}
    inp = {k: _round(v, dtype) for k, v in raw.items()}
    inp["idx"] = np.asarray(idx, np.int32)
    return inp


def _top2(seed, tokens, e):
    rng = np.random.default_rng(seed)
    return [int(i) for _ in range(tokens) for i in rng.permutation(e)[:2]]


# name: (ids, e, d, f, dtype, activation, the kernel the plan must pick)
CASES = {
    "one-expert-n2": ([3, 3], 8, 64, 256, "bfloat16", "gelu", port.MMA),
    "one-expert-slab": ([5] * 6, 8, 64, 256, "bfloat16", "relu", port.SLAB),
    "all-distinct-slab": (list(range(6)), 6, 64, 256, "bfloat16", "silu", port.SLAB),
    "all-distinct-n2": ([4, 1], 6, 64, 256, "bfloat16", "gelu", port.MMA),
    "top2-n64": (_top2(7, 32, 8), 8, 64, 128, "bfloat16", "gelu", port.SLAB),
    "ids-out-of-range": ([-3, 9], 6, 64, 256, "float16", "gelu", port.MMA),
    "ragged-d77-f201": ([0, 4, 2], 5, 77, 201, "float16", "relu", port.SLAB),
    "ragged-d96-f200": ([2], 3, 96, 200, "bfloat16", "relu", port.MMA),
    # the widest d whose tensor-core shared memory fits a block, and the
    # next multiple of 8, which the slab kernel takes
    "wide-d2848": ([1], 2, 2848, 64, "bfloat16", "gelu", port.MMA),
    "wide-d2856": ([0], 2, 2856, 64, "bfloat16", "gelu", port.SLAB),
    "fp32-top2": (_top2(3, 2, 8), 8, 64, 512, "float32", "silu", port.SLAB),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_walk_matches_jax_and_plain(name):
    """The emulated walk against JAX's moe_decode_ffn (its Pallas kernel in
    interpret mode) and the port's plain version on the CPU, at
    ``MOE_TOLERANCES`` for the dtype; and the plan picks the kernel the case
    is for."""
    ids, e, d, f, dtype, act, want_mode = CASES[name]
    inp = _inputs(sum(map(ord, name)), ids, e, d, f, dtype)
    got, mode = walk(inp, act, dtype)
    assert mode == want_mode, (name, mode)
    clamped = np.clip(inp["idx"], 0, e - 1).astype(np.int32)
    jargs = [jnp.asarray(inp[k]).astype(getattr(jnp, dtype)) if k != "idx" else
             jnp.asarray(clamped) for k in ("x", "idx", "w1", "b1", "w2", "b2")]
    jax_act = jax_lm._act(jax_lm.CausalLMConfig(activation=act))
    ref_jax = np.asarray(jax_ops_moe.moe_decode_ffn(*jargs, jax_act), np.float32)
    targs = [torch.from_numpy(inp[k]).to(TORCH_DTYPES[dtype]) if k != "idx" else
             torch.from_numpy(clamped) for k in ("x", "idx", "w1", "b1", "w2", "b2")]
    ref_plain = port.moe_decode_ffn_plain(*targs, act).numpy()
    atol, rtol = kernel_checks.MOE_TOLERANCES[TORCH_DTYPES[dtype]]
    for ref in (ref_jax, ref_plain):
        ratio = kernel_checks.err_ratio(torch.from_numpy(got), torch.from_numpy(np.array(ref)),
                                        atol, rtol)
        assert ratio <= 1.0, (name, ratio)


def test_mma_smem_bytes_counts_the_kernels_layout():
    """The tensor-core kernel's shared memory as ``mma_layout`` lays it out,
    counted by hand at GPT-2 MoE's d 768 (f-blocks of 16 and 8) and GPT-2
    6.7B's d 4096, and the plan's limit: d 2848 fits 227 KB, d 2856 not."""
    # w2 12 boxes x 16 rows x 128 B, w1 12 x 64 rows x 16 x 2 B, x 8 x 776 x
    # 2 B, the warps' sums 8 x 16 x 4 B, h 8 x 24 x 2 B, b1 16 x 4 B, 13
    # barriers, 1024 to align
    assert port.mma_smem_bytes(768, 16) == 24576 + 24576 + 12416 + 512 + 384 + 64 + 104 + 1024
    # bf 8: w2's boxes still 16 rows, w1's 8 columns
    assert port.mma_smem_bytes(768, 8) == 24576 + 12288 + 12416 + 256 + 384 + 32 + 104 + 1024
    assert port.mma_smem_bytes(4096, 16) == 131072 + 131072 + 65664 + 512 + 384 + 64 + 520 + \
        1024
    assert port.mma_smem_bytes(2848, 16) <= port.SMEM_MAX < port.mma_smem_bytes(2856, 16)
    assert port.moe_plan(1, 4096, 16384, 2) == (128, port.SLAB)
