"""The port's paged attention against the JAX package's, on the CPU.

The same pages, tables and lengths, made with numpy from a seed, go through
JAX's ``paged_attention_xla`` (the dense-gather ground truth) and its Pallas
kernel ``paged_attention_fused`` in interpret mode, and through the port's
``paged_attention`` on CPU tensors, which takes the kernel's plain version.
f32, tolerance 2e-5 (the JAX tests' own for kernel against ground truth).
The page movers ``gather_kv_dense`` and ``paged_cache_update`` must agree
exactly. The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.paged_attention import gather_kv_dense as jax_gather_kv_dense
from deepspeed_tpu.ops.paged_attention import paged_attention_fused, paged_attention_xla
from deepspeed_tpu.ops.paged_attention import paged_cache_update as jax_paged_cache_update
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.paged_attention import (gather_kv_dense, paged_attention,
                                                     paged_attention_plain, paged_cache_update)

TOL = 2e-5


def _paged_inputs(seed, b, h, hk, d, page, cap, lens, shuffle=True):
    """Pages ``(P, hk, page, d)`` with each slot's live pages at (optionally
    shuffled) physical indices, 1e4 in the null page 0 and in the rows past
    each slot's length, and the ``(b, max_pages)`` table padded with 0."""
    rng = np.random.default_rng(seed)
    mp = -(-cap // page)
    n_pages = b * mp + 1
    order = rng.permutation(np.arange(1, n_pages)) if shuffle else np.arange(1, n_pages)
    k = rng.standard_normal((n_pages, hk, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, hk, page, d)).astype(np.float32)
    table = np.zeros((b, mp), np.int32)
    for i, n in enumerate(lens):
        live = -(-n // page)
        table[i, :live] = order[i * mp:i * mp + live]
        if n % page:
            k[table[i, live - 1], :, n % page:] = 1e4
            v[table[i, live - 1], :, n % page:] = 1e4
    k[0] = 1e4
    v[0] = 1e4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lens, np.int32)


CASES = {
    # name: (b, h, hk, d, page, cap, lens, shuffled physical pages)
    "ragged": (3, 4, 4, 16, 8, 24, (24, 13, 1), True),
    "gqa": (3, 8, 2, 16, 8, 24, (20, 9, 17), True),
    "cap-not-page-multiple": (2, 4, 2, 32, 8, 20, (20, 11), True),
    "contiguous-pages": (2, 4, 4, 16, 4, 16, (16, 5), False),
    "page-1": (2, 2, 2, 16, 1, 9, (9, 3), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_attention_matches_jax(name):
    b, h, hk, d, page, cap, lens, shuffle = CASES[name]
    q, k, v, table, lens = _paged_inputs(len(name), b, h, hk, d, page, cap, lens, shuffle)
    op_builder.reset_launch_counts()
    out = paged_attention(*map(torch.from_numpy, (q, k, v, table, lens)), cap).numpy()
    assert op_builder.launch_counts()["paged_decode_attention"] == 0   # CPU: plain version
    jq, jk, jv, jt, jl = map(jnp.asarray, (q, k, v, table, lens))
    np.testing.assert_allclose(out, np.asarray(paged_attention_xla(jq, jk, jv, jt, jl, cap)),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, np.asarray(paged_attention_fused(jq, jk, jv, jt, jl)),
                               atol=TOL, rtol=TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_kv_dense_equals_jax(name):
    b, h, hk, d, page, cap, lens, shuffle = CASES[name]
    _, k, v, table, _ = _paged_inputs(7, b, h, hk, d, page, cap, lens, shuffle)
    got = gather_kv_dense(*map(torch.from_numpy, (k, v, table)), cap)
    want = jax_gather_kv_dense(*map(jnp.asarray, (k, v, table)), cap)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (b, hk, cap, d)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paged_cache_update_equals_jax():
    """One appended row per slot, at page-mapped positions that include a
    page's first and last row; the port writes in place."""
    b, hk, d, page, cap = 3, 2, 16, 8, 24
    _, k, v, table, _ = _paged_inputs(3, b, 4, hk, d, page, cap, (24, 17, 9))
    rng = np.random.default_rng(4)
    k_new = rng.standard_normal((b, hk, 1, d)).astype(np.float32)
    v_new = rng.standard_normal((b, hk, 1, d)).astype(np.float32)
    cache_len = np.array([23, 16, 8], np.int32)
    jk, jv = jax_paged_cache_update(*map(jnp.asarray, (k, v, k_new, v_new, table, cache_len)))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    paged_cache_update(tk, tv, *map(torch.from_numpy, (k_new, v_new, table, cache_len)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_cache_update_past_the_table_writes_only_the_null_page():
    """A row past the table (a dead slot's stale length) is routed to the
    null page, never to another slot's page or out of bounds."""
    b, hk, d, page, cap = 2, 2, 16, 8, 16
    _, k, v, table, _ = _paged_inputs(5, b, 2, hk, d, page, cap, (16, 16))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    new = torch.ones(b, hk, 1, d)
    paged_cache_update(tk, tv, new, new, torch.from_numpy(table),
                       torch.tensor([16, 1000], dtype=torch.int32))
    np.testing.assert_array_equal(tk.numpy()[1:], k[1:])
    assert (tk.numpy()[0] == 1).any()


def test_plain_version_is_the_dense_decode_math():
    """paged_attention_plain == the dense decode plain version on the gathered
    view, bit for bit (the property JAX's serving parity leans on)."""
    from deepspeed_tpu_torch.ops.attention.decode import decode_attention_plain
    q, k, v, table, lens = map(torch.from_numpy, _paged_inputs(9, 3, 8, 2, 16, 8, 24,
                                                               (24, 13, 1)))
    kd, vd = gather_kv_dense(k, v, table, 24)
    torch.testing.assert_close(paged_attention_plain(q, k, v, table, lens, 24, 0.25),
                               decode_attention_plain(q, kd, vd, lens, 0.25), atol=0, rtol=0)


def test_other_devices_raise():
    q = torch.empty(2, 4, 64, device="meta")
    pages = torch.empty(3, 4, 16, 64, device="meta")
    table = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(q, pages, pages, table, lens, 32)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention(q, pages, pages, table[:1], lens, 32)
