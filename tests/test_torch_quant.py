"""The port's weight quantizer and dequant-GEMM against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages. Payloads must be
byte-identical and scales bitwise equal (the same f32 operations, round half
to even on both sides), and each side must decode the other's packed int4.
``quantized_matmul`` runs its plain version here (CPU tensors); it is held to
JAX's interpret-mode ``_qmm_kernel`` and ``quantized_matmul_xla`` in f32 at
the JAX tests' shapes (atol 1e-4, rtol 1e-5, the JAX tests' own limits: sums
of up to 512 f32 terms in other orders), and in bf16, where both round each
weight to bf16 and differ only in the f32 sum's order, within the kernel
check's bf16 limit (one ulp of the value, plus 1e-3).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import fused_matmul as jfm
from deepspeed_tpu.ops.quantizer import quant as jq
from deepspeed_tpu_torch.ops.kernel_checks import QMM_TOLERANCES, err_ratio
from deepspeed_tpu_torch.ops.quantizer import fused_matmul as tfm
from deepspeed_tpu_torch.ops.quantizer import quant as tq
from deepspeed_tpu_torch.utils.logging import logger as torch_logger


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# (bits, requested group, weight shape): lead dims, a degraded group (k 200
# -> 8), int4 groups of 16 and 32
QUANT_CASES = [(8, 128, (256, 64)), (8, 64, (3, 128, 40)), (8, 128, (200, 16)),
               (4, 32, (128, 48)), (4, 16, (2, 64, 24)), (4, 128, (200, 8))]


@pytest.mark.parametrize("bits,group,shape", QUANT_CASES)
def test_quantize_pack_and_dequantize_match_jax(bits, group, shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    qj, sj = jq.quantize_grouped(w, group, bits=bits)
    qt, st = tq.quantize_grouped(torch.from_numpy(w), group, bits=bits)
    assert _bits_equal(qj, qt.numpy()) and _bits_equal(sj, st.numpy())
    assert _bits_equal(jq.dequantize_grouped(qj, sj), tq.dequantize_grouped(qt, st).numpy())
    if bits == 4:
        groups = st.shape[-2]
        pj, pt = jq.pack_int4(qj, groups), tq.pack_int4(qt, groups)
        assert _bits_equal(pj, pt.numpy())
        # each side decodes the other's payload
        assert _bits_equal(tq.unpack_int4(_t(pj), groups).numpy(), qj)
        assert _bits_equal(jq.unpack_int4(jnp.asarray(pt.numpy()), groups), qt.numpy())
        nj, nt = jq.make_quant_node(pj, sj, 4), tq.make_quant_node(pt, st, 4)
    else:
        nj, nt = jq.make_quant_node(qj, sj, 8), tq.make_quant_node(qt, st, 8)
    assert tq.node_logical_shape(nt) == tuple(jq.node_logical_shape(nj)) == shape
    assert _bits_equal(jq.dequantize_node(nj), tq.dequantize_node(nt).numpy())


def test_int4_roundtrip_and_every_nibble():
    """Every int4 value in both nibble positions survives pack/unpack, and the
    packed bytes equal JAX's."""
    vals = np.arange(-7, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals, indexing="ij")).reshape(2, -1)   # rows j, j + g/2
    qt = torch.from_numpy(q.copy())
    packed = tq.pack_int4(qt, 1)
    assert _bits_equal(packed.numpy(), jq.pack_int4(jnp.asarray(q), 1))
    assert torch.equal(tq.unpack_int4(packed, 1), qt)


def test_pack_int4_rejects_odd_group():
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(6, 4, dtype=torch.int8), 2)
    with pytest.raises(ValueError, match="even"):
        jq.pack_int4(jnp.zeros((6, 4), jnp.int8), 2)


def test_group_size_degradation_warns(caplog):
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(13, 8)).astype(np.float32))
    torch_logger.propagate = True            # the package logger does not propagate
    try:
        with caplog.at_level(logging.WARNING):
            _, s = tq.quantize_grouped(w, group_size=8, warn_for="test/w")
    finally:
        torch_logger.propagate = False
    assert s.shape[-2] == 13
    assert any("effective group degraded to 1" in r.message for r in caplog.records)
    _, info = tq.quantize_with_audit(w, bits=8, group_size=8, threshold=0.5, name="test/w")
    assert info["group_effective"] == 1 and info["group_requested"] == 8


def _spiked(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[0, :16] = 1e4                        # outliers wreck their groups' scale grids
    return w


@pytest.mark.parametrize("bits,group,w", [
    (8, 32, np.random.default_rng(2).standard_normal((128, 24)).astype(np.float32)),
    (4, 16, np.random.default_rng(3).standard_normal((64, 24)).astype(np.float32)),
    (8, 32, _spiked((128, 24), 4)),
    (4, 8, np.random.default_rng(5).standard_normal((13, 8)).astype(np.float32)),   # odd g
], ids=["int8", "int4", "int8-outlier", "int4-odd-group"])
def test_quantize_with_audit_matches_jax(bits, group, w):
    node_j, info_j = jq.quantize_with_audit(w, bits=bits, group_size=group, threshold=0.05,
                                            name="layers_0/fc_in/kernel")
    node_t, info_t = tq.quantize_with_audit(torch.from_numpy(w), bits=bits, group_size=group,
                                            threshold=0.05, name="layers_0/fc_in/kernel")
    rel_j, rel_t = info_j.pop("rel_err"), info_t.pop("rel_err")
    # the norms' f32 sums run in other orders: the decision's reason string
    # prints rel_err to 4 places, the value itself agrees to 1e-6
    reason_j, reason_t = info_j.pop("reason"), info_t.pop("reason")
    assert info_t == info_j
    assert (rel_j is None) == (rel_t is None)
    if rel_j is not None:
        assert abs(rel_j - rel_t) <= 1e-6 * max(1.0, abs(rel_j))
    assert reason_t.split(" ")[0] == reason_j.split(" ")[0]
    assert (node_j is None) == (node_t is None)
    if node_j is not None:
        assert set(node_t) == set(node_j)
        for key in node_j:
            assert _bits_equal(node_j[key], node_t[key].numpy()), key
    if bits == 4 and group == 8:
        assert info_t["decision"] == "excluded" and "odd" in reason_t


def test_validate_quant_config():
    class Cfg:
        enabled, bits = True, 4
    with pytest.raises(NotImplementedError, match="8-bit grouped only"):
        tq.validate_quant_config(Cfg())
    Cfg.bits = 8
    tq.validate_quant_config(Cfg())


def _operands(bits, group, m, k, n, seed=2):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qj, sj = jq.quantize_grouped(w, group, bits=bits)
    pj = jq.pack_int4(qj, sj.shape[-2]) if bits == 4 else qj
    return x, pj, sj


# the shapes of tests/unit/ops/test_weight_quant.py's kernel parity test
@pytest.mark.parametrize("bits,group,shape", [
    (8, 128, (4, 256, 128)), (8, 64, (300, 256, 256)), (4, 64, (4, 256, 128)),
    (4, 128, (64, 512, 256))])
def test_quantized_matmul_plain_matches_jax_f32(bits, group, shape):
    x, pj, sj = _operands(bits, group, *shape)
    y_kernel = np.asarray(jfm.quantized_matmul(jnp.asarray(x), pj, sj, bits=bits,
                                               interpret=True))
    y_xla = np.asarray(jfm.quantized_matmul_xla(jnp.asarray(x), pj, sj, bits=bits))
    y = tfm.quantized_matmul(torch.from_numpy(x), _t(pj),
                             _t(sj), bits=bits)
    assert y.dtype == torch.float32 and tuple(y.shape) == (shape[0], shape[2])
    np.testing.assert_allclose(y.numpy(), y_kernel, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(y.numpy(), y_xla, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_plain_matches_jax_kernel_bf16(bits):
    """bf16: both round each dequantized weight to bf16 before an f32 product
    (``fused_matmul.py:87``), then round the f32 result to bf16."""
    m, k, n = 5, 256, 96
    x, pj, sj = _operands(bits, 64, m, k, n, seed=7)
    sj = sj / np.float32(np.sqrt(k))          # outputs of order 1, as the kernel checks
    xb = jnp.asarray(x, jnp.bfloat16)
    y_ref = jfm.quantized_matmul(xb, pj, sj, bits=bits, interpret=True)
    y = tfm.quantized_matmul(_t(xb.astype(jnp.float32)).bfloat16(),
                             _t(pj), _t(sj),
                             bits=bits)
    assert y.dtype == torch.bfloat16
    ref = _t(y_ref.astype(jnp.float32))
    assert err_ratio(y, ref, *QMM_TOLERANCES[torch.bfloat16]) <= 1.0


@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
def test_quant_dense_apply_matches_jax(with_bias, monkeypatch):
    """(b, t, k) and (m, k) activations, f32, against JAX's ``quant_dense_apply``
    through its fused (interpret-mode) kernel, and against x @ dequant + b."""
    monkeypatch.setenv("DS_TPU_WQ_FORCE_FUSED", "1")
    rng = np.random.default_rng(3)
    k, n = 128, 64
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    for bits in (8, 4):
        node_j, _ = jq.quantize_with_audit(w, bits=bits, group_size=64, threshold=1.0, name="w")
        node_t = {key: _t(v) for key, v in node_j.items()}
        b_t = None if bias is None else torch.from_numpy(bias)
        y_j = np.asarray(jfm.quant_dense_apply(jnp.asarray(x), node_j,
                                               None if bias is None else jnp.asarray(bias),
                                               jnp.float32))
        y_t = tfm.quant_dense_apply(torch.from_numpy(x), node_t, b_t, torch.float32)
        np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-4, rtol=1e-5)
        ref = x @ np.asarray(jq.dequantize_node(node_j)) + (0 if bias is None else bias)
        np.testing.assert_allclose(y_t.numpy(), ref, atol=1e-4, rtol=1e-5)
        y2 = tfm.quant_dense_apply(torch.from_numpy(x[0]), node_t, b_t, torch.float32)
        np.testing.assert_allclose(y2.numpy(), y_t[0].numpy(), atol=1e-6, rtol=0)


def test_quantized_matmul_refuses_bad_operands():
    x = torch.zeros(3, 64)
    q8 = torch.zeros(64, 16, dtype=torch.int8)
    s = torch.ones(2, 16)
    with pytest.raises(ValueError, match="payload"):
        tfm.quantized_matmul(x, q8, s, bits=4)                     # int8-sized payload
    with pytest.raises(ValueError, match="even group"):
        tfm.quantized_matmul(torch.zeros(3, 6), torch.zeros(3, 16, dtype=torch.int8),
                             torch.ones(2, 16), bits=4)            # group 3
    with pytest.raises(ValueError, match="do not divide"):
        tfm.quantized_matmul(x, q8, torch.ones(3, 16))
    with pytest.raises(TypeError, match="int8 payload"):
        tfm.quantized_matmul(x, q8.float(), s)
    with pytest.raises(ValueError, match="bits"):
        tfm.quantized_matmul(x, q8, s, bits=2)


# (m, k, n, group, bits, dtype): the main paths' decode and prefill shapes,
# GPT-2's fc_out at 16 slots, int4 groups of 16 and 8 (a group is g/2 byte
# rows), int8 group 1, a ragged k, and the f32 path's skinny and tiled regimes
PLAN_CASES = [(1, 4096, 16384, 128, 8, torch.bfloat16), (1, 16384, 4096, 128, 4, torch.bfloat16),
              (16, 768, 3072, 128, 8, torch.bfloat16), (16, 3072, 768, 128, 8, torch.bfloat16),
              (512, 4096, 16384, 128, 4, torch.bfloat16), (3, 512, 72, 32, 4, torch.float16),
              (2, 200, 96, 8, 4, torch.bfloat16), (4, 8192, 256, 1, 8, torch.bfloat16),
              (37, 1000, 96, 200, 8, torch.float16), (1, 4096, 64, 256, 4, torch.bfloat16),
              (4, 13, 70, 13, 8, torch.float32), (300, 256, 200, 64, 8, torch.float32)]


@pytest.mark.parametrize("m,k,n,group,bits,dtype", PLAN_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_qmm_plan_covers_the_payload(m, k, n, group, bits, dtype):
    """The kernel's split-k plan: the splits cover every payload row once;
    bf16/fp16 splits walk whole stages, and whole groups where a group spans
    stages (int4: g/2 byte rows, each holding the rows j and j + g/2 of its
    group, so a split holds both halves of each of its groups' rows); the f32
    partials (written and read back) stay within the payload's bytes; the
    tile is the smallest of ``QMM_TILES`` that holds m. f32: the first
    version's skinny chunks of 8 rows at m <= ``SKINNY_M``, one tiled pass
    above."""
    plan = tfm.qmm_plan(m, k, n, group, bits, dtype)
    rows = k if bits == 8 else k // 2
    chunk = plan.chunk or rows
    assert plan.splits == -(-rows // chunk)
    spans = [(i * chunk, min((i + 1) * chunk, rows)) for i in range(plan.splits)]
    covered = np.zeros(rows, np.int64)
    for a, b in spans:
        assert a < b
        covered[a:b] += 1
    assert (covered == 1).all()
    assert plan.splits == 1 or 8 * plan.splits * m * n <= rows * n
    if dtype == torch.float32:
        assert plan.tile_m == 0
        if m > tfm.SKINNY_M:
            assert (plan.chunk, plan.splits) == (0, 1)
        else:
            assert plan.chunk % 8 == 0 and plan.chunk > 0
        return
    assert plan.tile_m == next(t for t in tfm.QMM_TILES if m <= t or t == tfm.QMM_WIDE)
    stage = tfm.QMM_STAGE_ROWS[bits]
    group_rows = group if bits == 8 else group // 2
    if plan.splits > 1:
        assert plan.chunk % stage == 0
        if group_rows % stage == 0:
            assert plan.chunk % group_rows == 0
    # the logical rows of each split: int4 byte row j of group G holds rows
    # G g + j and G g + j + g/2; a split holds a row iff it holds its partner
    for a, b in spans:
        byte_rows = np.arange(a, b)
        if bits == 8:
            continue
        G, j = byte_rows // group_rows, byte_rows % group_rows
        lo = set((G * group + j).tolist())
        hi = set((G * group + j + group_rows).tolist())
        assert {r + group_rows for r in lo} == hi


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=lambda d: str(d).replace("torch.", ""))
def test_quantized_matmul_plain_bias_is_cast_then_added(bits, dtype):
    """The bias keyword: ``(x @ w).to(dtype) + bias.to(dtype)`` bit for bit,
    with an f32 bias (the model's) cast to the output dtype, as the kernel's
    epilogue computes it."""
    m, k, n = 6, 256, 40
    x, pj, sj = _operands(bits, 64, m, k, n, seed=11)
    bias = torch.from_numpy(np.random.default_rng(12).standard_normal(n).astype(np.float32))
    xt = torch.from_numpy(x).to(dtype)
    y = tfm.quantized_matmul(xt, _t(pj), _t(sj), bits=bits, _bias=bias)
    want = tfm.quantized_matmul(xt, _t(pj), _t(sj), bits=bits) + bias.to(dtype)
    assert y.dtype == dtype and torch.equal(y, want)
    y32 = tfm.quantized_matmul_plain(xt, _t(pj), _t(sj), bits=bits, out_dtype=torch.float32,
                                     _bias=bias)
    assert torch.equal(y32, tfm.quantized_matmul_plain(xt, _t(pj), _t(sj), bits=bits,
                                                       out_dtype=torch.float32) + bias)
    with pytest.raises(ValueError, match="bias"):
        tfm.quantized_matmul(xt, _t(pj), _t(sj), bits=bits, _bias=bias[:-1])
