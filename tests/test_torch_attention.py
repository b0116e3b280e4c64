"""The port's attention ops against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX functions (the
Pallas kernels in interpret mode, and their XLA references) and through the
port's functions on CPU tensors, which take the kernels' plain versions. fp32
throughout, atol 1e-5. The kernels themselves are held to the plain versions on
the card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.causal_lm import _alibi_attention_xla
from deepspeed_tpu.ops.attention.decode import decode_attention as jax_decode_attention
from deepspeed_tpu.ops.attention.decode import decode_attention_xla
from deepspeed_tpu.ops.attention.flash import _flash_fwd, _slopes3
from deepspeed_tpu.ops.attention.flash import flash_attention as jax_flash_attention
from deepspeed_tpu.ops.transformer.attention import xla_attention
from deepspeed_tpu_torch.models.causal_lm import alibi_slopes
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention.block_sparse import block_sparse_attention
from deepspeed_tpu_torch.ops.attention.decode import decode_attention
from deepspeed_tpu_torch.ops.attention.flash import flash_attention, flash_fwd
from deepspeed_tpu_torch.ops.moe import moe_decode_ffn
from deepspeed_tpu_torch.ops.paged_attention import paged_attention
from deepspeed_tpu_torch.ops.quantizer import quantize_grouped, quantized_matmul
from deepspeed_tpu_torch.ops.transformer.attention import reference_attention

ATOL = 1e-5


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [40, 64, 100, 128, 130])
def test_flash_plain_matches_jax(t, d, causal, alibi):
    b, h = 2, 2
    q, k, v = _qkv(t * d, b, t, h, d)
    slopes = alibi_slopes(h) if alibi else None
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = jax_flash_attention(jq, jk, jv, causal=causal,
                              alibi_slopes=None if slopes is None else jnp.asarray(slopes))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if not alibi:
        np.testing.assert_allclose(out.numpy(), np.asarray(xla_attention(jq, jk, jv, causal)),
                                   atol=ATOL, rtol=0)
    elif causal:
        np.testing.assert_allclose(
            out.numpy(), np.asarray(_alibi_attention_xla(jq, jk, jv, jnp.asarray(slopes))),
            atol=ATOL, rtol=0)


@pytest.mark.parametrize("alibi", [False, True])
def test_flash_lse_matches_jax(alibi):
    """The logsumexp the backward will reuse: port plain vs the JAX kernel's."""
    b, t, h, d = 2, 100, 2, 64
    q, k, v = _qkv(7, b, t, h, d)
    slopes = alibi_slopes(h) if alibi else None

    def to3(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)

    _, lse = flash_fwd(*(torch.from_numpy(np.ascontiguousarray(to3(x))) for x in (q, k, v)),
                       None if slopes is None else torch.from_numpy(slopes), None, True,
                       n_heads=h)
    _, ref = _flash_fwd(*(jnp.asarray(to3(x)) for x in (q, k, v)),
                        None if slopes is None else _slopes3(slopes, b, h),
                        1.0 / np.sqrt(d), True, 1024, 1024, t)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_xla(causal):
    """The port's plain attention, padding mask and cross-attention included."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [6]])).astype(np.int32)
    out = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              mask=torch.from_numpy(mask))
    ref = xla_attention(*map(jnp.asarray, (q, k, v)), causal=causal, mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hk", [(4, 4), (8, 2)])
def test_decode_plain_matches_jax(h, hk, d):
    """Ragged cache lengths; the stale rows past each length hold 1e4, so a
    leak past cache_len would show."""
    b, cap = 3, 96
    rng = np.random.default_rng(h * d + hk)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, hk, cap, d)).astype(np.float32)
    vc = rng.standard_normal((b, hk, cap, d)).astype(np.float32)
    lens = np.array([cap, 37, 1], np.int32)
    for i, n in enumerate(lens):
        kc[i, :, n:] = 1e4
        vc[i, :, n:] = 1e4
    out = decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)))
    args = tuple(map(jnp.asarray, (q, kc, vc, lens)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_decode_attention(*args)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(decode_attention_xla(*args)),
                               atol=ATOL, rtol=0)


def test_cpu_tensors_leave_launch_counts_at_zero():
    op_builder.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 64, 2, 64))
    flash_attention(q, k, v)
    decode_attention(q[:, 0], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                     torch.tensor([10], dtype=torch.int32))
    pages = k.reshape(4, 16, 2, 64).transpose(1, 2).contiguous()
    paged_attention(q[:, 0], pages, pages, torch.tensor([[1, 2]], dtype=torch.int32),
                    torch.tensor([20], dtype=torch.int32), 32)
    qw, scales = quantize_grouped(torch.randn(64, 32), 32)
    quantized_matmul(q[0, :3, 0], qw, scales)
    w1, w2 = torch.randn(3, 64, 32), torch.randn(3, 32, 64)
    moe_decode_ffn(q[0, :2, 0], torch.tensor([2, 0]), w1, torch.zeros(3, 32), w2,
                   torch.zeros(3, 64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(block_sparse_attention(*leaves, np.ones((2, 4, 4)), 16, causal=True)
                        .sum(), leaves)
    assert op_builder.launch_counts() == {"flash_fwd": 0, "decode_attention": 0,
                                          "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                          "paged_decode_attention": 0, "quantized_matmul": 0,
                                          "moe_decode_ffn": 0, "block_sparse_fwd": 0,
                                          "block_sparse_bwd_dq": 0, "block_sparse_bwd_dkv": 0}


def test_other_devices_raise():
    """No quiet fallback: a tensor on neither the CPU nor CUDA is refused."""
    q = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(torch.empty(1, 2, 64, device="meta"),
                         torch.empty(1, 2, 8, 64, device="meta"),
                         torch.empty(1, 2, 8, 64, device="meta"),
                         torch.empty(1, dtype=torch.int32, device="meta"))
