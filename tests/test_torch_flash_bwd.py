"""The port's flash-attention backward against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through ``jax.vjp`` of the JAX
``flash_attention`` (its Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU) and through the port's
``flash_bwd_plain``, the plain version of the two backward kernels. The
backward is fed the JAX forward's output ``o`` and the port's f32 ``lse``:
the two forwards round ``o`` to bf16 at different points, and delta =
rowsum(do * o) would carry that difference into every ds. The kernels
themselves are held to ``flash_bwd_plain`` on the card by
``tests/test_torch_kernels_cuda.py``.

Tolerances, elementwise on dq, dk, dv: |port - jax| <= atol + rtol * |jax|.
f32 (2e-6, 2e-5): sums over up to t = 200 terms in another order. bf16
(2e-3, 1.6e-2): two bf16 ulps of the value; both sides round ds and p to
bf16, and a different f32 sum can flip a rounding. The gradients here are
mostly 0.03-0.12 in size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention.flash import flash_attention as jax_flash_attention
from deepspeed_tpu_torch.models.causal_lm import alibi_slopes
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention.flash import (flash_attention, flash_bwd,
                                                     flash_bwd_plain, flash_fwd,
                                                     flash_fwd_plain)

TOL = {"float32": (2e-6, 2e-5), "bfloat16": (2e-3, 1.6e-2)}       # (atol, rtol)
B, H = 1, 2


def _inputs(seed, t, d, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B, t, H, d)).astype(np.float32) for _ in range(4)]
    if dtype == "bfloat16":        # values both sides hold exactly
        xs = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]
    return xs


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _from3(x: torch.Tensor, t: int) -> np.ndarray:
    return x.reshape(B, H, t, -1).transpose(1, 2).float().numpy()


# every pair of values of (t, d, causal, alibi, dtype) meets in some case (a
# covering array): the full product would spend ~1.5 s of interpret-mode
# compile on each of 32
CASES = [(128, 64, True, False, "float32"), (128, 64, True, False, "bfloat16"),
         (128, 128, False, True, "float32"), (200, 64, False, True, "float32"),
         (200, 128, True, True, "bfloat16"), (200, 128, False, False, "bfloat16"),
         # shorter than one of the card kernels' 64-row tiles, and one tile and two rows
         (40, 64, True, False, "bfloat16"), (130, 128, True, True, "bfloat16")]


@pytest.mark.parametrize("t,d,causal,alibi,dtype", CASES)
def test_flash_bwd_plain_matches_jax_vjp(t, d, causal, alibi, dtype):
    q, k, v, do = _inputs(t + d, t, d, dtype)
    slopes = alibi_slopes(H) if alibi else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal,
                                   alibi_slopes=None if slopes is None else jnp.asarray(slopes))

    @jax.jit
    def forward_and_grads(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(do)

    o, ref = forward_and_grads(*(jnp.asarray(x, jdt) for x in (q, k, v, do)))

    q3, k3, v3, do3 = (_to3(torch.from_numpy(x).to(tdt)) for x in (q, k, v, do))
    ts = None if slopes is None else torch.from_numpy(slopes)
    scale = 1.0 / float(np.sqrt(d))
    _, lse = flash_fwd_plain(q3, k3, v3, ts, scale, causal, H)
    o3 = _to3(torch.from_numpy(np.array(o, np.float32)).to(tdt))
    grads = flash_bwd_plain(q3, k3, v3, o3, lse, do3, ts, scale, causal, H)
    atol, rtol = TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == tdt
        np.testing.assert_allclose(_from3(g, t), np.asarray(r, np.float32), atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_on_cpu(causal, alibi):
    """flash_attention's autograd Function on CPU tensors: its gradients are
    flash_bwd_plain's, and equal autograd through flash_fwd_plain (f32, 2e-6:
    the same function differentiated two ways)."""
    t, d = 100, 64
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, t, d, "float32"))
    slopes = torch.from_numpy(alibi_slopes(H)) if alibi else None
    scale = 1.0 / float(np.sqrt(d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, alibi_slopes=slopes)
    got = torch.autograd.grad(out, leaves, do)

    q3, k3, v3, do3 = (_to3(x) for x in (q, k, v, do))
    o3, lse = flash_fwd_plain(q3, k3, v3, slopes, scale, causal, H)
    np.testing.assert_array_equal(_from3(o3, t), out.detach().numpy())
    want = flash_bwd_plain(q3, k3, v3, o3, lse, do3, slopes, scale, causal, H)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _from3(w, t), atol=1e-6, rtol=0)

    leaves3 = [x.clone().requires_grad_() for x in (q3, k3, v3)]
    o3_ad, _ = flash_fwd_plain(*leaves3, slopes, scale, causal, H)
    autograd = torch.autograd.grad(o3_ad, leaves3, do3)
    for g, w in zip(got, autograd):
        np.testing.assert_allclose(g.numpy(), _from3(w, t), atol=2e-6, rtol=0)


def test_flash_bwd_wrapper_is_plain_on_cpu_and_counts_nothing():
    t, d = 64, 64
    q3, k3, v3, do3 = (_to3(torch.from_numpy(x)) for x in _inputs(5, t, d, "float32"))
    op_builder.reset_launch_counts()
    o3, lse = flash_fwd(q3, k3, v3, None, None, True, H)
    got = flash_bwd(q3, k3, v3, o3, lse, do3, None, None, True, H)
    want = flash_bwd_plain(q3, k3, v3, o3, lse, do3, None, 1.0 / 8.0, True, H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    leaves = [x.clone().requires_grad_() for x in (q3, k3, v3)]
    flash_attention(*(x.reshape(B, H, t, d).transpose(1, 2) for x in leaves)).sum().backward()
    assert set(op_builder.launch_counts()) >= {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert all(n == 0 for n in op_builder.launch_counts().values())


def test_flash_bwd_refuses_bad_inputs():
    q = torch.zeros(2, 64, 64)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="o must be"):
        flash_bwd(q, q, q, q[:, :32], lse, q)
    with pytest.raises(TypeError, match="float32"):
        flash_bwd(q, q, q, q, lse.double(), q)
    meta = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_bwd(meta, meta, meta, meta, torch.empty(2, 64, device="meta"), meta)
