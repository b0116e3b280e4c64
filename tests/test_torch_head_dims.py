"""Head dims other than 64 and 128: the port against the JAX package, on the CPU.

The card's attention kernels run a head_dim d on the build of the narrowest
width (64, 128 or 256) that holds it, with the real d at run time
(``flash.kernel_width``): the serving kernels (flash forward, dense and paged
decode) up to 256, the training kernels (flash and block-sparse, forward and
backward) up to 128, d a multiple of 8. On the CPU every wrapper runs its
plain version, which takes any d; here those plain versions are held to the
JAX package's functions at GPT-2 2.7B's d 80, GPT-2 760M's d 96 and GPT-J's d
256 (training at 80 and 96), on the same numpy inputs: the JAX kernels in
interpret mode, as the JAX package's own tests run them on the CPU, and its
XLA references. Then two small whole models: a GPT-2 of d 80 served by
``generate`` and a GPT-2 of d 96 trained for three steps, each against the
JAX engine on the same weights.

Tolerances, elementwise |port - jax| <= atol + rtol |jax|:
- f32 (2e-5, 2e-5) for the forward, decode and paged: sums in another order
  (the JAX tests' own tolerance of kernel against ground truth); the
  backward (2e-6, 2e-5) as ``tests/test_torch_flash_bwd.py``.
- bf16 forward (1e-2, 1.6e-2), ``kernel_checks.FWD_TOLERANCES``: the JAX
  kernel rounds the unnormalised probabilities to bf16 before their product
  with v, the plain version the normalised ones. bf16 decode and paged (1e-5,
  8e-3), ``DECODE_TOLERANCES``: both sides compute in f32 and round once. bf16
  backward (2e-3, 1.6e-2), ``BWD_TOLERANCES``. bf16 block-sparse o (1e-5,
  8e-3) as ``tests/test_torch_block_sparse.py``: neither side rounds p, and
  each rounds o once; its gradients ``BWD_TOLERANCES``: at d 96 a few dk
  elements are sums of terms of order 1 that cancel to ~1e-3, where the f32
  noise of two summation orders (~3e-5) is several bf16 ulps of the result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.attention import block_sparse as jbs
from deepspeed_tpu.ops.attention.decode import decode_attention as jax_decode_attention
from deepspeed_tpu.ops.attention.decode import decode_attention_xla
from deepspeed_tpu.ops.attention.flash import flash_attention as jax_flash_attention
from deepspeed_tpu.ops.paged_attention import paged_attention_fused, paged_attention_xla
from deepspeed_tpu.ops.transformer.attention import xla_attention
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax, gpt2_params_from_jax
from deepspeed_tpu_torch.ops import kernel_checks, op_builder
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.attention.decode import decode_attention
from deepspeed_tpu_torch.ops.attention.flash import (KERNEL_WIDTHS, SERVE_MAX_HEAD_DIM,
                                                     TRAIN_MAX_HEAD_DIM, flash_attention,
                                                     flash_bwd_plain, flash_fwd_plain,
                                                     kernel_width)
from deepspeed_tpu_torch.ops.paged_attention import paged_attention
from test_torch_paged_attention import _paged_inputs

FWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": kernel_checks.FWD_TOLERANCES[torch.bfloat16]}
DECODE_TOL = {"float32": (2e-5, 2e-5),
              "bfloat16": kernel_checks.DECODE_TOLERANCES[torch.bfloat16]}
BWD_TOL = {"float32": (2e-6, 2e-5), "bfloat16": kernel_checks.BWD_TOLERANCES[torch.bfloat16]}
SPARSE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 8e-3)}
SERVE_DIMS, TRAIN_DIMS, DTYPES = (80, 96, 256), (80, 96), ("float32", "bfloat16")


def _normal(seed, *shapes, dtype="float32"):
    """Seeded standard normals in f32; for bf16, values bf16 holds exactly,
    so both packages start from the same inputs."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        xs = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]
    return xs


def _close(got, want, tol, name=""):
    atol, rtol = tol
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=name)


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("training", [False, True])
def test_kernel_width_rule(training):
    """Every d from 1 to 264: the narrowest of 64, 128, 256 that holds it
    where d is a multiple of 8 and at most the mode's limit (128 training,
    256 serving); else ValueError naming the head_dim and the limit."""
    limit = TRAIN_MAX_HEAD_DIM if training else SERVE_MAX_HEAD_DIM
    assert (TRAIN_MAX_HEAD_DIM, SERVE_MAX_HEAD_DIM) == (128, 256)
    for d in range(1, 265):
        if d % 8 == 0 and d <= limit:
            width = kernel_width(d, training)
            assert width in KERNEL_WIDTHS and width >= d
            assert width == 64 if d <= 64 else width == 128 if d <= 128 else width == 256
        else:
            with pytest.raises(ValueError, match=f"head_dim {d} .* up to {limit}"):
                kernel_width(d, training)



@pytest.mark.parametrize("n_embd,n_head,impl,refused", [
    (4096, 16, "auto", "head_dim 256 .* up to 128"),
    (336, 4, "auto", "head_dim 84 .* up to 128"),
    (1536, 16, "auto", None),
    (4096, 16, "xla", None)])
def test_gpt2_init_refuses_what_the_training_kernels_do_not_take(n_embd, n_head, impl,
                                                                 refused):
    """GPT-2's ``init_params`` on a CUDA device applies the training rule
    before anything reaches the card, so ``initialize`` refuses the model at
    config time; the XLA attention sends nothing to the kernels. Without a
    card, what it takes gets as far as the ``torch.Generator`` on CUDA."""
    cfg = torch_gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=n_embd, n_layer=1,
                                n_head=n_head, attention_impl=impl)
    model = torch_gpt2.gpt2_model(cfg)
    if refused:
        with pytest.raises(ValueError, match=refused):
            model.init(0, "cuda")
    elif not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            model.init(0, "cuda")
    assert model.init(0, "cpu")["wte"].shape == (64, n_embd)


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", SERVE_DIMS)
def test_flash_forward_matches_jax(d, dtype):
    """K1's plain version against JAX's flash kernel (interpret mode), causal,
    t 100 (a ragged tile), and, in f32, against ``xla_attention``."""
    b, t, h = 1, 100, 2
    q, k, v = _normal(d, *[(b, t, h, d)] * 3, dtype=dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True)
    assert out.dtype == tdt and out.shape == (b, t, h, d)
    ref = jax_flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=True)
    _close(out.float().numpy(), ref.astype(jnp.float32), FWD_TOL[dtype])
    if dtype == "float32":
        _close(out.numpy(), xla_attention(*map(jnp.asarray, (q, k, v)), True), FWD_TOL[dtype])


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", TRAIN_DIMS)
def test_flash_backward_matches_jax_vjp(d, dtype):
    """K3's and K4's plain versions (``flash_bwd_plain``, fed JAX's o) against
    ``jax.vjp`` of JAX's flash attention (its kernels in interpret mode), and
    in f32 the port's autograd Function against the same."""
    b, t, h = 1, 130, 2
    q, k, v, do = _normal(d + 1, *[(b, t, h, d)] * 4, dtype=dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o, vjp = jax.vjp(lambda a, b_, c: jax_flash_attention(a, b_, c, causal=True),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do, jdt))
    q3, k3, v3, do3 = (_to3(torch.from_numpy(x).to(tdt)) for x in (q, k, v, do))
    scale = 1.0 / float(np.sqrt(d))
    _, lse = flash_fwd_plain(q3, k3, v3, None, scale, True, h)
    o3 = _to3(torch.from_numpy(np.array(o.astype(jnp.float32))).to(tdt))
    grads = flash_bwd_plain(q3, k3, v3, o3, lse, do3, None, scale, True, h)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        got = g.reshape(b, h, t, d).transpose(1, 2).float().numpy()
        _close(got, r.astype(jnp.float32), BWD_TOL[dtype], name)
    if dtype == "float32":
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(flash_attention(*leaves, causal=True), leaves,
                                   torch.from_numpy(do))
        for name, g, r in zip(("dq", "dk", "dv"), auto, ref):
            _close(g.numpy(), r, BWD_TOL[dtype], name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", SERVE_DIMS)
def test_decode_matches_jax(d, dtype):
    """K2's plain version against JAX's decode kernel (interpret mode) and
    ``decode_attention_xla``: GQA, ragged lengths, 1e4 past each length."""
    b, h, hk, cap = 3, 4, 2, 96
    q, k, v = _normal(d + 2, (b, h, d), (b, hk, cap, d), (b, hk, cap, d), dtype=dtype)
    lens = np.array([cap, 37, 1], np.int32)
    for i, n in enumerate(lens):
        k[i, :, n:] = 1e4
        v[i, :, n:] = 1e4
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           torch.from_numpy(lens))
    assert out.dtype == tdt and out.shape == (b, h, d)
    args = (*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(lens))
    for ref in (jax_decode_attention(*args), decode_attention_xla(*args)):
        _close(out.float().numpy(), ref.astype(jnp.float32), DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", SERVE_DIMS)
def test_paged_matches_jax(d, dtype):
    """K5's plain version against JAX's paged kernel ``paged_attention_fused``
    (interpret mode) and ``paged_attention_xla``: shuffled pages, GQA, a cap
    off the page, 1e4 in the null page and past each length."""
    b, h, hk, page, cap = 3, 4, 2, 8, 60
    q, k, v, table, lens = _paged_inputs(d, b, h, hk, d, page, cap, (60, 23, 1))
    if dtype == "bfloat16":
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                   for x in (q, k, v))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = paged_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                          torch.from_numpy(table), torch.from_numpy(lens), cap)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jt, jl = jnp.asarray(table), jnp.asarray(lens)
    for ref in (paged_attention_fused(jq, jk, jv, jt, jl),
                paged_attention_xla(jq, jk, jv, jt, jl, cap)):
        _close(out.float().numpy(), ref.astype(jnp.float32), DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", TRAIN_DIMS)
def test_block_sparse_matches_jax(d, dtype):
    """K8's, K9's and K10's plain versions (through ``block_sparse_attention``
    and its autograd Function) against JAX's block-sparse kernels (interpret
    mode) under ``jax.vjp``: the training layout (Fixed, unidirectional, a
    layout per head), o, dq, dk, dv."""
    b, t, h, block = 1, 128, 4, 16
    layout = tsa.FixedSparsityConfig(num_heads=h, block=block, different_layout_per_head=True,
                                     num_local_blocks=4, num_global_blocks=1,
                                     attention="unidirectional",
                                     num_different_global_patterns=4).make_layout(t)
    q, k, v, do = _normal(d + 3, *[(b, t, h, d)] * 4, dtype=dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o, vjp = jax.vjp(lambda a, b_, c: jbs.block_sparse_attention(a, b_, c, layout, block,
                                                                 causal=True),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = (o, *vjp(jnp.asarray(do, jdt)))
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = tbs.block_sparse_attention(*leaves, layout, block, causal=True)
    got = (out, *torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt)))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == tdt
        tol = SPARSE_TOL[dtype] if name == "o" or dtype == "float32" else BWD_TOL[dtype]
        _close(g.detach().float().numpy(), w.astype(jnp.float32), tol, name)


# ------------------------------------------------------------------ models
def test_gpt2_d80_generate_matches_jax():
    """A 2-layer GPT-2 of width 160 over 2 heads (d 80), f32, weights from
    the JAX engine through ``causal_lm_params_from_jax``: prefill logits and
    greedy ``generate`` tokens (ragged prompts) equal the JAX engine's."""
    tiny = dict(vocab_size=96, max_seq_len=64, n_embd=160, n_layer=2, n_head=2)
    config = {"dtype": "float32", "max_out_tokens": 64}
    jcfg = jax_lm.gpt2_cfg(**tiny, dtype=jnp.float32)
    jeng = JaxInferenceEngine(jcfg, JaxInferenceConfig(**config))
    params = jax.device_get(jeng.params)
    tcfg = torch_lm.gpt2_cfg(**tiny, dtype=torch.float32)
    assert tcfg.head_dim == 80
    teng = dst.init_inference((tcfg, causal_lm_params_from_jax(params, tcfg)), dict(config),
                              device="cpu")
    ids = np.random.default_rng(8).integers(0, 96, (3, 12)).astype(np.int32)
    ref = np.asarray(jax_lm.CausalLM(jcfg).apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        logits = teng.module(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(logits, ref, atol=1e-4, rtol=0)
    lens = [12, 7, 3]
    np.testing.assert_array_equal(teng.generate(ids, max_new_tokens=8, prompt_lengths=lens),
                                  jeng.generate(ids, max_new_tokens=8, prompt_lengths=lens))


def test_gpt2_d96_training_matches_jax():
    """A 2-layer GPT-2 of width 192 over 2 heads (d 96), f32 AdamW with
    clipping, the port's flash attention against the JAX engine's XLA
    attention from the same weights (``gpt2_params_from_jax``): three
    ``train_batch`` losses on one batch within 1e-5, as
    ``tests/test_torch_training.py``'s f32 trajectory, and falling."""
    tiny = dict(vocab_size=128, n_positions=64, n_embd=192, n_layer=2, n_head=2)
    config = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {
        "lr": 1e-3, "weight_decay": 0.01}}, "gradient_clipping": 1.0,
        "steps_per_print": 10**9}
    jcfg = jax_gpt2.GPT2Config(**tiny, dtype=jnp.float32, attention_impl="xla")
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(config))
    start = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = torch_gpt2.GPT2Config(**tiny, dtype=torch.float32)
    assert tcfg.head_dim == 96
    sd = gpt2_params_from_jax(start, tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg), init_fn=lambda seed, device: sd)
    tengine, _, _, _ = dst.initialize(model=model, config=dict(config), device="cpu")
    ids = np.random.default_rng(0).integers(0, 128, (8, 64)).astype(np.int32)
    jloss, tloss = [], []
    for _ in range(3):          # one batch, so the loss falls
        jloss.append(float(jengine.train_batch({"input_ids": ids})))
        tloss.append(tengine.train_batch({"input_ids": ids}).item())
    np.testing.assert_allclose(tloss, jloss, atol=1e-5, rtol=0)
    assert tloss[-1] < tloss[0]


def test_cpu_takes_any_head_dim_and_launches_nothing():
    """On the CPU nothing is refused: a GPT-2 of head_dim 84 (which the card
    refuses) serves and trains on the plain versions, with no launch."""
    op_builder.reset_launch_counts()
    eng = dst.init_inference(torch_lm.gpt2_cfg(vocab_size=64, max_seq_len=32, n_embd=168,
                                               n_layer=1, n_head=2),
                             {"dtype": "float32", "max_out_tokens": 32}, device="cpu")
    out = eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=3)
    assert out.shape == (1, 7)
    cfg = torch_gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=168, n_layer=1,
                                n_head=2)
    engine, _, _, _ = dst.initialize(model=torch_gpt2.gpt2_model(cfg), config={
        "train_batch_size": 2, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    assert np.isfinite(engine.train_batch({"input_ids": np.zeros((2, 32), np.int32)}).item())
    assert not any(op_builder.launch_counts().values())
