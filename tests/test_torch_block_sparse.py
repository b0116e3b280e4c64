"""Block-sparse attention in the port against the JAX package, on the CPU.

The same numpy inputs go through ``deepspeed_tpu``'s functions (its Pallas
kernels in interpret mode on the CPU, as
``tests/unit/ops/sparse_attention/test_block_sparse_kernel.py`` runs them) and
``deepspeed_tpu_torch``'s (the kernels' plain versions, since the tensors lie
on the CPU):

- layouts of all seven config classes at several lengths, bit for bit, on a
  first and a second ``make_layout`` call (Variable and BigBird draw random
  blocks from one generator a config); ``layout_to_dense_mask`` and
  ``build_tables``;
- the forward output and the gradients of q, k and v against
  ``block_sparse_attention`` in f32 and bf16, causal and not, with a
  different layout per head, and on a hand-made layout with an empty q-block
  and one whose only block lies past its diagonal (where both follow the TPU
  kernel, not the dense reference);
- ``make_sparse_attention_impl``: its kernel path, its cached tables, its
  masked dense branch (a user mask; q shorter than k) and the refusal of
  attention dropout;
- 5 ``train_batch`` steps of a 2-layer GPT-2 (d 64) with the Fixed layout
  against ``deepspeed_tpu.initialize`` from the same weights.

Tolerances. Both sides compute in f32 (neither rounds p or ds to the input
dtype) and round each output once: f32 (atol 2e-5, rtol 2e-5) covers sums
of up to t terms in another order, and gradients up to ~20 on the hand-made
layout's masked rows; bf16 (atol 1e-5, rtol 8e-3) is one bf16 ulp of the
value (8 significant bits), which a last-bit f32 difference can flip, with
atol for values near 0. The engine trajectory keeps
``tests/test_torch_training.py``'s limits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.attention import block_sparse as jbs
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.kernel_checks import hand_made_layout

B, T, H, D = 2, 128, 4, 64
BLOCK = 16
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-5, 8e-3)}

# (class name, arguments): every config class, with per-head layouts, random
# blocks, global spans, horizontal globals and both directions among them
CONFIGS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=BLOCK)),
    ("FixedSparsityConfig", dict(num_heads=4, block=BLOCK, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional", num_different_global_patterns=4)),
    ("FixedSparsityConfig", dict(num_heads=2, block=BLOCK, num_local_blocks=2,
                                 horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(num_heads=3, block=BLOCK, different_layout_per_head=True,
                                    num_random_blocks=2, local_window_blocks=[2, 3],
                                    global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7], seed=3)),
    ("VariableSparsityConfig", dict(num_heads=2, block=BLOCK, num_random_blocks=1,
                                    attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_heads=3, block=BLOCK, different_layout_per_head=True,
                                   num_random_blocks=2, seed=5)),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=BLOCK, attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=BLOCK, global_block_indices=[1, 4],
                                        global_block_end_indices=[2, 6])),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=BLOCK)),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=BLOCK,
                                              attention="bidirectional")),
]
IDS = [f"{i}-{name[:-len('SparsityConfig')]}" for i, (name, _) in enumerate(CONFIGS)]


def _pair(name, kw):
    return getattr(jsa, name)(**kw), getattr(tsa, name)(**kw)


# ------------------------------------------------------------------ layouts, tables
@pytest.mark.parametrize("seq", [64, 128, 272])     # 272: a short last window
@pytest.mark.parametrize("name,kw", CONFIGS, ids=IDS)
def test_layouts_equal_jax(name, kw, seq):
    jcfg, tcfg = _pair(name, kw)
    for _ in range(2):      # the second call draws on from the same generator
        want, got = jcfg.make_layout(seq), tcfg.make_layout(seq)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name,kw", CONFIGS[1::2], ids=IDS[1::2])
def test_dense_mask_and_tables_equal_jax(name, kw):
    layout = getattr(tsa, name)(**kw).make_layout(T)
    want = jsa.layout_to_dense_mask(layout, BLOCK)
    got = tsa.layout_to_dense_mask(layout, BLOCK)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    jt, tt = jbs.build_tables(layout), tbs.build_tables(layout)
    assert set(tt) == set(jt)
    for key in jt:
        assert tt[key].dtype == jt[key].dtype and np.array_equal(tt[key], jt[key]), key
    # the tables walk the layout, and the backward ones its transpose
    dev = tbs.device_tables(tt, "cpu")
    assert torch.equal(tbs.table_layout(dev["fwd_idx"], dev["fwd_cnt"]),
                       torch.from_numpy(layout != 0))
    assert torch.equal(tbs.table_layout(dev["bwd_idx"], dev["bwd_cnt"]),
                       torch.from_numpy(layout != 0).transpose(1, 2))


# ------------------------------------------------------------------ attention
def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4)]


def _jax_attention(layout, causal, dtype, arrays):
    q, k, v, do = (jnp.asarray(x, getattr(jnp, dtype)) for x in arrays)
    o, vjp = jax.vjp(lambda a, b, c: jbs.block_sparse_attention(a, b, c, layout, BLOCK,
                                                                causal=causal), q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *vjp(do))]


def _torch_attention(layout, causal, dtype, arrays):
    q, k, v, do = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = tbs.block_sparse_attention(*leaves, layout, BLOCK, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    grads = torch.autograd.grad(o, leaves, do)
    return [x.detach().float().numpy() for x in (o, *grads)]


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


LAYOUTS = {
    # the training main path's pattern, 4 heads with 4 global patterns
    "fixed-uni-per-head": (CONFIGS[1], True),
    # the JAX gate's pattern: bidirectional, run under the triangle
    "fixed-bi-causal": (("FixedSparsityConfig", dict(num_heads=H, block=BLOCK,
                                                     num_local_blocks=2)), True),
    "bigbird-per-head": (("BigBirdSparsityConfig", dict(num_heads=H, block=BLOCK,
                                                        different_layout_per_head=True,
                                                        num_random_blocks=2, seed=1)), False),
    "longformer": (("BSLongformerSparsityConfig", dict(num_heads=H, block=BLOCK,
                                                       global_block_indices=[0, 5])), False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", list(LAYOUTS))
def test_attention_and_grads_match_jax_kernel(label, dtype):
    (name, kw), causal = LAYOUTS[label]
    layout = getattr(tsa, name)(**kw).make_layout(T)
    arrays = _inputs(1, dtype)
    _assert_close(_torch_attention(layout, causal, dtype, arrays),
                  _jax_attention(layout, causal, dtype, arrays), dtype)


def test_hand_made_layout_follows_the_jax_kernel():
    """An empty q-block gives zeros; a q-block whose only block lies past its
    diagonal gives the mean of that block's v rows (p = 1 on each masked
    entry, lse -1e30), in both packages' kernels, forward and backward."""
    layout = hand_made_layout(H, T, BLOCK)
    arrays = _inputs(2, "float32")
    got = _torch_attention(layout, True, "float32", arrays)
    _assert_close(got, _jax_attention(layout, True, "float32", arrays), "float32")
    o, v = got[0], arrays[2]
    assert np.abs(o[:, 2 * BLOCK:3 * BLOCK]).max() == 0.0
    mean = v[:, 5 * BLOCK:6 * BLOCK].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(o[:, 3 * BLOCK:4 * BLOCK],
                               np.broadcast_to(mean, o[:, 3 * BLOCK:4 * BLOCK].shape),
                               atol=2e-6, rtol=1e-5)
    q3 = torch.from_numpy(arrays[0]).transpose(1, 2).reshape(B * H, T, D)
    k3, v3 = (torch.from_numpy(x).transpose(1, 2).reshape(B * H, T, D) for x in arrays[1:3])
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    _, lse = tbs.block_sparse_fwd(q3, k3, v3, tables["fwd_idx"], tables["fwd_cnt"], BLOCK,
                                  causal=True, n_heads=H)
    assert bool((lse[:, 2 * BLOCK:4 * BLOCK] == tbs.NEG_INF).all())
    assert bool((lse[:, 4 * BLOCK:] > -1e3).all())


def test_dense_reference_where_every_row_has_a_key():
    """On a layout whose every row holds its diagonal block, the kernels'
    function equals the dense reference, and the port's reference equals the
    JAX package's."""
    layout = tsa.FixedSparsityConfig(**CONFIGS[1][1]).make_layout(T)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, "float32"))
    ref = tbs.block_sparse_attention_reference(q, k, v, layout, BLOCK, causal=True)
    jref = jbs.block_sparse_attention_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                                layout, BLOCK, causal=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=2e-5, rtol=2e-5)
    out = tbs.block_sparse_attention(q, k, v, layout, BLOCK, causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_shape_checks_match_jax():
    q = torch.zeros(B, T, H, D)
    layout = np.ones((H, T // BLOCK, T // BLOCK), np.int64)
    with pytest.raises(AssertionError, match="covers"):
        tbs.block_sparse_attention(q, q, q, layout[:, :4, :4], BLOCK)
    with pytest.raises(AssertionError, match="self-attention"):
        tbs.block_sparse_attention(q, q[:, :64], q, layout, BLOCK)
    with pytest.raises(AssertionError):
        tbs.block_sparse_attention(q, q, q, layout[:2], BLOCK)
    tables = tbs.device_tables(tbs.build_tables(layout), "cpu")
    q3 = torch.zeros(B * H, T, D)
    with pytest.raises(ValueError, match="does not divide"):
        tbs.block_sparse_fwd(q3[:, :120], q3[:, :120], q3[:, :120], tables["fwd_idx"],
                             tables["fwd_cnt"], BLOCK, n_heads=H)
    with pytest.raises(ValueError, match="tables"):
        tbs.block_sparse_fwd(q3, q3, q3, tables["fwd_idx"][:2], tables["fwd_cnt"], BLOCK,
                             n_heads=H)
    with pytest.raises(TypeError, match="int32"):
        tbs.block_sparse_fwd(q3, q3, q3, tables["fwd_idx"].long(), tables["fwd_cnt"], BLOCK,
                             n_heads=H)
    meta = q3.to("meta")        # no quiet fallback: neither the CPU nor CUDA
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbs.block_sparse_fwd(meta, meta, meta, tables["fwd_idx"], tables["fwd_cnt"], BLOCK,
                             n_heads=H)


# ------------------------------------------------------------------ the impl
def _impls(name, kw):
    jcfg, tcfg = _pair(name, kw)
    return jbs.make_sparse_attention_impl(jcfg), tbs.make_sparse_attention_impl(tcfg)


def test_impl_matches_jax_and_caches_tables(monkeypatch):
    (name, kw), _ = LAYOUTS["longformer"]
    jimpl, timpl = _impls(name, kw)
    q, k, v, _ = _inputs(4, "float32")
    want = np.asarray(jimpl(*(jnp.asarray(x) for x in (q, k, v)), causal=False))
    builds, build = [], tbs.build_tables

    def counting(layout):
        builds.append(layout.shape)
        return build(layout)

    monkeypatch.setattr(tbs, "build_tables", counting)
    for _ in range(2):
        got = timpl(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert builds == [(H, T // BLOCK, T // BLOCK)]  # the second call found them cached


@pytest.mark.parametrize("case", ["user-mask", "decode-tail", "user-mask-4d"])
def test_impl_masked_dense_branch_matches_jax(case):
    """A user mask, or q covering only the tail of k, keeps the layout on
    the masked dense path in both packages."""
    cfg = ("FixedSparsityConfig", dict(num_heads=H, block=BLOCK, num_local_blocks=2,
                                       attention="unidirectional"))
    jimpl, timpl = _impls(*cfg)
    q, k, v, _ = _inputs(5, "float32")
    rng = np.random.default_rng(6)
    mask = None
    if case == "decode-tail":
        q = q[:, -BLOCK:]
    elif case == "user-mask":
        mask = (rng.random((B, T)) > 0.2).astype(np.int32)
        mask[:, 0] = 1
    else:
        mask = rng.random((B, 1, T, T)) > 0.2
        mask[..., 0] = True
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    targs = [torch.from_numpy(x) for x in (q, k, v)]
    want = jimpl(*jargs, causal=True, mask=None if mask is None else jnp.asarray(mask))
    got = timpl(*targs, causal=True, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_impl_refuses_attention_dropout():
    impl = tbs.make_sparse_attention_impl(tsa.FixedSparsityConfig(H, BLOCK))
    q = torch.zeros(B, T, H, D)
    with pytest.raises(NotImplementedError, match="item 5"):
        impl(q, q, q, dropout_rate=0.1)


# ------------------------------------------------------------------ training
SMALL = dict(vocab_size=128, n_positions=64, n_embd=128, n_layer=2, n_head=2)
TRAIN_SPARSITY = ("FixedSparsityConfig", dict(num_heads=2, block=BLOCK,
                                              different_layout_per_head=True,
                                              num_local_blocks=2, num_global_blocks=1,
                                              attention="unidirectional",
                                              num_different_global_patterns=2))
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
UPDATE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _config(precision):
    """``tests/test_torch_training.py``'s engine config: AdamW, accumulation 2,
    clipping 1.0, WarmupLR over 3 steps."""
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10**9,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3, "warmup_max_lr": 1e-2,
                                     "warmup_type": "linear"}},
            **({"bf16": {"enabled": True}} if precision == "bfloat16" else {})}


def _without_key_bias(name, x):
    x = x.clone()
    if name.endswith("c_attn.bias"):
        x[SMALL["n_embd"]:2 * SMALL["n_embd"]] = 0.0
    return x


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sparse_train_batch_trajectory_matches_jax(precision):
    """5 steps on GPT-2 with the block-sparse impl, from the JAX engine's
    initial weights; config, limits and the key-bias exclusion as
    ``tests/test_torch_training.py`` sets them."""
    jsparse, tsparse = _pair(*TRAIN_SPARSITY)
    config = _config(precision)
    jcfg = jax_gpt2.GPT2Config(**SMALL, dtype=getattr(jnp, precision),
                               attention_impl=jbs.make_sparse_attention_impl(jsparse))
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(config))
    start_tree = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = torch_gpt2.GPT2Config(**SMALL, dtype=getattr(torch, precision),
                                 attention_impl=tbs.make_sparse_attention_impl(tsparse))
    start = gpt2_params_from_jax(start_tree, tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg), init_fn=lambda seed, device: start)
    tengine, _, _, _ = dst.initialize(model=model, config=dict(config), device="cpu")
    rng = np.random.default_rng(0)
    jloss, tloss = [], []
    for _ in range(5):
        ids = rng.integers(0, SMALL["vocab_size"], (16, SMALL["n_positions"])).astype(np.int32)
        jloss.append(float(jengine.train_batch({"input_ids": ids})))
        tloss.append(tengine.train_batch({"input_ids": ids}).item())
    np.testing.assert_allclose(tloss, jloss, atol=LOSS_TOL[precision], rtol=0)
    assert tengine.global_steps == jengine.global_steps == 5
    final = gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jengine.state.params)), tcfg)
    for name, p in tengine.state.params.items():
        got = _without_key_bias(name, p.detach() - start[name])
        want = _without_key_bias(name, final[name] - start[name])
        err = float((got - want).norm())
        assert err <= UPDATE_TOL[precision] * float(want.norm()), \
            f"{name}: |dp - dp_jax| = {err:.3e}, |dp_jax| = {float(want.norm()):.3e}"
