"""The port's GPT-2 against the JAX package's, on the CPU.

One flax parameter tree, every leaf redrawn from a seeded numpy generator (so
zero-initialised biases and unit LayerNorm scales are tested too), goes into
the JAX model as it is and into the port through ``gpt2_params_from_jax``,
for each weight layout (``scan_layers`` stacks the blocks, ``split_qkv``
splits the fused projection). The loss and its gradients are taken as the
engines take them: every parameter cast to the compute dtype, the JAX side by
``jax.grad``, the port's by autograd. The JAX model runs its ``xla``
attention; the port runs ``auto``, the flash path, whose plain versions run on
CPU tensors.

Tolerances. f32: logits and loss 1e-5 (sums in another order); gradients
per tensor ||g - g_jax|| <= 1e-4 ||g_jax|| + 1e-6 ||all of g_jax||: the
second term covers the key bias, whose exact gradient is 0 (a softmax is
blind to a constant added to a row) and which both sides leave as rounding
noise. bf16: logits 5e-2 (a few bf16 ulps of |logit| ~ 1-2: the two
frameworks round products, the GELU and the attention scores at different
points, and the head's bf16 product is taken to f32 afterwards, where JAX
asks for an f32 result), loss 2e-3, gradients 5e-2 relative per tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.runtime.utils import tree_cast
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax

TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)
TOL = {"float32": dict(logits=1e-5, loss=1e-5, grad=1e-4, floor=1e-6),
       "bfloat16": dict(logits=5e-2, loss=2e-3, grad=5e-2, floor=1e-6)}
CASES = [(True, False, "float32"), (False, False, "float32"), (True, True, "float32"),
         (False, True, "float32"), (True, False, "bfloat16")]


def _models(scan, split, dtype, seed=0):
    jcfg = jax_gpt2.GPT2Config(**TINY, scan_layers=scan, split_qkv=split,
                               dtype=getattr(jnp, dtype), attention_impl="xla")
    tcfg = torch_gpt2.GPT2Config(**TINY, split_qkv=split, dtype=getattr(torch, dtype))
    jmodel, tmodel = jax_gpt2.gpt2_model(jcfg), torch_gpt2.gpt2_model(tcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):          # LayerNorm scales around 1, all else around 0
        centre = 1.0 if path[-1].key == "scale" else 0.0
        return (centre + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return jcfg, jmodel, params, tcfg, tmodel, gpt2_params_from_jax(params, tcfg)


def _ids(seed, b=2, t=64):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("scan,split,dtype", CASES)
def test_gpt2_logits_loss_and_grads_match_jax(scan, split, dtype):
    jcfg, jmodel, params, tcfg, tmodel, sd = _models(scan, split, dtype)
    tol = TOL[dtype]
    ids = _ids(1)
    jbatch = {"input_ids": jnp.asarray(ids)}
    tbatch = {"input_ids": torch.from_numpy(ids).long()}

    ref_logits = np.asarray(jax.jit(jmodel.apply_fn)(params, jbatch), np.float32)
    logits = tmodel.apply_fn(sd, tbatch)
    assert logits.dtype == torch.float32 and logits.shape == (2, 64, TINY["vocab_size"])
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, atol=tol["logits"], rtol=0)

    def jax_loss(p):
        return jmodel.loss_fn(tree_cast(p, jcfg.dtype), jbatch, jax.random.PRNGKey(0))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    ref_grads = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), tcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    loss = tmodel.loss_fn({k: v.to(tcfg.dtype) for k, v in leaves.items()}, tbatch)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=tol["loss"], rtol=0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(ref_grads)
    total = float(np.sqrt(sum(float(g.norm()) ** 2 for g in ref_grads.values())))
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        err = float((g - ref_grads[name]).norm())
        assert err <= tol["grad"] * float(ref_grads[name].norm()) + tol["floor"] * total, \
            f"{name}: |g - g_jax| = {err:.3e}, |g_jax| = {float(ref_grads[name].norm()):.3e}"


def test_shift_labels_and_masked_loss_match_jax():
    """Explicit labels with -100 entries, and the shifted default."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -100
    ref = jax_gpt2.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = torch_gpt2.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=0)
    none = torch.full((2, 5), -100)
    assert torch_gpt2.cross_entropy_loss(torch.from_numpy(logits), none).item() == 0.0
    ids = torch.tensor([[1, 2, 3], [4, 5, 6]])
    assert torch_gpt2.shift_labels({"input_ids": ids}).tolist() == [[2, 3, -100], [5, 6, -100]]


def test_xla_impl_is_the_plain_attention():
    """``attention_impl="xla"`` (plain attention) and the default flash path
    give one loss in f32 (1e-6: the same attention in two formulations)."""
    ids = {"input_ids": torch.from_numpy(_ids(2)).long()}
    cfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32)
    params = torch_gpt2.init_params(cfg, seed=1, device="cpu")
    flash = torch_gpt2.gpt2_model(cfg).loss_fn(params, ids)
    plain = torch_gpt2.gpt2_model(torch_gpt2.GPT2Config(**TINY, dtype=torch.float32,
                                                        attention_impl="xla"))
    assert abs(plain.loss_fn(params, ids).item() - flash.item()) <= 1e-6


def test_config_sizes_match_jax():
    for preset in torch_gpt2.GPT2_PRESETS:
        jcfg, tcfg = jax_gpt2.gpt2_config(preset), torch_gpt2.gpt2_config(preset)
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.flops_per_token() == jcfg.flops_per_token()


def test_init_follows_the_jax_scheme():
    deep = dict(TINY, n_layer=8)
    cfg = torch_gpt2.GPT2Config(**deep)
    params = torch_gpt2.init_params(cfg, seed=0, device="cpu")
    shapes = jax.eval_shape(jax_gpt2.gpt2_model(jax_gpt2.GPT2Config(**deep)).init,
                            jax.random.PRNGKey(0))
    ref = gpt2_params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                               cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    assert float(params["h.3.c_proj.weight"].std()) == pytest.approx(0.02 / 4.0, rel=0.1)
    assert float(params["h.3.c_fc.weight"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(params["wte"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(params["h.0.ln_1.weight"], torch.ones(64))
    assert torch.equal(params["h.0.c_attn.bias"], torch.zeros(192))
    again = torch_gpt2.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


@pytest.mark.parametrize("kw,item", [({"dropout": 0.1}, "item 5"),
                                     ({"dropout": 0.1, "remat": True}, "item 5"),
                                     ({"attention_impl": "ring"}, "item 13"),
                                     ({"attention_impl": "ulysses"}, "item 13")])
def test_unported_model_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        torch_gpt2.GPT2Config(**TINY, **kw)


def test_unknown_remat_policy_raises():
    """JAX quietly takes full remat for any policy but "dots"; the port
    refuses every name but its three."""
    with pytest.raises(ValueError, match="'dots', 'full', 'offload_dots'"):
        torch_gpt2.GPT2Config(**TINY, remat=True, remat_policy="dots_saveable")
