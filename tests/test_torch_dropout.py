"""Dropout and the training random stream against the JAX package, on the CPU.

The port's keys are its own (a splitmix64 ``fold_in``, not threefry), so the
masks cannot be compared draw for draw. What is held to JAX:

- at p = 0 with a key, GPT-2's loss and gradients equal JAX's (1e-5, f32);
- with both sides drawing the same masks (``jax.random.bernoulli`` and the
  port's ``runtime.rng.bernoulli`` patched, in the test only, to replay one
  numpy stream in call order: the embeddings, then per block the attention
  probabilities, ``c_proj``'s output and the MLP's), GPT-2's loss and every
  gradient equal JAX's at p = 0.1 (1e-5 and 1e-4 relative per tensor, f32),
  and the flash and block-sparse impls equal JAX's on the same masks (1e-6);
- the flash impl sends a mask, dropout or cross-attention to the plain
  attention (the kernel Function is never called), and ALiBi with any of them
  raises, as JAX's rule does.

Held inside the port: the keep rate and the 1 / (1 - p) scaling (statistically,
6 sigma); keys that differ across steps and micro-batches, an eval stream
apart from the training one, keys that advance on an fp16 overflow skip and
resume after ``load_checkpoint``; gradients under remat (full, dots) bit for
bit equal to those without.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.attention.block_sparse import \
    make_sparse_attention_impl as jax_sparse_impl
from deepspeed_tpu.ops.attention.flash import flash_attention as jax_flash_attention
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JaxFixed
from deepspeed_tpu.runtime.utils import tree_cast
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.ops.attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.attention import flash as tflash
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer.attention import reference_attention
from deepspeed_tpu_torch.runtime import rng as trng

TINY = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4)


class SharedMasks:
    """One numpy stream of Bernoulli masks, drawn by whichever side asks first
    and replayed to the other in the same call order."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.masks = []
        self.pos = 0

    def draw(self, p, shape):
        shape = tuple(int(s) for s in shape)
        if self.pos == len(self.masks):
            self.masks.append((shape, self.rng.random(shape) < p))
        want, mask = self.masks[self.pos]
        assert want == shape, f"draw {self.pos}: shape {shape}, the other side drew {want}"
        self.pos += 1
        return mask

    def replay(self):
        self.pos = 0


@pytest.fixture
def shared(monkeypatch):
    masks = SharedMasks()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(masks.draw(p, shape)))
    monkeypatch.setattr(trng, "bernoulli",
                        lambda key, p, shape, device: torch.from_numpy(masks.draw(p, shape)))
    return masks


def _models(dropout):
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32, attention_impl="xla",
                               scan_layers=False, dropout=dropout)
    jmodel = jax_gpt2.gpt2_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.PRNGKey(0)))
    tcfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32, dropout=dropout)
    return jcfg, jmodel, params, tcfg, torch_gpt2.gpt2_model(tcfg), \
        gpt2_params_from_jax(params, tcfg)


def _loss_and_grads(dropout, tkey, jkey):
    jcfg, jmodel, params, tcfg, tmodel, sd = _models(dropout)
    ids = np.random.default_rng(1).integers(0, TINY["vocab_size"], (2, 32)).astype(np.int32)

    def jax_loss(p):
        return jmodel.loss_fn(tree_cast(p, jcfg.dtype), {"input_ids": jnp.asarray(ids)}, jkey)

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    jgrads = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    loss = tmodel.loss_fn(leaves, {"input_ids": torch.from_numpy(ids).long()}, tkey)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return float(jloss), jgrads, loss.item(), grads


def _hold(jloss, jgrads, tloss, tgrads, grad_rtol):
    assert abs(tloss - jloss) <= 1e-5
    for name, g in tgrads.items():
        err = float((g - jgrads[name]).norm())
        assert err <= grad_rtol * float(jgrads[name].norm()) + 1e-7, \
            f"{name}: |g - g_jax| = {err:.3e}, |g_jax| = {float(jgrads[name].norm()):.3e}"


def test_p0_with_a_key_equals_jax():
    _hold(*_loss_and_grads(0.0, tkey=trng.root_key(3), jkey=jax.random.PRNGKey(3)),
          grad_rtol=1e-4)


def test_shared_masks_gpt2_loss_and_grads_equal_jax(shared):
    """p = 0.1 at every JAX site; the port's flash impl sends the attention
    dropout to the plain attention, JAX's xla impl applies it."""
    _, jmodel, params, tcfg, tmodel, sd = _models(0.1)
    ids = np.random.default_rng(1).integers(0, TINY["vocab_size"], (2, 32)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {"input_ids": jnp.asarray(ids)},
                                 jax.random.PRNGKey(0)))(params)
    n_draws = len(shared.masks)
    assert n_draws == 1 + 3 * TINY["n_layer"]
    shared.replay()
    leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
    loss = tmodel.loss_fn(leaves, {"input_ids": torch.from_numpy(ids).long()}, 11)
    assert shared.pos == n_draws
    tgrads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    jgrads = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)
    _hold(float(jloss), jgrads, loss.item(), tgrads, grad_rtol=1e-4)
    # the same masks and no key difference: the masks are what moved the loss
    shared.replay()
    assert tmodel.loss_fn(sd, {"input_ids": torch.from_numpy(ids).long()}, 12).item() \
        == pytest.approx(loss.item(), abs=1e-6)
    assert abs(tmodel.loss_fn(sd, {"input_ids": torch.from_numpy(ids).long()}).item()
               - loss.item()) > 1e-3


def _qkv(b=2, t=32, h=4, d=16, s=None, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s or t, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("impl", ["flash", "block_sparse"])
def test_shared_masks_attention_impls_equal_jax(shared, impl):
    q, k, v = _qkv()
    if impl == "flash":
        jfn, tfn = jax_flash_attention, tflash.flash_attention
    else:
        jfn = jax_sparse_impl(JaxFixed(num_heads=4, block=8))
        tfn = tbs.make_sparse_attention_impl(FixedSparsityConfig(num_heads=4, block=8))
    want = jfn(*map(jnp.asarray, (q, k, v)), causal=True, dropout_rate=0.2,
               dropout_rng=jax.random.PRNGKey(0))
    shared.replay()
    got = tfn(*map(torch.from_numpy, (q, k, v)), causal=True, dropout_rate=0.2, dropout_rng=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_flash_routes_to_plain_attention(monkeypatch):
    """JAX's rule (``flash.py:462-469``): mask, dropout or cross-attention go to
    the plain attention without touching the kernel Function; ALiBi with any
    of them raises."""
    q, k, v = map(torch.from_numpy, _qkv())
    _, kx, vx = map(torch.from_numpy, _qkv(s=24, seed=4))

    def no_kernel(*args):
        raise AssertionError("the flash kernel Function was called")

    monkeypatch.setattr(tflash.FlashAttnFunction, "apply", no_kernel)
    mask = torch.from_numpy(np.random.default_rng(0).random((2, 32)) > 0.3)
    assert torch.equal(tflash.flash_attention(q, k, v, dropout_rate=0.1, dropout_rng=9),
                       reference_attention(q, k, v, dropout_rate=0.1, dropout_rng=9))
    assert torch.equal(tflash.flash_attention(q, k, v, mask=mask),
                       reference_attention(q, k, v, mask=mask))
    assert torch.equal(tflash.flash_attention(q, kx, vx, causal=False),
                       reference_attention(q, kx, vx, causal=False))
    slopes = torch.ones(4)
    for kw in ({"dropout_rate": 0.1, "dropout_rng": 1}, {"mask": mask}):
        with pytest.raises(NotImplementedError, match="alibi"):
            tflash.flash_attention(q, k, v, alibi_slopes=slopes, **kw)
    with pytest.raises(AssertionError, match="kernel Function"):   # rate 0: the kernels
        tflash.flash_attention(q, k, v, dropout_rate=0.0, dropout_rng=3)


def test_keep_rate_and_scaling_hold():
    p, n = 0.1, 1 << 20
    x = torch.ones(n)
    y = trng.dropout(x, p, trng.root_key(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 6 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / (1 - p)]))
    assert torch.equal(trng.dropout(x, 0.0, 1), x) and torch.equal(trng.dropout(x, p, None), x)
    # attention dropout is unbiased: the mean over keys approaches the output
    q, k, v = map(torch.from_numpy, _qkv(b=1, t=8, h=2, d=4))
    base = reference_attention(q, k, v)
    runs = torch.stack([reference_attention(q, k, v, dropout_rate=0.5, dropout_rng=s)
                        for s in range(400)])
    assert float((runs.mean(0) - base).abs().max()) <= 6 * float(runs.std(0).max()) / 20


# ------------------------------------------------------------------ engine keys
ENGINE_CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
                 "steps_per_print": 10**9,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _recording_engine(config=ENGINE_CONFIG, seed=42, **cfg_kw):
    cfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32, dropout=0.1, **cfg_kw)
    model = torch_gpt2.gpt2_model(cfg)
    keys = []

    def loss_fn(params, batch, rng=None):
        keys.append(rng)
        return model.loss_fn(params, batch, rng)

    engine = dst.DeepSpeedEngine(model=dataclasses.replace(model, loss_fn=loss_fn),
                                 config=dict(config), device="cpu", seed=seed)
    return engine, keys


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (n, 16))


def test_keys_differ_across_steps_micro_batches_and_eval():
    engine, keys = _recording_engine()
    for step in range(2):
        engine.train_batch({"input_ids": _ids(4, step)})
    for _ in range(2):                      # the triple: keys fold micro_steps
        engine.forward({"input_ids": _ids(2)})
        engine.backward()
        engine.step()
    engine.eval_batch({"input_ids": _ids(2)})
    engine.eval_batch({"input_ids": _ids(2)})
    base = trng.root_key(42)
    want = [trng.fold_in(trng.fold_in(base, s), i) for s in (0, 1) for i in (0, 1)]
    want += [trng.fold_in(trng.fold_in(base, 2), m) for m in (4, 5)]
    want += [trng.fold_in(trng.fold_in(base, trng.EVAL_STREAM), c) for c in (1, 2)]
    assert keys == want and len(set(keys)) == len(keys)
    masks = [trng.bernoulli(k, 0.9, (64,), "cpu") for k in keys]
    assert len({tuple(m.tolist()) for m in masks}) == len(masks)
    # eval applies dropout, as JAX's deterministic=False loss does
    params = {k: p.detach() for k, p in engine.state.params.items()}
    ids = {"input_ids": torch.from_numpy(_ids(2))}
    assert engine.eval_batch(ids).item() != pytest.approx(
        engine.module.loss_fn(params, ids).item(), abs=1e-4)
    again, again_keys = _recording_engine()
    for step in range(2):
        again.train_batch({"input_ids": _ids(4, step)})
    assert again_keys == keys[:4]
    assert all(torch.equal(again.state.params[k], engine_p)
               for k, engine_p in _params_after(ENGINE_CONFIG, 2).items())


def _params_after(config, steps):
    engine, _ = _recording_engine(config)
    for step in range(steps):
        engine.train_batch({"input_ids": _ids(4, step)})
    return {k: p.detach() for k, p in engine.state.params.items()}


def test_keys_advance_on_overflow_and_resume_after_load(tmp_path):
    fp16 = dict(ENGINE_CONFIG, fp16={"enabled": True, "initial_scale_power": 60,
                                     "hysteresis": 1})
    engine, keys = _recording_engine(fp16)
    for step in range(2):
        engine.train_batch({"input_ids": _ids(4, step)})
    assert engine.skipped_steps == 2 and keys[0] != keys[2]
    engine, keys = _recording_engine()
    for step in range(3):
        engine.train_batch({"input_ids": _ids(4, step)})
    engine.save_checkpoint(str(tmp_path), tag="t")
    engine.train_batch({"input_ids": _ids(4, 3)})
    fresh, fresh_keys = _recording_engine(seed=42)
    fresh.load_checkpoint(str(tmp_path), tag="t")
    fresh.train_batch({"input_ids": _ids(4, 3)})
    assert fresh_keys == keys[6:]
    assert all(torch.equal(fresh.state.params[k], p) for k, p in engine.state.params.items())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_no_remat_bit_for_bit(policy):
    cfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32, dropout=0.1)
    params = torch_gpt2.init_params(cfg, 0, "cpu")
    ids = {"input_ids": torch.from_numpy(_ids(2))}

    def grads(c):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = torch_gpt2.gpt2_model(c).loss_fn(leaves, ids, 77)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    want_loss, want = grads(cfg)
    got_loss, got = grads(dataclasses.replace(cfg, remat=True, remat_policy=policy))
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
