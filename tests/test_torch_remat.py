"""Activation checkpointing and the chunked-vocab loss against the JAX package, on the CPU.

``deepspeed_tpu_torch.checkpointing`` (``runtime/activation_checkpointing``)
is held to ``deepspeed_tpu.checkpointing`` policy by policy on the same numpy
inputs, and to its own unwrapped function bit for bit; what each policy
keeps for the backward is counted on one GPT-2 block; GPT-2 with ``remat``
must give the no-remat losses and gradients bit for bit in f32 (its engine
trajectories against the JAX engine's are in ``test_torch_training.py``).
``runtime/zero/tiling.py`` (``chunked_vocab_cross_entropy``, ``TiledDense``,
``tiled_kernel_from_dense``) is held to JAX's ``runtime/zero/tiling.py``.

Tolerances: a policy's gradient against JAX's 1e-6 relative in norm (one
f32 formula, other summation orders: JAX's own checkpointed and plain
gradients are 9e-8 apart); the chunked loss 1e-5 relative and its
gradients 1e-4 relative + 1e-5 absolute against JAX's (its online
logsumexp is summed in another order, and its backward is autodiff of the
scan where the port's is softmax − onehot); ``TiledDense`` 1e-5.
"""

import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.runtime.zero import tiling as jax_tiling
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import tiled_dense_params_from_jax
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ac
from deepspeed_tpu_torch.runtime.zero import tiling

BLOCK = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=1, n_head=4,
             dtype=torch.float32)


@pytest.fixture(autouse=True)
def _unconfigured():
    ac.reset()
    ds.checkpointing.reset()
    yield
    ac.reset()
    ds.checkpointing.reset()


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((64, 64)).astype(np.float32),
            rng.standard_normal((4, 64)).astype(np.float32))


def _torch_grad(a, x, policy=None, wrap=True):
    a = torch.from_numpy(a).requires_grad_()
    x = torch.from_numpy(x)

    def f(a_, b_):
        return torch.tanh(b_ @ a_) @ a_

    out = ac.checkpoint(f, a, x, policy=policy) if wrap else f(a, x)
    return torch.autograd.grad(out.sum(), a)[0]


# ----------------------------------------------------------------- policies
@pytest.mark.parametrize("policy", sorted(ac.POLICIES))
def test_policy_gradient_is_exact_and_matches_jax(policy):
    a, x = _inputs()
    got = _torch_grad(a, x, policy)
    assert torch.equal(got, _torch_grad(a, x, wrap=False))
    want = jax.jit(jax.grad(lambda a_: jnp.sum(ds.checkpointing.checkpoint(
        lambda p, q: jnp.tanh(q @ p) @ p, a_, jnp.asarray(x), policy=policy))))(
            jnp.asarray(a))
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-6 * np.linalg.norm(want)


def test_configure_is_configured_and_unknown_policy():
    """Port of ``test_flops_profiler.py``'s checkpointing case."""
    w = torch.full((8, 8), 0.1)
    x = torch.ones(2, 8, requires_grad=True)
    g1 = torch.autograd.grad(dst.checkpointing.checkpoint(
        lambda y: ((y @ w) ** 2).sum(), x), x)[0]
    g2 = torch.autograd.grad(((x @ w) ** 2).sum(), x)[0]
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-6)
    assert not dst.checkpointing.is_configured()
    dst.checkpointing.configure(deepspeed_config=None)
    assert dst.checkpointing.is_configured()
    with pytest.raises(ValueError, match="offload_dots"):
        dst.checkpointing.checkpoint(lambda y: y, x, policy="nope")
    with pytest.raises(ValueError, match="known"):
        dst.checkpointing.checkpoint_wrapper(lambda y: y, policy="nope")
    dst.checkpointing.reset()
    assert not dst.checkpointing.is_configured()


def test_cpu_checkpointing_promotes_to_offload_dots():
    """Port of ``test_reliability.py``'s ``test_cpu_checkpointing_policy``:
    ``checkpoint_in_cpu`` gives ``offload_dots``, whose gradients equal full
    remat's; and JAX's order of precedence for the active policy."""
    a, x = _inputs()
    assert ac._active_policy_name(None) == "nothing_saveable"
    ac.configure(deepspeed_config=None, checkpoint_in_cpu=True)
    assert ac._active_policy_name(None) == "offload_dots"
    assert ac._active_policy_name("dots") == "dots"
    g_off = _torch_grad(a, x)
    ac.reset()
    assert torch.equal(g_off, _torch_grad(a, x, policy="full"))
    block = DeepSpeedConfig({"train_batch_size": 4, "activation_checkpointing": {
        "policy": "dots_saveable"}})
    assert ac.configure(deepspeed_config=block).policy == "dots_saveable"
    assert ac._active_policy_name(None) == "dots_saveable"
    block = DeepSpeedConfig({"train_batch_size": 4, "activation_checkpointing": {
        "policy": "dots", "cpu_checkpointing": True}})
    ac.configure(deepspeed_config=block)
    assert ac._active_policy_name(None) == "offload_dots"
    # the keys the JAX package never acts on are refused here as in the config
    with pytest.raises(NotImplementedError, match="item 11"):
        ac.configure(partition_activations=True)
    with pytest.raises(NotImplementedError, match="not read by the JAX package"):
        ac.configure(num_checkpoints=4)
    with pytest.raises(ValueError, match="known"):
        DeepSpeedConfig({"train_batch_size": 4,
                         "activation_checkpointing": {"policy": "nope"}})


class _Made(TorchDispatchMode):
    """Every tensor an op makes while the mode is on, as weak references."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.made.append((func, tuple(t.shape), weakref.ref(t)))
        return out


def _kept(policy):
    """What one GPT-2 block's forward leaves alive for its backward: the
    tensors made in the forward that outlive it, other than the output, as
    ``(op, shape)``. Selective checkpointing keeps its saved outputs in a
    cache outside ``saved_tensors_hooks``, so this counts what is alive."""
    cfg = torch_gpt2.GPT2Config(**BLOCK, attention_impl="xla")
    block = torch_gpt2.Block(cfg, "meta")
    params = {k[len("h.0."):]: v.requires_grad_()
              for k, v in torch_gpt2.init_params(cfg, 0, "cpu").items() if k.startswith("h.0.")}
    x = torch.randn(2, 32, 32, requires_grad=True)
    with _Made() as made:
        if policy is None:
            out = functional_call(block, params, (x,))
        else:
            out = ac.checkpoint(functools.partial(torch_gpt2._run_block, block), x, params,
                                policy=policy)
    gc.collect()
    kept = sorted((str(f), s) for f, s, r in made.made if r() is not None and r() is not out)
    # what autograd saves outside the checkpoint: for a checkpointed block,
    # its input alone
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append("input" if t is x else tuple(t.shape)) or t, lambda t: t):
        (functional_call(block, params, (x,)) if policy is None else
         ac.checkpoint(functools.partial(torch_gpt2._run_block, block), x, params,
                       policy=policy))
    return kept, saved


def test_what_each_policy_keeps():
    """full keeps nothing the block made (only its input, held by the
    recompute); dots the four projections' products (b·t rows of 3d, d, 4d,
    d) and no batched product; dots_saveable also the two attention
    ``bmm`` outputs; everything_saveable what the unwrapped block keeps."""
    n, d = 2 * 32, 32
    plain, plain_saved = _kept(None)
    assert plain and len(plain_saved) > 1
    assert _kept("full") == ([], ["input"])
    dots, dots_saved = _kept("dots")
    assert dots_saved == ["input"]
    assert sorted(s for _, s in dots) == sorted([(n, 3 * d), (n, d), (n, 4 * d), (n, d)])
    with_bmm, _ = _kept("dots_saveable")
    assert sorted(s for _, s in with_bmm) == sorted(
        [(n, 3 * d), (n, d), (n, 4 * d), (n, d), (2 * 4, 32, 32), (2 * 4, 32, 8)])
    assert _kept("everything_saveable") == (plain, plain_saved)


# -------------------------------------------------------- GPT-2 with remat
def _loss_and_grads(seed_ids, **kw):
    cfg = torch_gpt2.GPT2Config(**dict(BLOCK, n_layer=2), **kw)
    model = torch_gpt2.gpt2_model(cfg)
    params = {k: v.requires_grad_() for k, v in torch_gpt2.init_params(cfg, 0, "cpu").items()}
    loss = model.loss_fn(params, {"input_ids": seed_ids})
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


@pytest.mark.parametrize("attention", ["auto", "xla"])
@pytest.mark.parametrize("policy", ["full", "dots", "offload_dots"])
def test_gpt2_remat_equals_no_remat_bit_for_bit(policy, attention):
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (4, 32)))
    want = _loss_and_grads(ids, attention_impl=attention)
    got = _loss_and_grads(ids, attention_impl=attention, remat=True, remat_policy=policy)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("policy,name", [("full", "nothing_saveable"),
                                         ("dots", "dots_with_no_batch_dims_saveable"),
                                         ("offload_dots", "offload_dots")])
def test_gpt2_block_policy_comes_from_its_config_alone(policy, name, monkeypatch):
    """Each block names its policy from ``remat_policy``; a configured
    ``checkpoint_in_cpu``, which promotes a checkpoint given no policy to
    ``offload_dots``, changes nothing in the model (JAX's GPT-2 does not
    read the checkpointing config either)."""
    ac.configure(checkpoint_in_cpu=True)
    used = []
    wrap = ac._wrap
    monkeypatch.setattr(ac, "_wrap", lambda fn, n: used.append(n) or wrap(fn, n))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (2, 32)))
    _loss_and_grads(ids, remat=True, remat_policy=policy)
    assert used == [name, name]


# ------------------------------------------------------ chunked-vocab loss
def _ce_inputs(b=2, t=6, d=16, vocab=100, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    wte = (rng.standard_normal((vocab, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels[0, -1] = -100
    return x, wte, labels


def _torch_ce(x, wte, labels, chunk):
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    loss = tiling.chunked_vocab_cross_entropy(xt, wt, torch.from_numpy(labels).long(),
                                              chunk=chunk)
    return (loss.detach(), *torch.autograd.grad(loss, (xt, wt)))


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_chunked_vocab_ce_matches_jax(chunk):
    """Chunks 32 and 64 split V = 100 unevenly, 128 exceeds it."""
    x, wte, labels = _ce_inputs()
    got = _torch_ce(x, wte, labels, chunk)
    want = jax.value_and_grad(
        lambda x_, w_: jax_tiling.chunked_vocab_cross_entropy(x_, w_, jnp.asarray(labels),
                                                              chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wte))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    full = torch_gpt2.cross_entropy_loss(torch.from_numpy(x) @ torch.from_numpy(wte).t(),
                                         torch.from_numpy(labels))
    np.testing.assert_allclose(float(got[0]), float(full), rtol=1e-6)


def test_chunked_vocab_ce_all_masked_is_zero():
    x, wte, labels = _ce_inputs()
    labels[:] = -100
    loss, dx, dw = _torch_ce(x, wte, labels, 32)
    want = jax_tiling.chunked_vocab_cross_entropy(jnp.asarray(x), jnp.asarray(wte),
                                                  jnp.asarray(labels), chunk=32)
    assert float(loss) == float(want) == 0.0
    assert not dx.any() and not dw.any()


def test_chunked_vocab_ce_bf16_rounds_as_the_full_head():
    """In bf16 each slice's product is rounded as the port's full head rounds
    it, so the chunked loss and gradients are the full-logits ones up to f32
    summation order (and the per-slice rounding of dx's bf16 products)."""
    x, wte, labels = _ce_inputs(b=3, t=16, d=32, vocab=200, seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(wte).to(torch.bfloat16).requires_grad_()
    lab = torch.from_numpy(labels).long()
    loss = tiling.chunked_vocab_cross_entropy(xt, wt, lab, chunk=48,
                                              compute_dtype=torch.bfloat16)
    got = torch.autograd.grad(loss, (xt, wt))
    full = torch_gpt2.cross_entropy_loss(
        torch.matmul(xt.to(torch.bfloat16), wt.t()).float(), lab)
    want = torch.autograd.grad(full, (xt, wt))
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(got[1].float().numpy(), want[1].float().numpy(), rtol=2e-2,
                               atol=1e-4)


def test_chunked_vocab_ce_saves_no_full_logits():
    b, t, d, vocab, chunk = 2, 8, 24, 256, 64
    x, wte, labels = _ce_inputs(b, t, d, vocab)
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(lambda s: shapes.append(s.numel()) or s,
                                                  lambda s: s):
        xt = torch.from_numpy(x).requires_grad_()
        loss = tiling.chunked_vocab_cross_entropy(xt, torch.from_numpy(wte).requires_grad_(),
                                                  torch.from_numpy(labels).long(), chunk=chunk)
    # x, wte, the labels and the logsumexp: nothing of N · V
    assert sorted(shapes) == sorted([b * t * d, vocab * d, b * t, b * t]), shapes
    loss.backward()


# ---------------------------------------------------------------- TiledDense
@pytest.mark.parametrize("in_splits,out_splits", [(1, 1), (2, 3), (3, 2)])
def test_tiled_dense_matches_jax(in_splits, out_splits):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 11)).astype(np.float32)
    kernel = rng.standard_normal((11, 9)).astype(np.float32)
    bias = rng.standard_normal(9).astype(np.float32)
    jtree = jax_tiling.tiled_kernel_from_dense(kernel, in_splits, out_splits, bias)
    want = jax_tiling.TiledDense(features=9, in_splits=in_splits,
                                 out_splits=out_splits).apply({"params": jtree},
                                                              jnp.asarray(x))
    carried = tiled_dense_params_from_jax(jax.device_get(jtree))
    ours = tiling.tiled_kernel_from_dense(torch.from_numpy(kernel.T.copy()), in_splits,
                                          out_splits, torch.from_numpy(bias))
    assert carried.keys() == ours.keys()
    assert all(torch.equal(carried[k], ours[k]) for k in ours)
    layer = tiling.TiledDense(11, 9, in_splits=in_splits, out_splits=out_splits)
    layer.load_state_dict(ours)
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), x @ kernel + bias, rtol=1e-5, atol=1e-5)


def test_tiled_dense_leaves_and_fresh_init():
    """No tile holds the whole matrix, the tiles cover it once, and a fresh
    layer's output spread matches a plain ``Dense`` (JAX's 1 / in_splits
    correction of the tile fan-in)."""
    layer = tiling.TiledDense(64, 100, in_splits=4, out_splits=5, use_bias=False)
    tiles = [p for n, p in layer.named_parameters() if n.startswith("weight_")]
    assert len(tiles) == 20 and max(p.numel() for p in tiles) <= 16 * 20
    assert sum(p.numel() for p in tiles) == 64 * 100
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 256)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(0)
    ratios = []
    for splits in (2, 4):
        tiled = tiling.TiledDense(256, 256, in_splits=splits, use_bias=False)
        tiled.reset_parameters(gen)
        one = tiling.TiledDense(256, 256, use_bias=False)
        one.reset_parameters(gen)
        with torch.no_grad():
            ratios.append(float(tiled(x).std() / one(x).std()))
    assert all(0.9 < r < 1.1 for r in ratios), ratios
