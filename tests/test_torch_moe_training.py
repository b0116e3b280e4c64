"""MoE training against the JAX package's, on the CPU.

A repair first: RSample's Gumbel noise (NaN before) against
``jax.random.gumbel``'s distribution. ``Experts``, ``moe_dispatch_combine``,
``MoE`` (top-1 and top-2, eval and
training mode without noise; residual MoE) on one flax parameter tree redrawn
from a seeded numpy generator: outputs, ``l_aux`` and expert counts within
1e-5 (f32, other summation orders), gradients within 1e-4 relative. The
parameter-group helpers give JAX's answers. ``GPT2MoE``: 3 ``train_batch``
steps in both engines (AdamW, f32) with the gate's noise off and a capacity
of at least the token count, so that random token selection changes nothing:
losses within 1e-5; the port's ``convert_training_model`` equals JAX's
(through ``causal_lm_params_from_jax``) exactly; and a trained port model
served through ``init_inference`` gives the training forward's logits in eval
mode (1e-5), its capacity high enough that no token drops. ``apply_fn``
ignores its key and runs deterministic, as JAX's does (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2_moe as jax_gpt2_moe
from deepspeed_tpu.module_inject.replace_module import \
    convert_training_model as jax_convert_training_model
from deepspeed_tpu.moe import experts as jax_experts
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jax_sharded
from deepspeed_tpu.moe import utils as jax_utils
from deepspeed_tpu_torch import moe as tmoe
from deepspeed_tpu_torch.models import causal_lm_params_from_jax, gpt2_moe
from deepspeed_tpu_torch.models.convert import gpt2_moe_params_from_jax
from deepspeed_tpu_torch.module_inject import convert_training_model

M, F, E = 16, 32, 4


def _redraw(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.2 * rng.standard_normal(x.shape)).astype(np.float32), tree)


def _torch_moe_params(jp):
    sd = {"gate_wg": jp["gate_wg"], **{f"experts.{k}": v for k, v in jp["experts"].items()}}
    for name in ("residual_fc1", "residual_fc2", "coefficient"):
        if name in jp:
            sd[f"{name}.weight"] = jp[name]["kernel"].T
            sd[f"{name}.bias"] = jp[name]["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_experts_match_jax():
    jmod = jax_experts.Experts(num_experts=E, d_model=M, d_ff=F, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((E, 5, M)).astype(np.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tmoe.Experts(E, M, F, dtype=torch.float32, device="meta")
    got = functional_call(tmod, {k: torch.from_numpy(v) for k, v in params.items()},
                          (torch.from_numpy(x),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dispatch_combine_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, M)).astype(np.float32)
    logits = rng.standard_normal((24, E)).astype(np.float32)
    _, jc, jd, _ = jax_sharded.top2gating(jnp.asarray(logits), 1.0, 4, rng=None)
    _, tc, td, _ = tmoe.top2gating(torch.from_numpy(logits), 1.0, 4)
    w = rng.standard_normal((M, M)).astype(np.float32)
    want = jax_sharded.moe_dispatch_combine(jnp.asarray(x), jc, jd, lambda e: jnp.tanh(e @ w))
    got = tmoe.moe_dispatch_combine(torch.from_numpy(x), tc, td,
                                    lambda e: torch.tanh(e @ torch.from_numpy(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rsample_noise_is_gumbel_as_jax():
    """Repair: the port's Gumbel draw clamped ``log(u)`` (negative) at 1e-20, so
    every noise value was NaN and RSample or top-2 sampling sent every token
    to expert 0. The noise now has ``jax.random.gumbel``'s distribution
    (mean, variance and quartiles within 6 sigma of a 2^18 sample) and
    RSample routing spreads near-tied logits over the experts."""
    n = 1 << 18
    got = tmoe.sharded_moe._gumbel((n,), torch.Generator().manual_seed(0), "cpu").numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (n,)))
    assert np.isfinite(got).all()
    sigma = np.sqrt(np.pi ** 2 / 6 / n)
    assert abs(got.mean() - want.mean()) <= 6 * sigma * np.sqrt(2)
    assert abs(got.var() / want.var() - 1) <= 0.05
    np.testing.assert_allclose(np.quantile(got, [0.25, 0.5, 0.75]),
                               np.quantile(want, [0.25, 0.5, 0.75]), atol=0.02)
    logits = torch.zeros(64, E)
    counts = tmoe.top1gating(logits, 1.0, 4, noisy_gate_policy="RSample",
                             generator=torch.Generator().manual_seed(1))[3]
    assert int((counts > 0).sum()) == E and float(counts.max()) < 32
    _, combine, _, _ = tmoe.top2gating(logits, 1.0, 4, generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(combine).all() and int((combine.sum((0, 2)) > 0).sum()) == E


MOE_CASES = {
    "top1-eval": dict(k=1, train=False),
    "top1-train": dict(k=1, train=True, capacity_factor=0.75),     # drops tokens
    "top2-train": dict(k=2, train=True, top2_2nd_expert_sampling=False),
    "residual": dict(k=1, train=True, use_residual=True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case):
    kw = dict(MOE_CASES[case])
    train = kw.pop("train")
    common = dict(num_experts=E, use_rts=False, noisy_gate_policy=None, **kw)
    jmod = jax_layer.MoE(hidden_size=M, ffn_hidden_size=F, dtype=jnp.float32, token_axes=(),
                         **common)
    x = np.random.default_rng(3).standard_normal((2, 8, M)).astype(np.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)

    def jax_loss(p):
        y, l_aux, counts = jmod.apply({"params": p}, jnp.asarray(x), deterministic=not train)
        return jnp.sum(y ** 2) + l_aux, (y, l_aux, counts)

    (_, (jy, jl, jc)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tmod = tmoe.MoE(M, F, dtype=torch.float32, device="meta", **common)
    leaves = {k: v.clone().requires_grad_() for k, v in _torch_moe_params(params).items()}
    ty, tl, tc = functional_call(tmod, leaves, (torch.from_numpy(x),),
                                 {"key": 9 if train else None})
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    grads = dict(zip(leaves, torch.autograd.grad((ty ** 2).sum() + tl, list(leaves.values()))))
    want = _torch_moe_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, g in grads.items():
        err = float((g - want[name]).norm())
        assert err <= 1e-4 * float(want[name].norm()) + 1e-7, name


def test_param_group_helpers_match_jax():
    names = ["wte", "h.1.moe.gate_wg", "h.1.moe.experts.w1", "h.0.c_fc.weight",
             "h_moe_1/moe/experts/b2"]
    assert [tmoe.is_moe_param_path(n) for n in names] == \
        [jax_utils.is_moe_param_path(n) for n in names]
    params = {n: np.ones(2) for n in names}
    moe, dense = tmoe.split_moe_param_paths(params)
    assert moe == names[1:3] + names[4:] and dense == [names[0], names[3]]
    mapped = tmoe.map_moe_params(params, lambda x: x * 2, lambda x: x * 3)
    assert mapped["wte"][0] == 3 and mapped["h.1.moe.gate_wg"][0] == 2

    class P:
        def __init__(self, allreduce=True):
            self.allreduce = allreduce

    a, b, c = P(), P(False), P()
    groups = [{"params": [a, b, c], "lr": 0.1}]
    want = jax_utils.split_params_into_different_moe_groups_for_optimizer(groups)
    got = tmoe.split_params_into_different_moe_groups_for_optimizer(groups)
    assert got == want and got[1]["params"] == [b] and got[1]["moe"]


# ------------------------------------------------------------------ GPT2MoE
TINY = dict(vocab_size=96, n_positions=32, n_embd=32, n_layer=2, n_head=4, num_experts=4)
CONFIG = {"train_batch_size": 8, "steps_per_print": 10**9, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}}}


@pytest.fixture(scope="module")
def trained():
    """Both engines, 3 steps from one start (noise off, capacity factor 4 =
    the expert count, so every expert can take every token)."""
    kw = dict(TINY, noisy_gate_policy=None, capacity_factor=4.0, eval_capacity_factor=4.0)
    jcfg = jax_gpt2_moe.GPT2MoEConfig(**kw, dtype=jnp.float32, attention_impl="xla")
    jengine, _, _, _ = ds.initialize(model=jax_gpt2_moe.gpt2_moe_model(jcfg),
                                     config=dict(CONFIG))
    start = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = gpt2_moe.GPT2MoEConfig(**kw, dtype=torch.float32)
    sd = gpt2_moe_params_from_jax(start, tcfg)
    model = dataclasses.replace(gpt2_moe.gpt2_moe_model(tcfg), init_fn=lambda s, d: sd)
    tengine, _, _, _ = dst.initialize(model=model, config=dict(CONFIG), device="cpu")
    losses = []
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, TINY["vocab_size"], (8, 16)).astype(np.int32)
        losses.append((float(jengine.train_batch({"input_ids": ids})),
                       tengine.train_batch({"input_ids": ids}).item()))
    return dict(jengine=jengine, tengine=tengine, jcfg=jcfg, tcfg=tcfg, losses=losses)


def test_gpt2_moe_trajectory_matches_jax(trained):
    for want, got in trained["losses"]:
        assert abs(got - want) <= 1e-5
    assert trained["tengine"].global_steps == trained["jengine"].global_steps == 3
    assert set(trained["tengine"].state.params) == set(gpt2_moe_params_from_jax(
        jax.device_get(trained["jengine"].state.params), trained["tcfg"]))


def test_convert_training_model_matches_jax(trained):
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jax.device_get(trained["jengine"].state.params))
    jscfg, jserve = jax_convert_training_model(trained["jcfg"], jparams)
    tcfg = trained["tcfg"]
    scfg, sd = convert_training_model(tcfg, gpt2_moe_params_from_jax(jparams, tcfg))
    for field in ("vocab_size", "max_seq_len", "n_embd", "n_layer", "n_head", "num_experts",
                  "moe_layer_interval", "moe_top_k", "pos_emb", "name"):
        assert getattr(scfg, field) == getattr(jscfg, field), field
    assert scfg.ln_eps == 1e-6
    want = causal_lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jserve), scfg)
    assert set(sd) == set(want)
    for name, x in sd.items():
        assert torch.equal(x, want[name]), name


def test_served_logits_equal_the_training_forward(trained):
    tengine, tcfg = trained["tengine"], trained["tcfg"]
    params = {k: p.detach() for k, p in tengine.state.params.items()}
    scfg, sd = convert_training_model(tcfg, params)
    engine = dst.init_inference((scfg, sd), {"dtype": "float32"}, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 16)))
    want = gpt2_moe.gpt2_moe_model(tcfg).apply_fn(params, {"input_ids": ids})
    np.testing.assert_allclose(engine.forward(ids).numpy(), want.numpy(), atol=1e-5, rtol=0)
    aux, counts = gpt2_moe.moe_stats(tcfg, params, {"input_ids": ids})
    assert len(counts) == 1 and float(counts[0].sum()) == 32 and float(aux) > 0
    tokens = engine.generate(ids[:, :8].numpy(), max_new_tokens=4)
    assert tokens.shape == (2, 12)


def test_apply_fn_is_deterministic_as_jax(trained):
    """``apply_fn`` ignores its ``rng`` (JAX's runs ``deterministic=True``):
    with dropout and RSample noise configured and a key given, the logits
    equal the keyless forward's exactly and JAX's within 1e-5."""
    kw = dict(dataclasses.asdict(trained["tcfg"]), dropout=0.5, noisy_gate_policy="RSample",
              capacity_factor=1.0)
    tcfg = gpt2_moe.GPT2MoEConfig(**kw)
    jcfg = dataclasses.replace(trained["jcfg"], dropout=0.5, noisy_gate_policy="RSample",
                               capacity_factor=1.0)
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(trained["jengine"].state.params))
    params = gpt2_moe_params_from_jax(jparams, tcfg)
    ids = np.random.default_rng(7).integers(0, TINY["vocab_size"], (2, 16)).astype(np.int32)
    model = gpt2_moe.gpt2_moe_model(tcfg)
    batch = {"input_ids": torch.from_numpy(ids)}
    keyed = model.apply_fn(params, batch, rng=dst.runtime.rng.root_key(11))
    assert torch.equal(keyed, model.apply_fn(params, batch))
    japply = jax.jit(jax_gpt2_moe.gpt2_moe_model(jcfg).apply_fn)
    want = japply(jparams, {"input_ids": ids}, jax.random.PRNGKey(11))
    np.testing.assert_allclose(keyed.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_moe_config_refuses_what_jax_does_not_read():
    for kw in ({"remat": True}, {"vocab_chunk": 16}):
        with pytest.raises(ValueError, match="reads neither remat nor vocab_chunk"):
            gpt2_moe.GPT2MoEConfig(**TINY, **kw)
    cfg = gpt2_moe.GPT2MoEConfig(**TINY, use_residual=True)
    with pytest.raises(NotImplementedError, match="residual-MoE"):
        convert_training_model(cfg, gpt2_moe.gpt2_moe_model(cfg).init(0, "cpu"))
