"""The port's CausalLM against the JAX package's, on the CPU.

One flax parameter tree, every leaf redrawn from a seeded numpy generator (so
zero-initialised biases and unit norm scales are tested too), goes into the
JAX model as it is and into the port through ``causal_lm_params_from_jax``.
fp32, atol 1e-4, for each family config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
ATOL = 1e-4
CONFIGS = [("gpt2", {}), ("bloom", {}), ("opt", {}), ("llama", {}), ("gpt_neox", {}),
           ("gptj", {}), ("llama", {"n_kv_head": 2})]
IDS = [f"{fam}{'-gqa' if extra else ''}" for fam, extra in CONFIGS]


def _models(family, extra, seed=0):
    jcfg = jax_lm.FAMILIES[family](**TINY, **extra, dtype=jnp.float32)
    tcfg = torch_lm.FAMILIES[family](**TINY, **extra, dtype=torch.float32)
    shapes = jax.eval_shape(jax_lm.CausalLM(jcfg).init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):                  # norm scales around 1, all else around 0
        centre = 1.0 if path[-1].key == "scale" else 0.0
        return (centre + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    model = torch_lm.CausalLM(tcfg, device="cpu")
    model.load_state_dict(causal_lm_params_from_jax(params, tcfg))
    model.requires_grad_(False)
    return jcfg, params, model


def _ids(seed, b=2, t=8):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("family,extra", CONFIGS, ids=IDS)
def test_forward_logits_match_jax(family, extra):
    jcfg, params, model = _models(family, extra)
    ids = _ids(1)
    ref = jax_lm.CausalLM(jcfg).apply({"params": params}, jnp.asarray(ids))
    out = model(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("family,extra", CONFIGS, ids=IDS)
def test_prefill_and_decode_step_match_jax(family, extra):
    """Prefill over right-padded prompts (logits at each row's last valid
    token, K/V into the cache), then one decode step at each row's length."""
    jcfg, params, model = _models(family, extra)
    ids = _ids(2)
    lens = np.array([8, 5], np.int32)
    cap = 16
    module = jax_lm.CausalLM(jcfg)
    jl, jcache = module.apply({"params": params}, jnp.asarray(ids),
                              caches=jax_lm.init_cache(jcfg, 2, cap),
                              cache_lens=jnp.zeros(2, jnp.int32),
                              logits_positions=jnp.asarray(lens - 1))
    tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None].astype(np.int32)
    jl2, _ = module.apply({"params": params}, jnp.asarray(tok),
                          positions=jnp.asarray(lens)[:, None], caches=jcache,
                          cache_lens=jnp.asarray(lens))

    caches = torch_lm.init_cache(model.cfg, 2, cap, device="cpu")
    tl, _ = model(torch.from_numpy(ids), caches=caches,
                  cache_lens=torch.zeros(2, dtype=torch.int32),
                  logits_positions=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tlens = torch.from_numpy(lens)
    tl2, _ = model(torch.from_numpy(tok), positions=tlens[:, None], caches=caches,
                   cache_lens=tlens)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)


def test_cache_update_clamps_past_capacity():
    """A write at or past capacity lands on the last row, as
    ``dynamic_update_slice`` clamps, and nothing out of bounds."""
    cache = torch.zeros(2, 1, 4, 3)
    new = torch.ones(2, 1, 1, 3)
    torch_lm.cache_update(cache, new, torch.tensor([1, 9], dtype=torch.int32))
    assert cache[0, 0, 1].eq(1).all() and cache[1, 0, 3].eq(1).all()
    assert float(cache.sum()) == 6.0


def test_refused_model_features():
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        torch_lm.CausalLM(torch_lm.gpt2_cfg(**TINY, num_experts=4), device="cpu")
    model = torch_lm.CausalLM(torch_lm.gpt2_cfg(**TINY), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        model(ids, prefix_fill=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        model(ids, page_table=torch.zeros(1, 2, dtype=torch.int32))
