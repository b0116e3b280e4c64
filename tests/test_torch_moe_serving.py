"""MoE serving in the port against the JAX package's, on the CPU.

The same weights (``causal_lm_params_from_jax`` of a JAX engine's tree) serve
the same prompts through ``InferenceEngine.generate`` and the port's, f32 on
the CPU, with every 2nd FFN a mixture of 4 experts: greedy tokens must equal
JAX's exactly for both ``moe_decode_impl`` spellings ("pallas": JAX's
interpret-mode kernel, the port's K7 wrapper on its plain version; "xla": the
gather path in both), top-1 and top-2, and for the port's scheduler against
its own ``generate`` and JAX's scheduler. Weight quantization of the expert
stacks is exact: the audit, the payload and scale bytes of every quantized
matrix (3-D expert stacks included) and the modeled weight-stream bytes must
equal JAX's; logits within 1e-4 (the port's model tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.inference.serving import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.models import causal_lm as jax_lm
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler,
                                                   PrefixCacheConfig, ServingConfig)
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quantizer import is_quant_node

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4, num_experts=4)
CAP = 48
MODELS = {"gpt2-top1": ("gpt2", {}), "gpt2-top2": ("gpt2", {"moe_top_k": 2}),
          "llama-gqa-top1": ("llama", {"n_kv_head": 2})}
WQ = {8: {"enabled": True, "bits": 8}, 4: {"enabled": True, "bits": 4, "group": 16}}


@pytest.fixture
def force_fused(monkeypatch):
    """The JAX engine keeps quant nodes in its tree on the CPU, so its MoE
    decode takes the quantized-expert path the port takes."""
    monkeypatch.setenv("DS_TPU_WQ_FORCE_FUSED", "1")


def _engines(name, impl=None, wq=None, dtype="float32"):
    family, extra = MODELS[name]
    jcfg = jax_lm.FAMILIES[family](**TINY, **extra, dtype=jnp.float32)
    fp = JaxInferenceEngine(jcfg, JaxInferenceConfig(dtype="float32", max_out_tokens=CAP))
    raw = jax.tree_util.tree_map(np.asarray, jax.device_get(fp.params))
    conf = {"dtype": dtype, "max_out_tokens": CAP}
    if impl is not None:
        conf["moe_decode_impl"] = impl
    if wq is not None:
        conf["weight_quant"] = dict(wq)
    jeng = JaxInferenceEngine((jcfg, raw), JaxInferenceConfig(**conf))
    tcfg = torch_lm.FAMILIES[family](**TINY, **extra)
    teng = dst.init_inference((tcfg, causal_lm_params_from_jax(raw, tcfg)), conf, device="cpu")
    return jeng, teng


def _prompts(seed, b=3, t=8):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("name,impl", [("gpt2-top1", "pallas"), ("gpt2-top1", "xla"),
                                       ("gpt2-top2", "pallas"), ("llama-gqa-top1", "xla")])
def test_generate_matches_jax(name, impl):
    jeng, teng = _engines(name, impl)
    assert teng.model_config.moe_decode_impl == impl
    ids, lens = _prompts(1), [8, 5, 3]
    op_builder.reset_launch_counts()
    got = teng.generate(ids, max_new_tokens=8, prompt_lengths=lens)
    assert op_builder.launch_counts()["moe_decode_ffn"] == 0          # CPU: plain
    np.testing.assert_array_equal(got, jeng.generate(ids, max_new_tokens=8,
                                                     prompt_lengths=lens))


def _serving(cls, cache_cls):
    return cls(slots=2, chunk_size=3, max_seq_len=CAP, retry_base_delay=0.001,
               kv_pool="paged", kv_page_size=8,
               prefix_cache=cache_cls(min_hit_tokens=4, min_insert_tokens=4,
                                      insert_on="prefill"))


def test_scheduler_matches_generate_and_jax():
    """The scheduler (paged pool, prefix cache) on an MoE engine: a miss, an
    aligned hit, an unaligned (COW) hit and two more misses give the port's
    own ``generate``'s greedy tokens and the JAX scheduler's."""
    jeng, teng = _engines("gpt2-top1")
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 96, size=16).astype(np.int32)

    def tail(n):
        return rng.integers(0, 96, size=n).astype(np.int32)

    prompts = [np.concatenate([shared, tail(4)]), np.concatenate([shared, tail(6)]),
               np.concatenate([shared[:13], tail(5)]), tail(9), tail(30)]
    budgets = [8, 6, 7, 5, 10]
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig))
    th = [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    snap = sched.run()
    assert [h.prefix_hit_tokens for h in th] == [0, 16, 13, 0, 0]
    assert snap["completed"] == len(prompts)
    jsched = JaxScheduler(jeng, _serving(JaxServingConfig, JaxPrefixCacheConfig))
    jh = [jsched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    jsched.run()
    for h, j, p, m in zip(th, jh, prompts, budgets):
        np.testing.assert_array_equal(h.result(),
                                      teng.generate(p[None], max_new_tokens=m)[0, p.size:])
        np.testing.assert_array_equal(h.result(), j.result())


def _jax_nodes(jeng):
    out = {}
    for lk, layer in jeng.params.items():
        if not lk.startswith("layers_"):
            continue
        for name, node in layer.items():
            if name == "moe_experts":
                out.update({f"{lk}/moe_experts/{w}": node[w] for w in ("w1", "w2")
                            if is_quant_node(node[w])})
            elif isinstance(node, dict) and is_quant_node(node.get("kernel")):
                out[f"{lk}/{name}/kernel"] = node["kernel"]
    return out


def _port_nodes(teng):
    out = {}
    for i, layer in enumerate(teng.module.layers):
        for name in torch_lm.QUANT_NAMES:
            mod = getattr(layer, name, None)
            if isinstance(mod, torch_lm.QuantDense):
                out[f"layers_{i}/{name}/kernel"] = mod.node()
        experts = getattr(layer, "moe_experts", None)
        for w in ("w1", "w2"):
            mod = getattr(experts, w, None)
            if isinstance(mod, torch_lm.QuantNode):
                out[f"layers_{i}/moe_experts/{w}"] = mod.node()
    return out


def _assert_same_nodes(jnodes, tnodes):
    assert sorted(tnodes) == sorted(jnodes) and tnodes
    for path, jn in jnodes.items():
        tn = tnodes[path]
        assert set(tn) == set(jn), path
        for key, v in jn.items():
            a, b = np.asarray(v), tn[key].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (path, key)


def _assert_same_audit(jaudit, taudit):
    jby, tby = {e["name"]: e for e in jaudit}, {e["name"]: e for e in taudit}
    assert sorted(tby) == sorted(jby) and len(taudit) == len(jaudit)
    for name, je in jby.items():
        te = tby[name]
        for key in ("decision", "reason", "bits", "group_requested", "group_effective"):
            assert te[key] == je[key], (name, key)
        assert (te["rel_err"] is None) == (je["rel_err"] is None)
        if je["rel_err"] is not None:
            assert abs(te["rel_err"] - je["rel_err"]) <= 1e-6, name


def _assert_same_report(jrep, trep):
    for key in ("quantized_bytes", "quantized_bf16_equiv", "fp_bytes", "modeled_step_bytes",
                "bf16_equiv_step_bytes"):
        assert trep[key] == jrep[key], key
    for key in ("reduction_total", "reduction_quantized_nodes"):
        assert trep[key] == pytest.approx(jrep[key], rel=1e-12), key


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_experts_match_jax(bits, force_fused):
    """``weight_quant`` quantizes the projections and both expert stacks of
    every MoE layer (grouped per expert along axis -2) byte for byte as JAX
    does; prefill dequantizes the stacks, a decode step gathers the selected
    experts' payloads, so K7 never runs; logits and greedy tokens as JAX's."""
    jeng, teng = _engines("gpt2-top2", wq=WQ[bits])
    _assert_same_audit(jeng.quant_audit, teng.quant_audit)
    names = [e["name"] for e in teng.quant_audit]
    assert "layers_1/moe_experts/w1" in names and "layers_1/moe_experts/w2" in names
    assert all(e["decision"] == "quantized" for e in teng.quant_audit)
    _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
    _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())

    ids, lens = _prompts(7), [8, 5, 3]
    np.testing.assert_allclose(teng.forward(ids).numpy(), np.asarray(jeng(ids)), atol=1e-4,
                               rtol=0)
    op_builder.reset_launch_counts()
    got = teng.generate(ids, max_new_tokens=6, prompt_lengths=lens)
    assert op_builder.launch_counts()["moe_decode_ffn"] == 0
    np.testing.assert_array_equal(got, jeng.generate(ids, max_new_tokens=6,
                                                     prompt_lengths=lens))


def test_exclude_keeps_expert_stacks_fp(force_fused):
    """``weight_quant.exclude`` matches the expert paths as JAX's does."""
    wq = {"enabled": True, "bits": 8, "exclude": ["moe_experts/w2"]}
    jeng, teng = _engines("gpt2-top1", wq=wq)
    _assert_same_audit(jeng.quant_audit, teng.quant_audit)
    experts = teng.module.layers[1].moe_experts
    assert isinstance(experts.w1, torch_lm.QuantNode)
    assert isinstance(experts.w2, torch.nn.Parameter)
    _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
    _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_jax_quantized_moe_tree_converts_unchanged(bits, force_fused):
    """A JAX engine's quantized MoE tree (3-D expert quant nodes) through
    ``convert.py`` serves the same logits: payloads and scales arrive as
    they are, with nothing left to quantize."""
    jeng, _ = _engines("gpt2-top1", wq=WQ[bits])
    tcfg = torch_lm.gpt2_cfg(**TINY)
    sd = causal_lm_params_from_jax(jax.device_get(jeng.params), tcfg)
    assert f"layers.1.moe_experts.w1.int{bits}_q" in sd
    assert "layers.1.moe_experts.w1" not in sd and "layers.1.moe_gate" in sd
    teng = dst.init_inference((tcfg, sd), {"dtype": "float32", "max_out_tokens": CAP,
                                           "weight_quant": dict(WQ[bits])}, device="cpu")
    assert teng.quant_audit == []
    _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
    _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())
    ids = _prompts(9, b=2)
    np.testing.assert_allclose(teng.forward(ids).numpy(), np.asarray(jeng(ids)), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("impl", ["triton", "XLA", "Pallas"])
def test_unknown_moe_decode_impl_raises(impl):
    """An impl outside ("pallas", "xla"), case-sensitive, fails at
    construction with ``ValueError`` in both packages."""
    cfg = torch_lm.gpt2_cfg(**TINY)
    with pytest.raises(ValueError, match=f"moe_decode_impl={impl!r}"):
        dst.init_inference(cfg, {"dtype": "float32", "moe_decode_impl": impl}, device="cpu")
    with pytest.raises(ValueError, match="moe_decode_impl"):
        JaxInferenceEngine(jax_lm.gpt2_cfg(**TINY),
                           JaxInferenceConfig(dtype="float32", moe_decode_impl=impl))
