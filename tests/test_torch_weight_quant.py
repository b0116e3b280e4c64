"""Weight-quantized serving in the port against the JAX package's, on the CPU.

The same fp weights (``causal_lm_params_from_jax``) go into a JAX engine and a
port engine with one ``weight_quant`` block, f32 compute. The JAX engine runs
its fused (interpret-mode) kernel path (``DS_TPU_WQ_FORCE_FUSED=1``); the
port runs the dequant-GEMM's plain version (CPU tensors). In f32 the kernel's
rounding of w to x's dtype is the identity, so the two compute the same
products and differ only in the order of f32 sums: logits within 1e-4 (the
port's model tolerance), greedy tokens equal. Quantization itself is exact:
the audit decisions, the payload bytes of every projection and the modeled
weight-stream bytes must equal JAX's.
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
from deepspeed_tpu.ops.quantizer import fused_matmul as jfm
from deepspeed_tpu.ops.quantizer import quant as jq
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler,
                                                   PrefixCacheConfig, ServingConfig)
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.kernel_checks import QMM_TOLERANCES
from deepspeed_tpu_torch.ops.quantizer import is_quant_node, quant_dense_apply

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
CAP = 48
FAMILIES = {"gpt2": ("gpt2", {}), "llama-gqa": ("llama", {"n_kv_head": 2}),
            "bloom-alibi": ("bloom", {})}
# int8 at the default group (128 degrades to 32 on the 32-wide projections),
# int4 at group 16: two or more groups in every projection
WQ = {8: {"enabled": True, "bits": 8}, 4: {"enabled": True, "bits": 4, "group": 16}}


@pytest.fixture
def force_fused(monkeypatch):
    monkeypatch.setenv("DS_TPU_WQ_FORCE_FUSED", "1")


def _fp_params(family, extra):
    jcfg = jax_lm.FAMILIES[family](**TINY, **extra, dtype=jnp.float32)
    jeng = JaxInferenceEngine(jcfg, JaxInferenceConfig(dtype="float32", max_out_tokens=CAP))
    return jcfg, jax.tree_util.tree_map(np.asarray, jax.device_get(jeng.params))


def _quant_engines(name, wq, dtype="float32"):
    family, extra = FAMILIES[name]
    jcfg, raw = _fp_params(family, extra)
    jeng = JaxInferenceEngine((jcfg, raw), JaxInferenceConfig(
        dtype=dtype, max_out_tokens=CAP, weight_quant=dict(wq)))
    tcfg = torch_lm.FAMILIES[family](**TINY, **extra)
    teng = dst.init_inference((tcfg, causal_lm_params_from_jax(raw, tcfg)),
                              {"dtype": dtype, "max_out_tokens": CAP, "weight_quant": dict(wq)},
                              device="cpu")
    return jeng, teng


def _jax_nodes(jeng):
    return {f"{lk}/{name}/kernel": node["kernel"] for lk, layer in jeng.params.items()
            if lk.startswith("layers_") for name, node in layer.items()
            if isinstance(node, dict) and is_quant_node(node.get("kernel"))}


def _port_nodes(teng):
    return {f"layers_{i}/{name}/kernel": mod.node() for i, layer in enumerate(teng.module.layers)
            for name in torch_lm.QUANT_NAMES
            if isinstance(mod := getattr(layer, name, None), torch_lm.QuantDense)}


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
        for key in ("decision", "bits", "group_requested", "group_effective"):
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
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_quantized_engine_matches_jax(name, bits, force_fused):
    jeng, teng = _quant_engines(name, WQ[bits])
    _assert_same_audit(jeng.quant_audit, teng.quant_audit)
    assert all(e["decision"] == "quantized" for e in teng.quant_audit)
    _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
    _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())

    ids = np.random.default_rng(7).integers(0, TINY["vocab_size"], (3, 8)).astype(np.int32)
    op_builder.reset_launch_counts()
    logits = teng.forward(ids)
    assert op_builder.launch_counts()["quantized_matmul"] == 0          # CPU: plain
    np.testing.assert_allclose(logits.numpy(), np.asarray(jeng(ids)), atol=1e-4, rtol=0)
    lens = [8, 5, 3]
    np.testing.assert_array_equal(teng.generate(ids, max_new_tokens=6, prompt_lengths=lens),
                                  jeng.generate(ids, max_new_tokens=6, prompt_lengths=lens))


def test_audit_outlier_and_exclude_match_jax(force_fused):
    """An outlier-heavy matrix and an ``exclude``-listed path stay fp, with
    the JAX engine's decisions, reasons and names."""
    jcfg, raw = _fp_params("gpt2", {})
    raw["layers_0"]["fc_in"]["kernel"] = raw["layers_0"]["fc_in"]["kernel"].copy()
    raw["layers_0"]["fc_in"]["kernel"][0, :16] = 1e4
    wq = {"enabled": True, "bits": 8, "exclude": ["layers_1/o_proj"]}
    jeng = JaxInferenceEngine((jcfg, raw), JaxInferenceConfig(
        dtype="float32", max_out_tokens=CAP, weight_quant=wq))
    tcfg = torch_lm.gpt2_cfg(**TINY)
    teng = dst.init_inference((tcfg, causal_lm_params_from_jax(raw, tcfg)),
                              {"dtype": "float32", "max_out_tokens": CAP, "weight_quant": wq},
                              device="cpu")
    _assert_same_audit(jeng.quant_audit, teng.quant_audit)
    by_name = {e["name"]: e for e in teng.quant_audit}
    spiked = by_name["layers_0/fc_in/kernel"]
    assert spiked["decision"] == "excluded" and "outlier" in spiked["reason"]
    excl = by_name["layers_1/o_proj/kernel"]
    assert excl["decision"] == "excluded" and excl["reason"] == "weight_quant.exclude match"
    assert isinstance(teng.module.layers[0].fc_in, torch_lm.Dense)
    assert isinstance(teng.module.layers[1].o_proj, torch_lm.Dense)
    assert isinstance(teng.module.layers[0].q_proj, torch_lm.QuantDense)
    _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
    _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())
    ids = np.random.default_rng(8).integers(0, TINY["vocab_size"], (2, 8)).astype(np.int32)
    np.testing.assert_allclose(teng.forward(ids).numpy(), np.asarray(jeng(ids)), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_jax_quantized_tree_converts_unchanged(bits, force_fused):
    """A JAX engine's quantized tree, through ``convert.py``, serves the same
    logits: payloads and scales arrive as they are (no transpose, no
    re-quantization), with or without ``weight_quant`` on the port's side."""
    jeng, _ = _quant_engines("llama-gqa", WQ[bits])
    tcfg = torch_lm.llama_cfg(**TINY, n_kv_head=2)
    sd = causal_lm_params_from_jax(jax.device_get(jeng.params), tcfg)
    assert f"layers.0.q_proj.int{bits}_q" in sd and "layers.0.q_proj.weight" not in sd
    ids = np.random.default_rng(9).integers(0, TINY["vocab_size"], (2, 8)).astype(np.int32)
    ref = np.asarray(jeng(ids))
    for extra in ({}, {"weight_quant": dict(WQ[bits])}):
        teng = dst.init_inference((tcfg, dict(sd)), {"dtype": "float32", "max_out_tokens": CAP,
                                                     **extra}, device="cpu")
        assert teng.quant_audit == []                       # nothing left to quantize
        _assert_same_nodes(_jax_nodes(jeng), _port_nodes(teng))
        _assert_same_report(jeng.weight_stream_report(), teng.weight_stream_report())
        np.testing.assert_allclose(teng.forward(ids).numpy(), ref, atol=1e-4, rtol=0)


def test_legacy_spellings_resolve_to_int8():
    """``dtype="int8"`` (bf16 compute) and the ``quant`` block serve as
    ``weight_quant`` at 8 bits, as in the JAX package."""
    cfg = torch_lm.gpt2_cfg(**TINY)
    base = dst.init_inference(cfg, {"dtype": "bfloat16", "max_out_tokens": CAP,
                                    "weight_quant": {"enabled": True, "bits": 8}}, device="cpu")
    ids = np.random.default_rng(10).integers(0, TINY["vocab_size"], (2, 8))
    want = base.generate(ids, max_new_tokens=5)
    for config in ({"dtype": "int8"}, {"dtype": "bfloat16", "quant": {"enabled": True}}):
        eng = dst.init_inference(cfg, {**config, "max_out_tokens": CAP}, device="cpu")
        wq = eng._config.resolved_weight_quant()
        assert eng.dtype == torch.bfloat16 and eng._config.is_int8()
        assert wq.enabled and wq.bits == 8
        assert eng.quant_audit == base.quant_audit
        assert isinstance(eng.module.layers[0].q_proj, torch_lm.QuantDense)
        assert not isinstance(eng.module.wte, torch_lm.QuantDense)
        np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=5), want)
    jcfg = JaxInferenceConfig(dtype="int8")
    assert jcfg.resolved_weight_quant().bits == 8


def _serving(cls, cache_cls):
    return cls(slots=2, chunk_size=3, max_seq_len=CAP, retry_base_delay=0.001,
               kv_pool="paged", kv_page_size=8,
               prefix_cache=cache_cls(min_hit_tokens=4, min_insert_tokens=4,
                                      insert_on="prefill"))


def test_int8_scheduler_matches_jax_and_generate(force_fused):
    """An int8 gpt2 engine behind ``ContinuousBatchingScheduler`` (paged pool,
    prefix cache): a miss, an aligned hit, an unaligned (COW) hit and two
    more misses give the JAX scheduler's greedy tokens and the port's own
    ``generate``'s."""
    jeng, teng = _quant_engines("gpt2", WQ[8])
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 96, size=16).astype(np.int32)

    def tail(n):
        return rng.integers(0, 96, size=n).astype(np.int32)

    prompts = [np.concatenate([shared, tail(4)]), np.concatenate([shared, tail(6)]),
               np.concatenate([shared[:13], tail(5)]), tail(9), tail(30)]
    budgets = [8, 6, 7, 5, 10]
    jsched = JaxScheduler(jeng, _serving(JaxServingConfig, JaxPrefixCacheConfig))
    jh = [jsched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    jsched.run()
    sched = ContinuousBatchingScheduler(teng, _serving(ServingConfig, PrefixCacheConfig))
    th = [sched.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
    snap = sched.run()
    assert [h.prefix_hit_tokens for h in th] == [0, 16, 13, 0, 0]
    assert snap["completed"] == len(prompts)
    for h, j, p, m in zip(th, jh, prompts, budgets):
        np.testing.assert_array_equal(h.result(), j.result())
        np.testing.assert_array_equal(h.result(),
                                      teng.generate(p[None], max_new_tokens=m)[0, p.size:])


@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quant_dense_apply_matches_jax(bits, dtype, with_bias, force_fused):
    """``quant_dense_apply`` (the port's projection, which hands its bias to
    the dequant-GEMM's epilogue on the card) against the JAX package's, on one
    seeded numpy weight, activation and f32 bias, (b, t, k) activations, group
    64 (two groups). Both round each dequantized weight to the dtype, take f32
    products, round the product to the dtype and add the bias rounded to the
    dtype; they differ only in the f32 sum's order. f32: atol 1e-4, rtol 1e-5
    (sums of 128 terms in other orders). bf16: the product's limit, one ulp of
    the value plus 1e-3 (``QMM_TOLERANCES``), taken of |product| + |bias|,
    since one ulp of the product before the bias is added is the most a flip of
    its rounding moves the sum."""
    rng = np.random.default_rng(21 + bits)
    k, n = 128, 48
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    node_j, _ = jq.quantize_with_audit(w, bits=bits, group_size=64, threshold=1.0, name="w")
    node_t = {key: torch.from_numpy(np.array(v)) for key, v in node_j.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_j = jfm.quant_dense_apply(jnp.asarray(x, jdt), node_j,
                                None if bias is None else jnp.asarray(bias), jdt)
    y_t = quant_dense_apply(torch.from_numpy(x).to(tdt), node_t,
                            None if bias is None else torch.from_numpy(bias), tdt)
    assert y_t.dtype == tdt and tuple(y_t.shape) == (2, 5, n)
    ref = np.asarray(y_j.astype(jnp.float32))
    prod = np.asarray(jfm.quant_dense_apply(jnp.asarray(x, jdt), node_j, None, jdt)
                      .astype(jnp.float32))
    atol, rtol = (1e-4, 1e-5) if dtype == "float32" else QMM_TOLERANCES[torch.bfloat16]
    scale = np.abs(prod) + (0 if bias is None else np.abs(bias))
    err = np.abs(y_t.float().numpy() - ref)
    assert (err <= atol + rtol * scale).all(), float((err / (atol + rtol * scale)).max())
