"""The port's inference engine against the JAX package's, on the CPU.

Greedy ``generate`` must give the JAX engine's tokens exactly (fp32, same
weights through ``causal_lm_params_from_jax``), ragged prompts and a firing
EOS included. Sampling is checked within the port only: JAX's threefry keys and
torch's Philox generator give different numbers for one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu.models.encoder import EncoderConfig
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax

TINY = dict(vocab_size=96, max_seq_len=64, n_embd=32, n_layer=2, n_head=4)
CONFIG = {"dtype": "float32", "max_out_tokens": 64}
N_NEW = 6


def _engines(family, extra):
    jcfg = jax_lm.FAMILIES[family](**TINY, **extra, dtype=jnp.float32)
    jeng = JaxInferenceEngine(jcfg, JaxInferenceConfig(**CONFIG))
    params = jax.device_get(jeng.params)
    tcfg = torch_lm.FAMILIES[family](**TINY, **extra, dtype=torch.float32)
    teng = dst.init_inference((tcfg, causal_lm_params_from_jax(params, tcfg)), dict(CONFIG),
                              device="cpu")
    return jeng, teng


@pytest.mark.parametrize("family,extra", [("gpt2", {}), ("bloom", {}),
                                          ("llama", {"n_kv_head": 2})],
                         ids=["gpt2", "bloom", "llama-gqa"])
def test_greedy_generate_matches_jax(family, extra):
    jeng, teng = _engines(family, extra)
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], (3, 8)).astype(np.int32)
    lens = [8, 5, 3]
    ref = jeng.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens)
    out = teng.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens)
    np.testing.assert_array_equal(out, ref)
    assert teng.ttft > 0 and teng.tpot > 0 and teng.decode_tps > 0

    # an EOS that fires: row 0's third new token
    eos = int(ref[0, 8 + 2])
    ref = jeng.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens, eos_token_id=eos)
    out = teng.generate(ids, max_new_tokens=N_NEW, prompt_lengths=lens, eos_token_id=eos)
    np.testing.assert_array_equal(out, ref)
    assert (out[0, 8 + 2:] == eos).all()


def test_sampling_is_seeded_and_top_k_1_is_greedy():
    eng = dst.init_inference(torch_lm.gpt2_cfg(**TINY), dict(CONFIG), device="cpu")
    ids = np.random.default_rng(6).integers(0, TINY["vocab_size"], (2, 8))
    kw = dict(max_new_tokens=N_NEW, do_sample=True, temperature=1.5, top_p=0.9)
    a = eng.generate(ids, seed=3, **kw)
    np.testing.assert_array_equal(a, eng.generate(ids, seed=3, **kw))
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=N_NEW, do_sample=True, top_k=1, seed=4),
        eng.generate(ids, max_new_tokens=N_NEW))


@pytest.mark.parametrize("config,match", [
    ({"tensor_parallel": {"tp_size": 2}}, "queue 1 item 11"),
    ({"mp_size": 2}, "queue 1 item 11"),
    ({"data_parallel": 2}, "queue 1 item 11"),
    ({"comm_overlap": {"enabled": True}}, "queue 1 item 11"),
    # weight quantization is served; what it still refuses: a width other
    # than 8 or 4 and a group below 1 (ValueError), and the legacy quant
    # block at any width but 8 (NotImplementedError, as in the JAX package)
    ({"weight_quant": {"enabled": True, "bits": 3}}, "bits=3 not in"),
    ({"quant": {"enabled": True, "bits": 4}}, "legacy quant block is 8-bit"),
    ({"weight_quant": {"enabled": True, "group": 0}}, "group=0 must be"),
    # MoE serving is ported (queue 1 item 10); an impl outside ("pallas", "xla")
    # is a ValueError, as in the JAX engine
    ({"moe_decode_impl": "triton"}, "moe_decode_impl='triton' is not one of"),
    ({"checkpoint": "/ckpt"}, "queue 1 item 12"),
    ({"enable_cuda_graph": True}, "queue 1 item 3"),
])
def test_refused_configs_raise(config, match):
    error = ValueError if {"weight_quant", "moe_decode_impl"} & set(config) \
        else NotImplementedError
    with pytest.raises(error, match=match):
        dst.init_inference(torch_lm.gpt2_cfg(**TINY), config, device="cpu")


def test_unknown_config_keys_raise():
    with pytest.raises(ValueError, match="unknown"):
        dst.init_inference(torch_lm.gpt2_cfg(**TINY), {"dtyp": "float32"}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        dst.init_inference(torch_lm.gpt2_cfg(**TINY), {"tensor_parallel": {"size": 1}},
                           device="cpu")


def test_refused_models_and_beams():
    # MoE serving is ported; MoE training (the layer and experts modules) is not
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        from deepspeed_tpu_torch.moe import MoE  # noqa: F401
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        dst.init_inference(torch.nn.Linear(2, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        dst.init_inference(EncoderConfig(), device="cpu")
    eng = dst.init_inference(torch_lm.gpt2_cfg(**TINY), dict(CONFIG), device="cpu")
    with pytest.raises(NotImplementedError, match="num_beams"):
        eng.generate(np.zeros((1, 4), np.int64), num_beams=2)


def test_no_device_and_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dst.init_inference(torch_lm.gpt2_cfg(**TINY), dict(CONFIG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    assert get_accelerator().device_name(0) == "cuda:0"
    assert get_accelerator().device() == torch.device("cuda", 0)
    assert get_accelerator().is_available() == torch.cuda.is_available()
