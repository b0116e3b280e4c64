"""ZeRO-3 parameter offload (``offload_param``) against the JAX package's, on the CPU.

JAX's sizes (``tests/unit/runtime/test_param_offload.py``): vocab 64, seq 16,
width 32, 4 heads, 2-4 layers, f32, stage 3, AdamW lr 1e-2 with weight decay
0.01, clipping 1.0. The JAX engine shards each micro-batch over the 8 virtual
CPU devices (micro-batch 1 a device); the port takes the same 8 rows as one
micro-batch.

- Segments: the union of ``causal_lm_segments``' init keys is the resident
  model's parameter dict, names and shapes, tied or not; a tied ``wte`` is a
  parameter of the final segment, not one it makes.
- The port's streamed engine against JAX's streamed engine over 4 steps, both
  from JAX's initial masters (carried by ``causal_lm_params_from_jax`` into
  ``load_full_params``), at ``layers_per_group`` 1 and 2, gradient
  accumulation 1 and 2, tied and untied: every loss within rtol 2e-4, the
  final masters within rtol 2e-3 + atol 2e-4 (the limits of JAX's own
  ``test_matches_resident_engine``); the same against the port's resident
  engine.
- ``offload_param: nvme`` equal to ``cpu`` bit for bit (losses, masters,
  moments), over 3 steps and with gradient accumulation 2 (the on-disk
  accumulators read back); host memory under NVMe parameters below a quarter
  of the streamed 16 B a parameter.
- Checkpoints in RAM and NVMe modes: a round trip, then one more step bit for
  bit; ``load_optimizer_states=False`` restores the masters only.
- fp16: an overflow skips the step, leaves the masters and counts
  ``skipped_steps`` and the loss scale as JAX's engine does.
- Adagrad trains under ``cpu``; ``nvme`` refuses it. The guards, the
  ``cpu_offload_param`` alias, no resident state, the key stream.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import causal_lm as jax_lm
from deepspeed_tpu_torch.models import causal_lm as torch_lm
from deepspeed_tpu_torch.models import gpt2_model
from deepspeed_tpu_torch.models.base import Model, Segment
from deepspeed_tpu_torch.models.convert import causal_lm_params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.runtime import rng as rng_stream
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

VOCAB, SEQ = 64, 16
LOSS_RTOL = 2e-4                       # JAX's test_matches_resident_engine
MASTER_RTOL, MASTER_ATOL = 2e-3, 2e-4


def _jcfg(n_layer, tie=True):
    return jax_lm.CausalLMConfig(vocab_size=VOCAB, max_seq_len=32, n_embd=32, n_layer=n_layer,
                                 n_head=4, dtype=jnp.float32, tie_word_embeddings=tie,
                                 name="tiny")


def _tcfg(n_layer, tie=True):
    return torch_lm.CausalLMConfig(vocab_size=VOCAB, max_seq_len=32, n_embd=32,
                                   n_layer=n_layer, n_head=4, dtype=torch.float32,
                                   tie_word_embeddings=tie, name="tiny")


def _config(offload="cpu", gas=1, micro=8, nvme_path=None, fp16=False, optimizer="adamw",
            stage=3):
    zero = {"stage": stage}
    if offload == "nvme":
        zero["offload_param"] = {"device": "nvme", "nvme_path": nvme_path}
    elif offload is not None:
        zero["offload_param"] = {"device": offload}
    cfg = {"train_batch_size": 8 * gas, "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": optimizer, "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "zero_optimization": zero, "steps_per_print": 100}
    if fp16:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 40}
    return cfg


def _ids(seed, rows=8):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(rows, SEQ)).astype(np.int32)


def _port(cfg, config, layers_per_group=2, start=None, seed=42):
    """A port engine of ``causal_lm_model(cfg)``; a streamed one takes
    ``start`` through ``load_full_params``, a resident one as its init."""
    model = torch_lm.causal_lm_model(cfg, sample_seq_len=SEQ, layers_per_group=layers_per_group)
    streamed = "offload_param" in config["zero_optimization"]
    if start is not None and not streamed:
        model = dataclasses.replace(model, init_fn=lambda _, device: start)
    engine = DeepSpeedEngine(model=model, config=config, device="cpu", seed=seed)
    if start is not None and streamed:
        engine._param_offload.load_full_params(start)
    return engine


def _state(engine):
    sd = engine._param_offload.state_dict()
    return {f"{part}.{k}": v.clone() for part in ("masters", "m", "v") for k, v in
            sd[part].items()}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _assert_masters_close(got, want, what):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=MASTER_RTOL, atol=MASTER_ATOL, err_msg=f"{what}: {name}")


# ------------------------------------------------------------------ segments
@pytest.mark.parametrize("tie", [True, False])
def test_segment_union_is_the_resident_parameter_dict(tie):
    cfg = _tcfg(4, tie)
    model = torch_lm.causal_lm_model(cfg, layers_per_group=2)
    resident = model.init(0, "cpu")
    made = {}
    for si, seg in enumerate(model.segments):
        subs = seg.init_fn(rng_stream.fold_in(0, si), "cpu")
        assert len(subs) == len(seg.init_keys)
        for key, sub in zip(seg.init_keys, subs):
            assert sub and all(n == key or n.startswith(key + ".") for n in sub), key
            assert not set(sub) & set(made), key
            made.update(sub)
    assert list(made) == list(resident)
    assert all(made[n].shape == resident[n].shape and made[n].dtype == torch.float32
               for n in resident)
    # JAX's decomposition, key for key (layers_i is layers.i)
    jsegs = jax_lm.causal_lm_segments(_jcfg(4, tie), layers_per_group=2)
    for seg, jseg in zip(model.segments, jsegs):
        assert (seg.kind, seg.name) == (jseg.kind, jseg.name)
        assert seg.param_keys == tuple(k.replace("_", ".") if k.startswith("layers_") else k
                                       for k in jseg.param_keys)
    final = model.segments[-1]
    assert ("wte" in final.param_keys and "wte" not in final.init_keys) == tie


def test_segments_chain_to_the_resident_loss():
    cfg = torch_lm.bloom_cfg(vocab_size=VOCAB, max_seq_len=32, n_embd=32, n_layer=3, n_head=4,
                             dtype=torch.float32)
    model = torch_lm.causal_lm_model(cfg, layers_per_group=2)
    params = model.init(0, "cpu")
    batch = {"input_ids": torch.from_numpy(_ids(3)).long()}
    x = None
    for seg in model.segments:
        p = tuple({n: t for n, t in params.items() if n == k or n.startswith(k + ".")}
                  for k in seg.param_keys)
        x = seg.apply_fn(p, batch, 0) if seg.kind == "first" else seg.apply_fn(p, x, batch, 0)
    assert torch.equal(x, model.loss_fn(params, batch))


# ------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("layers_per_group,gas,tie", [(1, 1, True), (2, 2, True),
                                                      (2, 1, False), (1, 2, False)])
def test_streamed_matches_jax_and_resident(layers_per_group, gas, tie):
    jengine = ds.initialize(model=jax_lm.causal_lm_model(_jcfg(4, tie), sample_seq_len=SEQ,
                                                         layers_per_group=layers_per_group),
                            config=_config(gas=gas, micro=1))[0]
    tcfg = _tcfg(4, tie)

    def port_dict(tree):
        return causal_lm_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), tcfg)

    start = port_dict(jengine._param_offload.full_params_host())
    streamed = _port(tcfg, _config(gas=gas), layers_per_group, start)
    resident = _port(tcfg, _config(offload=None, gas=gas), layers_per_group, start)
    for step in range(4):
        ids = _ids(10 + step, 8 * gas)
        want = float(jengine.train_batch({"input_ids": ids}))
        got = streamed.train_batch({"input_ids": ids}).item()
        res = resident.train_batch({"input_ids": ids}).item()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"step {step} vs JAX")
        np.testing.assert_allclose(got, res, rtol=LOSS_RTOL, err_msg=f"step {step} vs resident")
    assert streamed.global_steps == jengine.global_steps == 4
    final = streamed._param_offload.full_params_host()
    _assert_masters_close(final, port_dict(jengine._param_offload.full_params_host()), "JAX")
    _assert_masters_close(final, {k: v.detach() for k, v in resident.state.params.items()},
                          "resident")
    assert streamed.state is None and streamed.optimizer is None


def test_fp16_overflow_skips_as_jax_does():
    jengine = ds.initialize(model=jax_lm.causal_lm_model(_jcfg(2), sample_seq_len=SEQ,
                                                         layers_per_group=1),
                            config=_config(micro=1, fp16=True))[0]
    start = causal_lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jengine._param_offload.full_params_host()), _tcfg(2))
    engine = _port(_tcfg(2), _config(fp16=True), 1, start)
    for step in range(2):
        jengine.train_batch({"input_ids": _ids(step)})
        engine.train_batch({"input_ids": _ids(step)})
        assert engine.skipped_steps == jengine.skipped_steps == step + 1
        assert engine.loss_scale() == jengine.loss_scale()
    assert engine._param_offload.step_count == 0
    got = engine._param_offload.full_params_host()
    assert all(torch.equal(got[k], start[k]) for k in start)


# ------------------------------------------------------------------ NVMe tier
@pytest.mark.parametrize("gas", [1, 2])
def test_nvme_equals_ram_bit_for_bit(gas, tmp_path):
    ram = _port(_tcfg(4), _config(gas=gas), 2)
    nvme = _port(_tcfg(4), _config("nvme", gas=gas, nvme_path=str(tmp_path / "swap")), 2)
    co = nvme._param_offload
    assert co.nvme_params and co.masters is None and co._accum is None and co.nvme is not None
    for step in range(3 if gas == 1 else 2):
        ids = _ids(20 + step, 8 * gas)
        assert torch.equal(ram.train_batch({"input_ids": ids}),
                           nvme.train_batch({"input_ids": ids})), step
    _assert_same_state(ram, nvme)


def test_host_ram_bounded_by_scratch(tmp_path):
    engine = _port(_tcfg(8), _config("nvme", nvme_path=str(tmp_path / "swap")), 1)
    co = engine._param_offload
    engine.train_batch({"input_ids": _ids(0)})
    streamed = co.total_params * 16          # masters, gradients, two moments
    assert co.host_bytes() < streamed / 4, (co.host_bytes(), streamed)
    assert co.host_bytes() == co.param_tier.scratch_bytes + sum(
        t.numel() * 4 for t in co.nvme._scratch)
    assert len(os.listdir(str(tmp_path / "swap"))) >= 2 * len(co.leaf_sizes)


def test_window_holds_two_segments():
    engine = _port(_tcfg(8), _config(), 1)
    engine.train_batch({"input_ids": _ids(0)})
    co = engine._param_offload
    seg_bytes = [4 * sum(co.leaf_sizes[i] for k in s.param_keys for i in co._leaf_index[k])
                 for s in co.segments]
    assert co.cache.peak_live_bytes == max(a + b for a, b in zip(seg_bytes, seg_bytes[1:]))
    assert co.cache.peak_live_bytes < 0.55 * 4 * co.total_params


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("mode", ["cpu", "nvme"])
def test_checkpoint_roundtrip_then_a_step_bit_for_bit(mode, tmp_path):
    def engine(seed, swap):
        return _port(_tcfg(2), _config(mode, nvme_path=str(tmp_path / swap)), 1, seed=seed)

    a = engine(42, "swap-a")
    for step in range(2):
        a.train_batch({"input_ids": _ids(step)})
    before = a.eval_batch({"input_ids": _ids(9)})
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="t1")
    b = engine(7, "swap-b")
    b.load_checkpoint(str(tmp_path / "ckpt"), tag="t1")
    assert b.global_steps == 2 and b.micro_steps == 2
    _assert_same_state(a, b)
    assert torch.equal(b.eval_batch({"input_ids": _ids(9)}), before)
    assert torch.equal(a.train_batch({"input_ids": _ids(2)}),
                       b.train_batch({"input_ids": _ids(2)}))
    _assert_same_state(a, b)


@pytest.mark.parametrize("mode", ["cpu", "nvme"])
def test_state_dict_round_trip(mode, tmp_path):
    a = _port(_tcfg(2), _config(mode, nvme_path=str(tmp_path / "a")), 1)
    a.train_batch({"input_ids": _ids(0)})
    b = _port(_tcfg(2), _config(mode, nvme_path=str(tmp_path / "b")), 1, seed=7)
    b._param_offload.load_state_dict(a._param_offload.state_dict())
    _assert_same_state(a, b)
    assert b._param_offload.step_count == 1
    bad = a._param_offload.state_dict()
    bad["masters"]["leaf0"] = bad["masters"]["leaf0"][:-1]
    with pytest.raises(ValueError, match="leaf0"):
        b._param_offload.load_state_dict(bad)


def test_load_without_optimizer_states_takes_the_masters_only(tmp_path):
    a = _port(_tcfg(2), _config(), 1)
    for step in range(2):
        a.train_batch({"input_ids": _ids(step)})
    a.save_checkpoint(str(tmp_path), tag="t1")
    b = _port(_tcfg(2), _config(), 1, seed=7)
    b.load_checkpoint(str(tmp_path), tag="t1", load_optimizer_states=False)
    sa, sb = _state(a), _state(b)
    for k in sa:
        if k.startswith("masters."):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert not sb[k].any(), k
    assert b._param_offload.step_count == 0 and b.global_steps == 2


# ------------------------------------------------------------------ optimizers
def test_adagrad_trains_under_cpu_and_nvme_refuses_it(tmp_path):
    engine = _port(_tcfg(2), _config(optimizer="adagrad"), 1)
    losses = [engine.train_batch({"input_ids": _ids(0)}).item() for _ in range(4)]
    assert losses[-1] < losses[0]
    assert engine._param_offload.sq_sum is not None and engine._param_offload.step_count == 4
    with pytest.raises(ValueError, match="adam"):
        _port(_tcfg(2), _config("nvme", nvme_path=str(tmp_path), optimizer="adagrad"), 1)


def test_eval_and_the_dataloader_under_offload():
    rows = [{"input_ids": r} for r in _ids(5, 16)]
    model = torch_lm.causal_lm_model(_tcfg(2), sample_seq_len=SEQ, layers_per_group=1)
    engine, _, loader, _ = dst.initialize(model=model, config=_config(), device="cpu",
                                          training_data=rows)
    batch = {"input_ids": _ids(5, 16)[:8]}
    before = engine.eval_batch(batch)
    resident = _port(_tcfg(2), _config(offload=None), 1,
                     start=engine._param_offload.full_params_host())
    assert torch.equal(before, resident.eval_batch(batch))
    for _ in range(5):
        engine.train_batch()
    assert engine.eval_batch(batch) < before and engine.global_steps == 5


def test_segment_keys_follow_the_stream():
    """Segment g of micro-batch m gets fold_in(fold_in(step key, m), g)."""
    seen = []

    def first(params, batch, rng):
        seen.append(rng)
        return batch["x"] * params[0]["w"]

    def last(params, x, batch, rng):
        seen.append(rng)
        return (x * params[0]["v"]).sum()

    def init(name):
        return lambda seed, device: ({name: torch.ones(3, device=device)},)

    segs = [Segment("a", "first", ("w",), ("w",), init("w"), first),
            Segment("b", "last", ("v",), ("v",), init("v"), last)]
    model = Model(loss_fn=None, init_fn=None, segments=segs)
    engine = dst.initialize(model=model, device="cpu", config=dict(
        _config(gas=2, micro=4), train_batch_size=8))[0]
    engine.train_batch({"x": torch.ones(8, 3)})
    step = rng_stream.fold_in(engine._base_key, 0)
    want = []
    for m in range(2):
        mb = rng_stream.fold_in(step, m)
        want += [rng_stream.fold_in(mb, 0), rng_stream.fold_in(mb, 1), rng_stream.fold_in(mb, 0)]
    assert seen == want


# ---------------------------------------------------------------------- guards
@pytest.mark.parametrize("case", ["stage", "segments", "nvme_path"])
def test_guards(case):
    config, model = _config(), torch_lm.causal_lm_model(_tcfg(2), layers_per_group=1)
    match = {"stage": "stage 3", "segments": "segment", "nvme_path": "nvme_path"}[case]
    if case == "stage":
        config["zero_optimization"]["stage"] = 1
    elif case == "segments":
        model = gpt2_model(GPT2Config(vocab_size=VOCAB, n_positions=32, n_embd=32, n_layer=2,
                                      n_head=4))
    else:
        config["zero_optimization"]["offload_param"] = {"device": "nvme"}
    with pytest.raises(ValueError, match=match):
        dst.initialize(model=model, config=config, device="cpu")


@pytest.mark.parametrize("call", ["forward", "backward", "step"])
def test_eager_triple_refuses(call):
    engine = _port(_tcfg(2), _config(), 1)
    batch = {"input_ids": _ids(0)}
    with pytest.raises(NotImplementedError, match="train_batch"):
        getattr(engine, call)(*([batch] if call == "forward" else []))


@pytest.mark.parametrize("key,value", [("buffer_count", 1), ("buffer_size", 10),
                                       ("max_in_cpu", 10), ("pin_memory", True)])
def test_unread_offload_param_keys_refused(key, value):
    config = _config()
    config["zero_optimization"]["offload_param"][key] = value
    with pytest.raises(NotImplementedError, match="not read by the JAX engine"):
        dst.initialize(model=torch_lm.causal_lm_model(_tcfg(2)), config=config, device="cpu")


def test_cpu_offload_param_alias_streams():
    config = _config(offload=None)
    config["zero_optimization"]["cpu_offload_param"] = True
    engine = dst.initialize(model=torch_lm.causal_lm_model(_tcfg(2), layers_per_group=1),
                            config=config, device="cpu")[0]
    assert engine.param_offload_enabled and engine.state is None
    assert np.isfinite(engine.train_batch({"input_ids": _ids(0)}).item())


def test_the_streamed_step_is_one_train_step_span():
    from deepspeed_tpu_torch.observability.trace import get_tracer
    engine = _port(_tcfg(2), _config(), 1)
    tracer = get_tracer()
    tracer.reset()
    tracer.enable()
    try:
        engine.train_batch({"input_ids": _ids(0)})
        spans = [s for s in tracer.spans if s["name"] == "train_step"]
    finally:
        tracer.disable()
        tracer.reset()
    assert len(spans) == 1 and spans[0]["cat"] == "train"
    assert spans[0]["attrs"] == {"step": 1, "offload": True}
