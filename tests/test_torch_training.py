"""The port's training stack against the JAX package's, on the CPU.

Building blocks first: Adam/AdamW, the loss scaler, norms and clipping, the
LR schedules, each fed the same numpy inputs on both sides. Then the engine:
``deepspeed_tpu_torch.initialize`` and ``deepspeed_tpu.initialize`` start from
the same GPT-2 weights (the JAX engine's initial parameters, copied to numpy
before its first step, which donates its state) and take 5 ``train_batch``
steps of AdamW with gradient accumulation 2, clipping 1.0 and WarmupLR on the
same batches, in f32, bf16 and fp16 (dynamic loss scaling; and a scale so
large that every step overflows and is skipped); and again in f32 and bf16
with ``remat`` (full; dots with the chunked-vocab loss). The JAX engine shards each
batch over the 8 virtual CPU devices; its micro-batch of 8 sequences is the
port's.

Tolerances. Adam: 1e-6 relative, one f32 formula on both sides. Scaler,
schedules: exact. Norms: 1e-6 relative (f32 sums in another order). Engine,
per-step loss: f32 1e-5, bf16 1e-3, fp16 1e-4. Engine, final parameters: per
tensor, ||dp - dp_jax|| <= tol ||dp_jax|| for the update dp = p_final -
p_initial, tol f32 1e-4, bf16 5e-2, fp16 1e-2 (bf16 and fp16 products round at
other points in the two frameworks, and Adam normalises each gradient, so a
small relative gradient difference is a like relative update difference). The
key bias's part of ``c_attn.bias`` is left out: its exact gradient is 0 (a
softmax is blind to a constant added to a row), both sides leave rounding
noise there, and Adam turns noise of either sign into full-size steps.
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
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.adam.fused_adam import fused_adam as jax_fused_adam
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.ops.adam import fused_adam
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime import utils as torch_utils
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as torch_scaler

TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)


# ------------------------------------------------------------------ Adam
@pytest.mark.parametrize("adam_w,wd", [(True, 0.01), (False, 0.01), (True, 0.0)])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_matches_jax(adam_w, wd, bias_correction):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=wd, adam_w_mode=adam_w,
              bias_correction=bias_correction)
    jopt, topt = jax_fused_adam(**kw), fused_adam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                                 jnp.float32(lr))
        topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp, lr)
    assert int(tstate.step) == int(jstate.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.exp_avg[k].numpy(), np.asarray(jstate.exp_avg[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.exp_avg_sq[k].numpy(),
                                   np.asarray(jstate.exp_avg_sq[k]), rtol=1e-6, atol=1e-9)


def test_adam_keep_leaves_everything_as_it_was():
    opt = fused_adam(weight_decay=0.01)
    p = {"a": torch.ones(4)}
    state = opt.init(p)
    opt.update({"a": torch.full((4,), float("inf"))}, state, p, 1e-2,
               keep=torch.tensor(True))
    assert torch.equal(p["a"], torch.ones(4)) and int(state.step) == 0
    assert not state.exp_avg["a"].any() and not state.exp_avg_sq["a"].any()


# ------------------------------------------------------------ loss scaler
@pytest.mark.parametrize("hysteresis,consecutive", [(1, False), (2, False), (3, True)])
def test_loss_scaler_sequence_matches_jax(hysteresis, consecutive):
    kw = dict(init_scale=2.0**10, scale_window=3, min_scale=4.0, delayed_shift=hysteresis,
              consecutive_hysteresis=consecutive)
    js, ts = jax_scaler.DynamicLossScaler(**kw), torch_scaler.DynamicLossScaler(**kw)
    jstate, tstate = js.init_state(), ts.init_state()
    flags = [0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    for f in flags:
        jstate = js.update(jstate, jnp.asarray(bool(f)))
        tstate = ts.update(tstate, torch.tensor(bool(f)))
        assert [float(x) for x in tstate] == [float(x) for x in jstate]
    assert tstate.cur_hysteresis.dtype == torch.int32


@pytest.mark.parametrize("fp16", [{"enabled": False}, {"enabled": True},
                                  {"enabled": True, "loss_scale": 128.0},
                                  {"enabled": True, "initial_scale_power": 8,
                                   "hysteresis": 3, "loss_scale_window": 5}])
def test_create_loss_scaler_matches_jax(fp16):
    from deepspeed_tpu.config.config import FP16Config
    from deepspeed_tpu_torch.config.config import FP16Config as TorchFP16Config
    jscaler, jstate = jax_scaler.create_loss_scaler(FP16Config(**fp16))
    tscaler, tstate = torch_scaler.create_loss_scaler(TorchFP16Config(**fp16))
    assert [float(x) for x in tstate] == [float(x) for x in jstate]
    assert vars(tscaler) == vars(jscaler)


# ------------------------------------------------------- norms, clipping
def test_norm_clip_and_overflow_match_jax():
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in [(5, 3), (7,), (2, 2, 2)]]
    jl, tl = [jnp.asarray(x) for x in leaves], [torch.from_numpy(x) for x in leaves]
    norm = torch_utils.global_norm(tl)
    np.testing.assert_allclose(float(norm), float(jax_utils.global_norm(jl)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        got = torch_utils.clip_by_global_norm(tl, max_norm)
        for g, r in zip(got, jax_utils.clip_by_global_norm(jl, max_norm)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert not bool(torch_utils.has_overflow(tl))
    tl[1][3] = float("nan")
    assert bool(torch_utils.has_overflow(tl))
    assert torch_utils.count_parameters({"a": tl[0], "b": tl[2]}) == 15 + 8


# --------------------------------------------------------------- schedules
@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 10,
                  "cycle_second_step_size": 15, "decay_lr_rate": 0.1, "decay_step_size": 5}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 20}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 1e-3, "warmup_num_steps": 10,
                       "warmup_type": "linear"}),
])
def test_lr_schedules_match_jax_over_50_steps(name, params):
    js, ts = jax_lr.get_lr_scheduler(name, params), lr_schedules.get_lr_scheduler(name, params)
    for _ in range(50):
        js.step()
        ts.step()
        assert ts.get_last_lr() == js.get_last_lr()
        assert ts.lr == js.lr
    if name == "OneCycle":
        assert ts.get_mom() == js.get_mom()
    assert ts.state_dict() == js.state_dict()


# ------------------------------------------------------------------ engine
def _config(precision):
    return {"train_batch_size": 16, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10**9,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 3, "warmup_max_lr": 1e-2,
                                     "warmup_type": "linear"}},
            **precision}


PRECISIONS = {
    "float32": {},
    "bfloat16": {"bf16": {"enabled": True}},
    "float16": {"fp16": {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 2}},
    "float16-overflow": {"fp16": {"enabled": True, "initial_scale_power": 60,
                                  "hysteresis": 1}},
}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3, "float16": 1e-4, "float16-overflow": 1e-4}
UPDATE_TOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1e-2}


def _engines(precision, **model_kw):
    """A JAX engine and a port engine on the CPU, from the same weights;
    ``model_kw`` (e.g. ``remat``, ``vocab_chunk``) goes to both GPT-2
    configs."""
    dtype = precision.split("-")[0]
    config = _config(PRECISIONS[precision])
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=getattr(jnp, dtype), attention_impl="xla",
                               **model_kw)
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(config))
    start = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = torch_gpt2.GPT2Config(**TINY, dtype=getattr(torch, dtype), **model_kw)
    sd = gpt2_params_from_jax(start, tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg),
                                init_fn=lambda seed, device: sd)
    tengine, opt, loader, sched = dst.initialize(model=model, config=dict(config),
                                                 device="cpu")
    assert opt is tengine.optimizer and loader is None and sched is tengine.lr_scheduler
    return jengine, tengine, tcfg, sd


def _batches(n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY["vocab_size"], (16, 64)).astype(np.int32) for _ in range(n)]


def _without_key_bias(name, x):
    x = x.clone()
    if name.endswith("c_attn.bias"):
        x[TINY["n_embd"]:2 * TINY["n_embd"]] = 0.0
    return x


@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_engine_trajectory_matches_jax(precision):
    check_trajectory(precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_kw", [{"remat": True, "remat_policy": "full"},
                                      {"remat": True, "remat_policy": "dots",
                                       "vocab_chunk": 48}],
                         ids=["remat-full", "remat-dots-chunk48"])
def test_engine_trajectory_with_remat_matches_jax(model_kw, precision):
    """The same trajectory with remat on both sides, and the chunked-vocab
    loss (vocab 128 = 48 + 48 + 32), at the same tolerances."""
    check_trajectory(precision, **model_kw)


def check_trajectory(precision, **model_kw):
    """5 ``train_batch`` steps of both engines (``_engines``):
    losses within ``LOSS_TOL``, step counters, loss scale and lr equal, each
    tensor's update within ``UPDATE_TOL``."""
    jengine, tengine, tcfg, start = _engines(precision, **model_kw)
    jloss, tloss = [], []
    for ids in _batches():
        jloss.append(float(jengine.train_batch({"input_ids": ids})))
        loss = tengine.train_batch({"input_ids": ids})
        assert loss.shape == () and loss.dtype == torch.float32
        tloss.append(loss.item())
    np.testing.assert_allclose(tloss, jloss, atol=LOSS_TOL[precision], rtol=0)
    assert tengine.global_steps == jengine.global_steps == 5
    assert tengine.skipped_steps == jengine.skipped_steps
    assert tengine.loss_scale() == jengine.loss_scale()
    assert tengine.get_lr() == pytest.approx(jengine.get_lr())
    final = gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jengine.state.params)), tcfg)
    if precision == "float16-overflow":       # every step overflowed and was skipped
        assert tengine.skipped_steps == 5
        for name, p in tengine.state.params.items():
            assert torch.equal(p.detach(), start[name]) and torch.equal(final[name],
                                                                        start[name])
        return
    for name, p in tengine.state.params.items():
        got = _without_key_bias(name, p.detach() - start[name])
        want = _without_key_bias(name, final[name] - start[name])
        err = float((got - want).norm())
        assert err <= UPDATE_TOL[precision] * float(want.norm()), \
            f"{name}: |dp - dp_jax| = {err:.3e}, |dp_jax| = {float(want.norm()):.3e}"


def test_forward_backward_step_equals_train_batch():
    """The micro-batch triple and the fused train_batch take the same steps,
    bit for bit: the same operations in the same order."""
    cfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32)
    config = _config({})
    fused, _, _, _ = dst.initialize(model=torch_gpt2.gpt2_model(cfg), config=config,
                                    device="cpu")
    triple, _, _, _ = dst.initialize(model=torch_gpt2.gpt2_model(cfg), config=config,
                                     device="cpu")
    for ids in _batches(3):
        want = fused.train_batch({"input_ids": ids})
        losses = []
        for half in np.split(ids, 2):
            assert triple.is_gradient_accumulation_boundary() == (len(losses) == 1)
            loss = triple.forward({"input_ids": half})
            triple.backward(loss)
            triple.step()
            losses.append(loss.detach())
        assert torch.equal(torch.stack(losses).mean(), want)
    assert triple.global_steps == fused.global_steps == 3
    for name, p in fused.state.params.items():
        assert torch.equal(triple.state.params[name], p), name
    assert torch.equal(triple.eval_batch({"input_ids": ids[:4]}),
                       fused.eval_batch({"input_ids": ids[:4]}))


# ------------------------------------------------------------- rejections
BASE = {"train_batch_size": 4}


@pytest.mark.parametrize("extra,item", [
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme",
                                                          "nvme_path": "x"}}}, "item 12"),
    ({"wandb": {"enabled": True}}, "item 9"),
    ({"csv_monitor": {"enabled": True}}, "item 9"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}}, "item 12"),
    ({"eigenvalue": {"enabled": True}}, "item 13"),
    ({"tensorboard": {"enabled": True}}, "item 9"),
    ({"jsonl_monitor": {"enabled": True, "output_path": "x"}}, "item 9"),
    ({"flops_profiler": {"enabled": True}}, "item 9"),
    ({"pipeline": {"stages": 2}}, "item 13"),
    ({"comm_overlap": {"enabled": True, "quantized_allreduce": True}}, "item 11"),
    ({"mesh": {"data": 2}}, "item 11"),
    ({"compression_training": {"weight_quantization": {}}}, "item 13"),
    ({"curriculum_learning": {"enabled": True}}, "item 13"),
    ({"progressive_layer_drop": {"enabled": True}}, "item 13"),
    ({"activation_checkpointing": {"partition_activations": True}}, "item 11"),
    ({"fp16_master_weights_and_gradients": True}, "item 12"),
    ({"fp16": {"enabled": True, "auto_cast": True}}, "not read by the JAX engine"),
])
def test_unported_config_raises_naming_its_item(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        DeepSpeedConfig(dict(BASE, **extra))


@pytest.mark.parametrize("config", [
    {"train_batch_size": 4, "no_such_key": 1},
    {"train_batch_size": 4, "fp16": {"enabled": True, "no_such_key": 1}},
    {"train_batch_size": 4, "optimizer": {"type": "Adam", "params": {"no_such": 1}}},
    {"train_batch_size": 4, "optimizer": {"type": "Sgdx"}},
])
def test_unknown_config_keys_raise_value_error(config):
    with pytest.raises(ValueError):
        DeepSpeedConfig(config)


def test_config_resolves_batch_and_off_blocks_pass():
    cfg = DeepSpeedConfig({"train_batch_size": 24, "train_micro_batch_size_per_gpu": 8,
                           "tensorboard": {"enabled": False}, "wall_clock_breakdown": False,
                           "zero_optimization": {"stage": 1}, "bf16": {"enabled": True}})
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == (24, 8, 3)
    assert DeepSpeedConfig({"train_batch_size": 4, "activation_checkpointing": {
        "policy": "dots"}}).activation_checkpointing.policy == "dots"
    with pytest.raises(Exception, match="train_batch_size"):
        DeepSpeedConfig({"train_batch_size": 24, "train_micro_batch_size_per_gpu": 8,
                         "gradient_accumulation_steps": 2})
    with pytest.raises(Exception, match="both"):
        DeepSpeedConfig({"train_batch_size": 4, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})


def test_initialize_rejects_unported_arguments(tmp_path):
    model = torch_gpt2.gpt2_model(torch_gpt2.GPT2Config(**TINY))
    with pytest.raises(NotImplementedError, match="item 11"):
        dst.initialize(model=model, config=BASE, mpu=object(), device="cpu")

    class PipelineModule:
        pass

    with pytest.raises(NotImplementedError, match="item 13"):
        dst.initialize(model=PipelineModule(), config=BASE, device="cpu")
    with pytest.raises(TypeError):
        dst.initialize(model=object(), config=BASE, device="cpu")
    engine, _, _, _ = dst.initialize(model=model, config=BASE, device="cpu")
    assert engine.load_checkpoint(os.path.join(str(tmp_path), "nothing-saved")) == (None, {})


def test_initialize_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    model = torch_gpt2.gpt2_model(torch_gpt2.GPT2Config(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dst.initialize(model=model, config=BASE)
