"""The port's ZeRO-Offload tier against the JAX package's, on the CPU.

The host ops first: ``adam_step``, ``adagrad_step`` and ``fp32_to_bf16`` of
``deepspeed_tpu_torch/ops/adam/cpu_adam.py`` against the JAX package's native
ones on the same numpy inputs (NaN, +-inf and bf16 halfway values among them):
equal bit for bit, since both build one C++ source with the same flags; and
within rtol 1e-6 / atol 1e-7 of their plain PyTorch versions (the C++ may
contract a multiply and an add into one rounding). Then
``OffloadOptimizerTier`` against JAX's on the same masters and gradients over
3 steps: masters, moments or sums and the pushed bf16 parameters equal bit
for bit. Then the engine: ``initialize`` with ``zero_optimization`` stage 3 and
``offload_optimizer: cpu`` against ``deepspeed_tpu.initialize`` with the same,
5 ``train_batch`` steps from the same f32 weights, at
``test_torch_training.py``'s limits (losses ``LOSS_TOL``; each tensor's update
f32 1e-4, bf16 5e-2, fp16 1e-2 of its norm). Inside the port: NVMe equals cpu
bit for bit; save, resume and step equal the uninterrupted run; a module-only
load reseeds the masters; a truncated moments file raises before anything is
copied; an fp16 overflow leaves the masters alone; the triple equals
``train_batch``; each leaf's push follows its update; ``zero_to_fp32`` and the
universal export read the masters (JAX's ``zero_to_fp32`` reads the bf16
device parameters: both are shown).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.adagrad.cpu_adagrad import adagrad as jax_adagrad
from deepspeed_tpu.ops.adam import cpu_adam as jax_cpu_adam
from deepspeed_tpu.runtime.zero.offload import OffloadOptimizerTier as JaxTier
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.ops.adagrad import adagrad
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.runtime.zero import offload
from tests.test_torch_training import (LOSS_TOL, PRECISIONS, TINY, UPDATE_TOL, _batches,
                                       _config, _without_key_bias)

RTOL, ATOL = 1e-6, 1e-7
ZERO3_CPU = {"stage": 3, "offload_optimizer": {"device": "cpu"}}
# the port-only engines train on 4 sequences a step (2 a micro-batch): the
# suite runs on 6 workers that share the cores
SMALL = 4


def _small(n):
    return [ids[:SMALL] for ids in _batches(n)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's torch ops and host ops on one thread. The suite's workers
    share the cores, and an OpenMP region on tiny tensors then waits on
    descheduled threads at its barrier (tens of ms a call); the host ops are
    elementwise, so no result depends on the thread count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _special(n, rng):
    """f32 values with NaN (both signs), +-inf, 0 and -0 in front."""
    x = rng.standard_normal(n).astype(np.float32)
    x[:6] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0]
    return x


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype == np.float32 else np.uint16)


# ------------------------------------------------------------------ host ops
@pytest.mark.parametrize("adam_w,wd,bias_correction", [(True, 0.01, True), (False, 0.01, True),
                                                         (True, 0.0, False)])
def test_host_adam_equals_jax_native_and_plain(adam_w, wd, bias_correction):
    rng = np.random.default_rng(0)
    n = 4099                       # odd: the vector loop's tail
    p0 = rng.standard_normal(n).astype(np.float32)
    jp, jm, jv = p0.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (jp, jm, jv))
    pp, pm, pv = (t.clone() for t in (tp, tm, tv))
    for step in (1, 2, 3):
        g = rng.standard_normal(n).astype(np.float32)
        if step == 3:
            g[:6] = _special(6, rng)[:6]         # non-finite gradients in the last step
        kw = dict(lr=1e-2 * step, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd,
                  adam_w_mode=adam_w, step=step, bias_correction=bias_correction)
        jax_cpu_adam.adam_step(jp, jm, jv, g, **kw)
        cpu_adam.adam_step(tp, tm, tv, torch.from_numpy(g), **kw)
        cpu_adam.adam_step_plain(pp, pm, pv, torch.from_numpy(g), **kw)
    for got, want, plain in ((tp, jp, pp), (tm, jm, pm), (tv, jv, pv)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
    assert np.isnan(tp[:2].numpy()).all() and np.isfinite(tp[6:].numpy()).all()


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_host_adagrad_equals_jax_native_and_plain(wd):
    rng = np.random.default_rng(1)
    n = 1027
    jp, js = rng.standard_normal(n).astype(np.float32), np.zeros(n, np.float32)
    tp, ts = torch.from_numpy(jp.copy()), torch.from_numpy(js.copy())
    pp, ps = tp.clone(), ts.clone()
    for step in (1, 2, 3):
        g = _special(n, rng) if step == 3 else rng.standard_normal(n).astype(np.float32)
        jax_cpu_adam.adagrad_step(jp, js, g, 1e-2, 1e-10, wd)
        cpu_adam.adagrad_step(tp, ts, torch.from_numpy(g), 1e-2, 1e-10, wd)
        cpu_adam.adagrad_step_plain(pp, ps, torch.from_numpy(g), 1e-2, 1e-10, wd)
    for got, want, plain in ((tp, jp, pp), (ts, js, ps)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


def test_fp32_to_bf16_equals_jax_native_and_plain():
    rng = np.random.default_rng(2)
    one = np.float32(1.0).view(np.uint32)
    # exact halfway cases (ties to even, both ways), the largest finite f32, a
    # denormal, a NaN with a payload
    halfway = np.array([one + 0x8000, one + 0x18000, one + 0x7FFF, one + 0x8001,
                        0x7F7FFFFF, 0x00000001, 0x7FA00001, 0xFFC12345], np.uint32)
    x = np.concatenate([_special(64, rng), halfway.view(np.float32),
                        rng.standard_normal(999).astype(np.float32) * 1e3])
    want = jax_cpu_adam.fp32_to_bf16(x)
    got = cpu_adam.fp32_to_bf16(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (x.size,)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  cpu_adam.fp32_to_bf16_plain(torch.from_numpy(x)).float()
                                  .numpy())
    # into a staging buffer
    out = torch.empty(x.size, dtype=torch.bfloat16)
    assert cpu_adam.fp32_to_bf16(torch.from_numpy(x), out).data_ptr() == out.data_ptr()
    assert torch.equal(out.view(torch.int16), got.view(torch.int16))


def test_host_ops_refuse_what_they_cannot_write_through():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous f32 CPU"):
        cpu_adam.adam_step(p.double(), p, p, p, 1e-3, 0.9, 0.999, 1e-8, 0.0, True, 1)
    with pytest.raises(ValueError, match="contiguous f32 CPU"):
        cpu_adam.adagrad_step(torch.zeros(4, 2).t(), torch.zeros(8), p, 1e-3, 1e-10, 0.0)
    with pytest.raises(ValueError, match="elements"):
        cpu_adam.adam_step(p, p, p, torch.zeros(7), 1e-3, 0.9, 0.999, 1e-8, 0.0, True, 1)


def test_device_adagrad_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt, topt = jax_adagrad(eps=1e-10, weight_decay=0.01), adagrad(eps=1e-10,
                                                                    weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                                 jnp.float32(1e-2))
        topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp, 1e-2)
    assert int(tstate.step) == int(jstate.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tstate.sum_sq[k].numpy(), np.asarray(jstate.sum_sq[k]),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- the tier
@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_tier_equals_jax_tier_bit_for_bit(kind):
    """Three bf16 steps from the same masters and bf16 gradients."""
    rng = np.random.default_rng(4)
    shapes = {"a": (33, 7), "b": (64,), "c": (3, 5, 2)}          # sorted: JAX's leaf order
    masters = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(kind=kind, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)
    dev = jax.devices()[0]
    jtier = JaxTier({k: jnp.asarray(v) for k, v in masters.items()},
                    {k: jax.sharding.SingleDeviceSharding(dev) for k in shapes},
                    jnp.bfloat16, **kw)
    ttier = offload.OffloadOptimizerTier({k: torch.from_numpy(v.copy())
                                          for k, v in masters.items()}, torch.bfloat16, **kw)
    tparams = ttier.initial_device_params()
    jparams = jtier.initial_device_params()
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(ml_dtypes.bfloat16) for k, s in shapes.items()}
        jparams = jtier.step({k: jnp.asarray(v) for k, v in g.items()}, lr=1e-2 * (step + 1))
        assert ttier.step([torch.from_numpy(g[k].view(np.int16)).view(torch.bfloat16)
                           for k in shapes], lr=1e-2 * (step + 1))
    jsd, tsd = jtier.state_dict(), ttier.state_dict()
    assert set(tsd) == set(jsd) and int(tsd["step"]) == int(jsd["step"]) == 3
    for part in [k for k in jsd if k not in ("step",)]:
        for leaf in jsd[part]:
            np.testing.assert_array_equal(tsd[part][leaf].numpy(), np.asarray(jsd[part][leaf]))
    for k in shapes:
        np.testing.assert_array_equal(tparams[k].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jparams[k]).view(np.uint16))


def test_partitioned_tier_raises_naming_item_11(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="item 11"):
        offload.OffloadOptimizerTier({"a": torch.zeros(4)}, torch.bfloat16)


# --------------------------------------------------------------- the engine
def _jax_masters(jengine):
    """The JAX engine's f32 master tree (its device parameters are bf16)."""
    leaves, treedef = jax.tree_util.tree_flatten(jengine.state.params)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(m, np.float32).reshape(l.shape).copy()
        for m, l in zip(jengine._offload_tier.masters, leaves)])


def _masters(engine):
    return {n: m.clone() for n, m in engine._offload_tier.named_masters().items()}


def _offload_engines(precision, zero=ZERO3_CPU):
    """A JAX and a port offload engine from the same f32 weights, one micro-batch
    of 8 a step (one sequence a JAX device)."""
    dtype = precision.split("-")[0]
    config = dict(_config(PRECISIONS[precision]), zero_optimization=zero,
                  train_batch_size=8, gradient_accumulation_steps=1)
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=getattr(jnp, dtype), attention_impl="xla")
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=dict(config))
    tcfg = torch_gpt2.GPT2Config(**TINY, dtype=getattr(torch, dtype))
    start = gpt2_params_from_jax(_jax_masters(jengine), tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg), init_fn=lambda seed, device: start)
    tengine, _, _, _ = dst.initialize(model=model, config=dict(config), device="cpu")
    return jengine, tengine, tcfg, start


@pytest.fixture(scope="module")
def trained():
    """``trained(precision)``: ``_offload_engines`` after 5 ``train_batch`` steps
    on the same batches, with both losses; built once a module and precision
    (the bf16 pair also serves the ``zero_to_fp32`` test)."""
    cache = {}

    def get(precision):
        if precision not in cache:
            jengine, tengine, tcfg, start = _offload_engines(precision)
            assert tengine.state.opt_state == {} and tengine.optimizer is None
            assert all(p.dtype == tcfg.dtype and p.requires_grad
                       for p in tengine.state.params.values())
            jloss, tloss = [], []
            for ids in _batches():
                jloss.append(float(jengine.train_batch({"input_ids": ids[:8]})))
                tloss.append(tengine.train_batch({"input_ids": ids[:8]}).item())
            cache[precision] = (jengine, tengine, tcfg, start, jloss, tloss)
        return cache[precision]
    return get


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "float16"])
def test_offload_trajectory_matches_jax_offload(precision, trained):
    jengine, tengine, tcfg, start, jloss, tloss = trained(precision)
    np.testing.assert_allclose(tloss, jloss, atol=LOSS_TOL[precision], rtol=0)
    assert tengine.global_steps == jengine.global_steps == 5
    assert tengine.skipped_steps == jengine.skipped_steps
    assert tengine.loss_scale() == jengine.loss_scale()
    assert tengine._offload_tier.step_count == jengine._offload_tier.opt.step_count
    final = gpt2_params_from_jax(_jax_masters(jengine), tcfg)
    for name, p in _masters(tengine).items():
        got = _without_key_bias(name, p - start[name])
        want = _without_key_bias(name, final[name] - start[name])
        err = float((got - want).norm())
        assert err <= UPDATE_TOL[precision] * float(want.norm()), \
            f"{name}: |dp - dp_jax| = {err:.3e}, |dp_jax| = {float(want.norm()):.3e}"
        # the device copies are the masters in the compute dtype
        assert torch.equal(tengine.state.params[name].detach(), p.to(tcfg.dtype))


def _port_engine(zero, precision="bfloat16", seed=42, optimizer="AdamW", gas=2):
    cfg = torch_gpt2.GPT2Config(**TINY, dtype=getattr(torch, precision.split("-")[0]))
    config = dict(_config(PRECISIONS[precision]), zero_optimization=zero,
                  train_batch_size=SMALL, gradient_accumulation_steps=gas)
    config["optimizer"] = dict(config["optimizer"], type=optimizer)
    model = dataclasses.replace(torch_gpt2.gpt2_model(cfg), init_fn=lambda _, device:
                                torch_gpt2.init_params(cfg, seed, device))
    engine, _, _, _ = dst.initialize(model=model, config=config, device="cpu")
    return engine


def _nvme(path):
    return {"stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": str(path)}}


def _tier_state(engine):
    sd = engine._offload_tier.state_dict()
    return {f"{part}.{k}": v.clone() for part in ("masters", "m", "v", "sq_sum") if part in sd
            for k, v in sd[part].items()}


def test_nvme_equals_cpu_bit_for_bit(tmp_path):
    cpu, nvme = _port_engine(ZERO3_CPU), _port_engine(_nvme(tmp_path / "swap"))
    for ids in _small(3):
        assert torch.equal(cpu.train_batch({"input_ids": ids}),
                           nvme.train_batch({"input_ids": ids}))
    a, b = _tier_state(cpu), _tier_state(nvme)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    files = sorted(os.listdir(tmp_path / "swap"))
    assert len(files) == len(cpu._offload_tier.masters) and files[0].startswith("moments_leaf")
    assert nvme._offload_tier.nvme.handle.o_direct      # O_DIRECT asked for (tmpfs refuses it)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_save_resume_step_equals_uninterrupted(tmp_path, device):
    zero = ZERO3_CPU if device == "cpu" else _nvme(tmp_path / "swap_a")
    a = _port_engine(zero)
    ids = _small(3)
    for x in ids[:2]:
        a.train_batch({"input_ids": x})
    a.save_checkpoint(str(tmp_path / "ckpt"))
    saved = _tier_state(a)
    want = a.train_batch({"input_ids": ids[2]})
    tag = tmp_path / "ckpt" / "global_step2"
    assert (tag / "offload_state").is_dir()
    assert (tag / "offload_state_moments").is_dir() == (device == "nvme")
    zero_b = ZERO3_CPU if device == "cpu" else _nvme(tmp_path / "swap_b")
    b = _port_engine(zero_b, seed=7)
    path, _ = b.load_checkpoint(str(tmp_path / "ckpt"))
    assert path == str(tag) and b.global_steps == 2 and b._offload_tier.step_count == 2
    got_state = _tier_state(b)
    assert all(torch.equal(saved[k], got_state[k]) for k in saved)
    assert torch.equal(b.train_batch({"input_ids": ids[2]}), want)
    assert all(torch.equal(x, y) for x, y in zip(a._offload_tier.masters,
                                                 b._offload_tier.masters))
    assert all(torch.equal(a.state.params[k], b.state.params[k]) for k in a.state.params)


def test_module_only_load_reseeds_masters(tmp_path):
    a = _port_engine(ZERO3_CPU)
    for x in _small(2):
        a.train_batch({"input_ids": x})
    a.save_checkpoint(str(tmp_path))
    b = _port_engine(ZERO3_CPU)
    before = [m.clone() for m in b._offload_tier.masters]
    b.load_checkpoint(str(tmp_path), load_module_only=True)
    for m, (name, p) in zip(b._offload_tier.masters, a.state.params.items()):
        assert torch.equal(m, p.detach().float().reshape(-1)), name
    assert not all(torch.equal(x, y) for x, y in zip(before, b._offload_tier.masters))
    assert b._offload_tier.step_count == 0          # the optimizer state is the engine's own


def test_truncated_moments_file_raises_before_anything_is_copied(tmp_path):
    a = _port_engine(_nvme(tmp_path / "swap_a"))
    a.train_batch({"input_ids": _small(1)[0]})
    a.save_checkpoint(str(tmp_path / "ckpt"))
    moments = tmp_path / "ckpt" / "global_step1" / "offload_state_moments"
    victim = sorted(moments.iterdir())[0]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 4)
    b = _port_engine(_nvme(tmp_path / "swap_b"), seed=7)
    before = [m.clone() for m in b._offload_tier.masters]
    params = {k: p.detach().clone() for k, p in b.state.params.items()}
    with pytest.raises(RuntimeError, match="corrupt moments file"):
        b.load_checkpoint(str(tmp_path / "ckpt"), validate=False)
    assert all(torch.equal(x, y) for x, y in zip(before, b._offload_tier.masters))
    assert all(torch.equal(params[k], p) for k, p in b.state.params.items())
    assert b.global_steps == 0


def test_fp16_overflow_leaves_the_masters_as_they_were():
    e = _port_engine(ZERO3_CPU, precision="float16-overflow")
    before = [m.clone() for m in e._offload_tier.masters]
    device_before = {k: p.detach().clone() for k, p in e.state.params.items()}
    for x in _small(2):
        e.train_batch({"input_ids": x})
    assert e.skipped_steps == 2 and e.global_steps == 2 and e._offload_tier.step_count == 0
    assert all(torch.equal(x, y) for x, y in zip(before, e._offload_tier.masters))
    assert all(torch.equal(device_before[k], p) for k, p in e.state.params.items())
    assert e._offload_tier.transfer_dtype == torch.float32


def test_forward_backward_step_equals_train_batch():
    fused, triple = _port_engine(ZERO3_CPU), _port_engine(ZERO3_CPU)
    for ids in _small(3):
        want = fused.train_batch({"input_ids": ids})
        losses = []
        for half in np.split(ids, 2):
            loss = triple.forward({"input_ids": half})
            triple.backward(loss)
            triple.step()
            losses.append(loss.detach())
        assert torch.equal(torch.stack(losses).mean(), want)
    assert all(torch.equal(x, y) for x, y in zip(fused._offload_tier.masters,
                                                 triple._offload_tier.masters))
    assert all(torch.equal(fused.state.params[k], p) for k, p in triple.state.params.items())


def test_each_leaf_is_pushed_right_after_its_update(monkeypatch):
    e = _port_engine(ZERO3_CPU, gas=1)
    tier, events = e._offload_tier, []
    real_adam, real_push = cpu_adam.adam_step, tier._push_leaf

    def spy_adam(*a, **kw):
        events.append(("update", sum(1 for ev in events if ev[0] == "update")))
        return real_adam(*a, **kw)

    monkeypatch.setattr(cpu_adam, "adam_step", spy_adam)
    monkeypatch.setattr(tier, "_push_leaf", lambda i: (events.append(("push", i)),
                                                       real_push(i))[1])
    e.train_batch({"input_ids": _small(1)[0]})
    n = len(tier.masters)
    assert events == [ev for i in range(n) for ev in (("update", i), ("push", i))]


def test_offload_adagrad_tracks_device_adagrad():
    off, dev = _port_engine(ZERO3_CPU, optimizer="Adagrad"), _port_engine(
        {"stage": 1}, optimizer="Adagrad")
    assert off._offload_tier.kind == "adagrad" and off._offload_tier.eps == 1e-10
    for ids in _small(3):
        np.testing.assert_allclose(off.train_batch({"input_ids": ids}).item(),
                                   dev.train_batch({"input_ids": ids}).item(), atol=1e-3)
    start = _port_engine({"stage": 1}, optimizer="Adagrad").state.params
    for (name, m), p in zip(_masters(off).items(), dev.state.params.values()):
        # the key bias's exact gradient is 0: Adagrad turns its noise into full steps
        want = _without_key_bias(name, p.detach() - start[name].detach())
        err = float(_without_key_bias(name, m - p.detach()).norm())
        assert err <= 5e-2 * float(want.norm()), name


def test_zero_to_fp32_reads_the_masters_where_jax_reads_bf16(tmp_path, trained):
    """JAX's ``zero_to_fp32`` reads only ``state``: for an offload tag it gives
    the bf16 device parameters (the masters rounded to bf16). The port's reads
    ``offload_state``'s masters. The universal export takes masters and
    moments from the tier."""
    from deepspeed_tpu.utils.zero_to_fp32 import (
        get_fp32_state_dict_from_zero_checkpoint as jax_zero_to_fp32)
    from deepspeed_tpu_torch.checkpoint import export
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    jengine, tengine = trained("bfloat16")[:2]
    jengine.save_checkpoint(str(tmp_path / "jax"))
    tengine.save_checkpoint(str(tmp_path / "torch"))
    jmasters = jax.tree_util.tree_leaves(_jax_masters(jengine))
    jgot = list(jax_zero_to_fp32(str(tmp_path / "jax")).values())
    assert len(jgot) == len(jmasters)
    for got, m in zip(jgot, jmasters):
        np.testing.assert_array_equal(got.reshape(m.shape), m.astype(ml_dtypes.bfloat16)
                                      .astype(np.float32))
    assert any(not np.array_equal(g.reshape(m.shape), m) for g, m in zip(jgot, jmasters))
    tgot = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "torch"))
    masters = _masters(tengine)
    assert list(tgot) == list(masters)
    assert all(torch.equal(tgot[k], masters[k]) for k in masters)
    path = export.export_universal_checkpoint(tengine, str(tmp_path / "universal"))
    sd = tengine._offload_tier.state_dict()
    for i, name in enumerate(masters):
        for kind, want in (("fp32", masters[name]), ("exp_avg", sd["m"][f"leaf{i}"]),
                           ("exp_avg_sq", sd["v"][f"leaf{i}"])):
            got = torch.load(os.path.join(path, "zero", name, f"{kind}.pt"),
                             weights_only=True)["param"]
            assert torch.equal(got, want), (name, kind)


# ------------------------------------------------------------------- config
def test_config_takes_stages_offload_and_aio():
    cfg = DeepSpeedConfig({"train_batch_size": 4, "zero_optimization": {
        "stage": 3, "cpu_offload": True},
        "aio": {"thread_count": 2, "block_size": 1 << 16, "queue_depth": 4}})
    assert cfg.zero_config.stage == 3 and cfg.zero_config.offload_optimizer.device == "cpu"
    assert (cfg.aio_config.thread_count, cfg.aio_config.block_size) == (2, 1 << 16)
    assert not DeepSpeedConfig({"train_batch_size": 4, "zero_optimization": {
        "stage": 2}}).zero_config.offload_optimizer.enabled
    for zero, match in (({"offload_optimizer": {"device": "cpu", "pin_memory": True}},
                         "not read by the JAX engine"),
                        ({"reduce_bucket_size": 10}, "not read by the JAX engine"),
                        ({"stage3_param_persistence_threshold": 0}, "item 11"),
                        ({"param_persistence_threshold": 0}, "item 11")):
        with pytest.raises(NotImplementedError, match=match):
            DeepSpeedConfig({"train_batch_size": 4, "zero_optimization": zero})
    # the deprecated alias of offload_param: {device: cpu}
    assert DeepSpeedConfig({"train_batch_size": 4, "zero_optimization": {
        "stage": 3, "cpu_offload_param": True}}).zero_config.offload_param.device == "cpu"
    with pytest.raises(NotImplementedError, match="not read by the JAX engine"):
        DeepSpeedConfig({"train_batch_size": 4, "aio": {"single_submit": True}})
    with pytest.raises(Exception, match="nvme_path"):
        DeepSpeedConfig({"train_batch_size": 4, "zero_optimization": {
            "offload_optimizer": {"device": "nvme"}}})


def test_engine_passes_the_aio_block_to_the_handle(tmp_path):
    cfg = torch_gpt2.GPT2Config(**TINY)
    engine, _, _, _ = dst.initialize(model=torch_gpt2.gpt2_model(cfg), config={
        "train_batch_size": 8, "zero_optimization": _nvme(tmp_path),
        "aio": {"thread_count": 3, "block_size": 1 << 16, "queue_depth": 2}}, device="cpu")
    handle = engine._offload_tier.nvme.handle
    assert (handle.thread_count, handle.block_size, handle.queue_depth) == (3, 1 << 16, 2)
    with pytest.raises(ValueError, match="adam/adamw only"):
        dst.initialize(model=torch_gpt2.gpt2_model(cfg), config={
            "train_batch_size": 8, "zero_optimization": _nvme(tmp_path),
            "optimizer": {"type": "Adagrad", "params": {}}}, device="cpu")
