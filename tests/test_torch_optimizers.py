"""LAMB and the 1-bit optimizers against the JAX package's, on the CPU.

Each optimizer's ``update`` on both sides is fed the same numpy parameters and
gradients over steps that cross its freeze boundary (1-bit Adam and 1-bit
LAMB: ``freeze_step`` 2 of 5 steps; 0/1 Adam: variance refreshes at steps 1,
2, 4 and 8 (interval capped at 4) until ``var_freeze_step`` 6), in both
weight-decay modes (Adam's and AdamW's for the 1-bit Adams; with and without
decay for the LAMBs). Tolerance: 1e-6 relative and absolute (a few f32 ulps
at the parameters' unit scale), one f32 formula on both sides (the norms and
the compression's mean sum in another order). Then ``keep`` (the fp16
overflow skip) keeps every state tensor;
1-bit LAMB at ``freeze_step=0`` never records its trust ratio (JAX's
behaviour); the engine builds each optimizer from its config block, the
offload tiers refuse them; and the engine trajectories of LAMB and 1-bit
LAMB against the JAX engine's, 5 steps in f32 past the freeze boundary
(losses within 1e-5, as ``test_engine_trajectory_matches_jax``). The 1-bit
Adams are held step by step only: they divide a momentum of +-scale by
sqrt(v) + eps, so an element whose gradient sits at either framework's
rounding noise (the key bias's, 0 in exact arithmetic) steps by about scale
/ eps with a sign the noise picks, and two engines part there (0/1 Adam's
second losses differ by 3.5e-3 on the CPU); LAMB's trust ratio bounds those
steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.comm.compressed import sign_compress as jax_sign_compress
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops.lamb.fused_lamb import fused_lamb as jax_fused_lamb
from deepspeed_tpu.runtime.fp16 import onebit as jax_onebit
from deepspeed_tpu_torch.comm.compressed import sign_compress
from deepspeed_tpu_torch.models import gpt2 as torch_gpt2
from deepspeed_tpu_torch.models.convert import gpt2_params_from_jax
from deepspeed_tpu_torch.ops.lamb import fused_lamb
from deepspeed_tpu_torch.runtime.engine import state_tree
from deepspeed_tpu_torch.runtime.fp16 import onebit

RTOL, ATOL = 1e-6, 1e-6
SHAPES = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}

CASES = {
    "lamb": (jax_fused_lamb, fused_lamb, dict(weight_decay=0.0), 5),
    "lamb-wd": (jax_fused_lamb, fused_lamb, dict(weight_decay=0.01, max_coeff=2.0,
                                                  min_coeff=0.05), 5),
    "onebitadam-adam": (jax_onebit.onebit_adam, onebit.onebit_adam,
                        dict(weight_decay=0.01, freeze_step=2, adam_w_mode=False), 5),
    "onebitadam-adamw": (jax_onebit.onebit_adam, onebit.onebit_adam,
                         dict(weight_decay=0.01, freeze_step=2, adam_w_mode=True), 5),
    "zerooneadam-adam": (jax_onebit.zero_one_adam, onebit.zero_one_adam,
                         dict(weight_decay=0.01, var_freeze_step=6, var_update_scaler=4,
                              adam_w_mode=False), 9),
    "zerooneadam-adamw": (jax_onebit.zero_one_adam, onebit.zero_one_adam,
                          dict(weight_decay=0.01, var_freeze_step=6, var_update_scaler=4,
                               adam_w_mode=True), 9),
    "onebitlamb": (jax_onebit.onebit_lamb, onebit.onebit_lamb,
                   dict(weight_decay=0.0, freeze_step=2), 5),
    "onebitlamb-wd": (jax_onebit.onebit_lamb, onebit.onebit_lamb,
                      dict(weight_decay=0.01, freeze_step=2), 5),
    "onebitlamb-freeze0": (jax_onebit.onebit_lamb, onebit.onebit_lamb,
                           dict(weight_decay=0.01, freeze_step=0), 3),
}


def _inputs(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    params["b"][:] = 0.0      # a zero tensor: the trust ratio's ||p|| = 0 guard
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(n_steps)]
    return params, grads


def _flat(tree):
    """A state tree as {dotted path: numpy array}."""
    out = {}

    def walk(x, prefix):
        if isinstance(x, tuple) and hasattr(x, "_asdict"):
            x = x._asdict()
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        else:
            out[prefix] = np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
    walk(tree, "")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    jfn, tfn, kw, n_steps = CASES[case]
    params, grads = _inputs(n_steps)
    jopt, topt = jfn(betas=(0.9, 0.95), **kw), tfn(betas=(0.9, 0.95), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    assert type(tstate)._fields == type(jstate)._fields
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
                                 jnp.float32(lr))
        topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp, lr)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i + 1} param {k}")
    jflat, tflat = _flat(jstate), _flat(tstate)
    assert sorted(tflat) == sorted(jflat)
    for path, want in jflat.items():
        assert tflat[path].shape == want.shape and tflat[path].dtype == want.dtype, path
        np.testing.assert_allclose(tflat[path], want, rtol=RTOL, atol=ATOL, err_msg=path)
    if case == "onebitlamb-freeze0":      # the boundary (step 0) is never met
        assert all(float(t) == 1.0 for t in tstate.frozen_trust.values())


def test_sign_compress_matches_jax():
    rng = np.random.default_rng(1)
    x, e = (rng.standard_normal((33, 5)).astype(np.float32) for _ in range(2))
    jc, je = jax_sign_compress(jnp.asarray(x), jnp.asarray(e))
    tc, te = sign_compress(torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose((tc + te).numpy(), x + e, rtol=0, atol=1e-6)
    assert len(np.unique(np.abs(tc.numpy()))) == 1


@pytest.mark.parametrize("case", ["lamb-wd", "onebitadam-adam", "zerooneadam-adamw",
                                  "onebitlamb-wd"])
def test_keep_leaves_every_state_tensor(case):
    """After steps past the freeze boundary, an update with ``keep`` set (an
    fp16 overflow) leaves the parameters and every state tensor as they were:
    step, moments, error, frozen trust, variance counters."""
    _, tfn, kw, n_steps = CASES[case]
    params, grads = _inputs(n_steps + 1)
    opt = tfn(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for g in grads[:n_steps]:
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tp, 1e-2)
    before = {**_flat(state), **{f"p.{k}": v.numpy().copy() for k, v in tp.items()}}
    opt.update({k: torch.full_like(torch.from_numpy(v), float("inf"))
                for k, v in grads[-1].items()}, state, tp, 1e-2, keep=torch.tensor(True))
    after = {**_flat(state), **{f"p.{k}": v.numpy() for k, v in tp.items()}}
    assert sorted(after) == sorted(before)
    for path, want in before.items():
        np.testing.assert_array_equal(after[path], want, err_msg=path)


# ------------------------------------------------------------------ engine
TINY = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4)
#: each block's keys, and the optimizer the engine must build from it
OPTIMIZERS = {
    "Lamb": ({"weight_decay": 0.01, "max_coeff": 5.0, "min_coeff": 0.02},
             lambda: fused_lamb(weight_decay=0.01, max_coeff=5.0, min_coeff=0.02)),
    "OneBitAdam": ({"freeze_step": 2, "weight_decay": 0.01},
                   lambda: onebit.onebit_adam(weight_decay=0.01, freeze_step=2)),
    "ZeroOneAdam": ({"var_freeze_step": 2, "var_update_scaler": 2, "adam_w_mode": True,
                     "weight_decay": 0.01},
                    lambda: onebit.zero_one_adam(weight_decay=0.01, var_freeze_step=2,
                                                 var_update_scaler=2, adam_w_mode=True)),
    "OneBitLamb": ({"freeze_step": 2, "weight_decay": 0.01, "max_coeff": 3.0},
                   lambda: onebit.onebit_lamb(weight_decay=0.01, freeze_step=2,
                                              max_coeff=3.0)),
}


def _config(name, lr=1e-3):
    return {"train_batch_size": 8, "steps_per_print": 10**9, "gradient_clipping": 1.0,
            "optimizer": {"type": name, "params": {"lr": lr, **OPTIMIZERS[name][0]}}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_engine_builds_each_optimizer_from_its_block(name):
    """The engine's optimizer, built from the block's keys (the 1-bit keys,
    LAMB's bounds), takes the same 5 updates, bit for bit, as the one built
    directly with them."""
    engine = dst.initialize(model=torch_gpt2.gpt2_model(torch_gpt2.GPT2Config(**TINY)),
                            config=_config(name), device="cpu")[0]
    params, grads = _inputs(5)
    runs = []
    for opt in (engine.optimizer, OPTIMIZERS[name][1]()):
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        state = opt.init(tp)
        for g in grads:
            opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tp, 1e-2)
        runs.append({**_flat(state), **{f"p.{k}": v.numpy() for k, v in tp.items()}})
    assert sorted(runs[0]) == sorted(runs[1])
    for path, want in runs[1].items():
        np.testing.assert_array_equal(runs[0][path], want, err_msg=path)


@pytest.mark.parametrize("name", ["Lamb", "OneBitLamb"])
def test_engine_trajectory_matches_jax(name):
    """Both engines from one start: 5 steps on the same batches, past the
    freeze boundary, losses within 1e-5, the optimizer state's tree and
    step equal."""
    jcfg = jax_gpt2.GPT2Config(**TINY, dtype=jnp.float32, attention_impl="xla")
    jengine, _, _, _ = ds.initialize(model=jax_gpt2.gpt2_model(jcfg), config=_config(name))
    start = jax.tree_util.tree_map(np.array, jax.device_get(jengine.state.params))
    tcfg = torch_gpt2.GPT2Config(**TINY, dtype=torch.float32)
    sd = gpt2_params_from_jax(start, tcfg)
    model = dataclasses.replace(torch_gpt2.gpt2_model(tcfg), init_fn=lambda seed, device: sd)
    tengine, opt, _, _ = dst.initialize(model=model, config=_config(name), device="cpu")
    assert opt.name == jengine.optimizer.name
    rng = np.random.default_rng(0)
    for _ in range(5):
        ids = rng.integers(0, TINY["vocab_size"], (8, 32)).astype(np.int32)
        want = float(jengine.train_batch({"input_ids": ids}))
        assert abs(tengine.train_batch({"input_ids": ids}).item() - want) <= 1e-5
    jstate = state_tree(jax.device_get(jengine.state.opt_state))
    tstate = state_tree(tengine.state.opt_state)
    assert sorted(tstate) == sorted(jstate)
    assert int(tstate["step"]) == int(jstate["step"]) == 5


@pytest.mark.parametrize("name", ["Lamb", "OneBitAdam", "ZeroOneAdam", "OneBitLamb"])
def test_offload_tiers_refuse_them(name):
    config = dict(_config(name), zero_optimization={"stage": 2,
                                                    "offload_optimizer": {"device": "cpu"}})
    with pytest.raises(ValueError, match="offload tiers support adam/adamw/adagrad"):
        dst.initialize(model=torch_gpt2.gpt2_model(torch_gpt2.GPT2Config(**TINY)),
                       config=config, device="cpu")
