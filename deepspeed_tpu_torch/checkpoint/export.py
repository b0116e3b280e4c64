"""Checkpoint export to the reference DeepSpeed formats.

Counterpart of ``deepspeed_tpu/checkpoint/export.py``: write a trained
engine's state out so a run can move to reference DeepSpeed tooling.

- :func:`export_universal_checkpoint`: the reference *universal checkpoint*
  layout (``zero/<param_name>/{fp32,exp_avg,exp_avg_sq}.pt``, each
  ``{"param": tensor, "cat_dim": 0}``, the per-file contract of the
  reference's ``universal_checkpoint.py:load_hp_checkpoint_state``), plus an
  ``mp_rank_00_model_states.pt`` with the module weights and
  ``param_shapes``, which :class:`~.deepspeed_checkpoint.DeepSpeedCheckpoint`
  (in either package) reads back;
- :func:`export_fp32_state_dict`: one consolidated ``pytorch_model.bin``
  (``utils/zero_to_fp32.py``'s output: a flat state dict of f32 weights).

Names are the engine's parameter names (``h.0.c_attn.weight``, ...). The
iteration is ``engine.global_steps``, not Adam's step: under fp16 a skipped
step advances the former only, and a resumed run schedules its LR and data
by the former. An offload engine's f32 masters and moments come from its
host tier (its device parameters are compute-dtype copies), as in JAX's
``export.py:95-115``; a ZeRO-3 parameter-offload engine's from its
coordinator (JAX ``export.py:62-80``; Adagrad's ``sq_sum`` is left out, as
there). ``consolidate_partitioned_checkpoint`` and the pipeline export wait
for ROADMAP.md queue 1 items 11 and 13.
"""

import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from ..utils.logging import logger

PARAM = "param"
CAT_DIM = "cat_dim"
FP32_NAME = "fp32"
EXP_AVG = "exp_avg"
EXP_AVG_SQ = "exp_avg_sq"

Named = Dict[str, torch.Tensor]


def _host_f32(named: Named) -> Named:
    """f32 host copies (one tensor at a time on the device side)."""
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in named.items()}


def _host_tier(engine):
    """The host tier that holds the engine's masters: parameter offload's
    coordinator or the optimizer tier, else None."""
    return (getattr(engine, "_param_offload", None)
            or getattr(engine, "_offload_tier", None))


def _engine_masters(engine) -> Named:
    """The engine's f32 weights by name: the host tier's masters under offload."""
    tier = _host_tier(engine)
    if tier is None:
        return _host_f32(engine.state.params)
    return {n: m.clone() for n, m in tier.named_masters().items()}


def _gather_engine_state(engine) -> Tuple[Named, Optional[Named], Optional[Named], int]:
    """(f32 params, exp_avg, exp_avg_sq, iteration), by parameter name."""
    params = _engine_masters(engine)
    tier = _host_tier(engine)
    if tier is not None:
        ms = vs = None
        if tier.nvme is not None:
            ms, vs = tier.nvme.read_moments()
        elif tier.opt is not None:
            ms, vs = tier.opt.m, tier.opt.v
        if ms is not None:
            return (params, {n: m.view(params[n].shape).clone() for n, m in zip(params, ms)},
                    {n: v.view(params[n].shape).clone() for n, v in zip(params, vs)},
                    engine.global_steps)
    else:
        opt = engine.state.opt_state
        if hasattr(opt, "exp_avg") and hasattr(opt, "exp_avg_sq"):
            return (params, _host_f32(opt.exp_avg), _host_f32(opt.exp_avg_sq),
                    engine.global_steps)
    logger.warning("universal export: optimizer state has no exp_avg/exp_avg_sq — the "
                   "checkpoint carries weights only and a torch-side resume restarts "
                   "optimizer state from zero")
    return params, None, None, engine.global_steps


def _unflatten(named: Named) -> dict:
    """Dotted names back to a nested dict (the mp_rank module payload)."""
    root: dict = {}
    for name, t in named.items():
        *parents, leaf = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return root


def _write_universal(params: Named, m_named: Optional[Named], v_named: Optional[Named],
                     step: int, save_dir: str, tag: str) -> str:
    """The writer behind :func:`export_universal_checkpoint` (its layout)."""
    path = os.path.join(save_dir, str(tag))
    zero_dir = os.path.join(path, "zero")
    os.makedirs(zero_dir, exist_ok=True)
    for name, t in params.items():
        pdir = os.path.join(zero_dir, name)
        os.makedirs(pdir, exist_ok=True)
        torch.save({PARAM: t, CAT_DIM: 0}, os.path.join(pdir, f"{FP32_NAME}.pt"))
        if m_named is not None and name in m_named:
            torch.save({PARAM: m_named[name], CAT_DIM: 0}, os.path.join(pdir, f"{EXP_AVG}.pt"))
            torch.save({PARAM: v_named[name], CAT_DIM: 0},
                       os.path.join(pdir, f"{EXP_AVG_SQ}.pt"))
    shapes = OrderedDict((n, tuple(t.shape)) for n, t in params.items())
    torch.save({"module": _unflatten(params), "param_shapes": shapes, "iteration": step,
                "dp_world_size": 1, "mp_world_size": 1},
               os.path.join(path, "mp_rank_00_model_states.pt"))
    with open(os.path.join(save_dir, "latest_universal"), "w") as f:
        f.write(str(tag))
    logger.info(f"universal checkpoint exported to {path} ({len(params)} params, step {step})")
    return path


def export_universal_checkpoint(engine, save_dir: str, tag: str = "universal") -> str:
    """Write the engine's state as a reference universal checkpoint.

    Layout under ``save_dir/tag``::

        zero/<param_name>/fp32.pt         {"param": f32 tensor, "cat_dim": 0}
        zero/<param_name>/exp_avg.pt      (when Adam moments exist)
        zero/<param_name>/exp_avg_sq.pt
        mp_rank_00_model_states.pt        module weights + param_shapes + iteration
        latest_universal                  tag pointer (in save_dir)

    Returns the path."""
    params, m_named, v_named, step = _gather_engine_state(engine)
    return _write_universal(params, m_named, v_named, step, save_dir, tag)


def export_fp32_state_dict(engine, out_file: str) -> Named:
    """The engine's f32 weights as one torch state dict file (``zero_to_fp32``'s
    ``pytorch_model.bin`` format). Returns the dict."""
    sd = OrderedDict(_engine_masters(engine))
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    torch.save(sd, out_file)
    logger.info(f"fp32 state dict ({len(sd)} tensors) written to {out_file}")
    return sd
