"""Config-driven activation checkpointing (recompute).

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``,
with its module-level API: :data:`POLICIES`, :func:`configure`,
:func:`is_configured`, :func:`checkpoint`, :func:`checkpoint_wrapper`,
:func:`reset` and :func:`model_parallel_cuda_manual_seed`. Where JAX has
``jax.checkpoint`` and its policies, this has
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` (the engine
differentiates with ``torch.autograd.grad``, which the reentrant variant does
not support) and a policy by the aten ops whose outputs it keeps:

- ``nothing_saveable``, ``full``: nothing is saved; the backward recomputes
  the whole function;
- ``dots``, ``dots_with_no_batch_dims_saveable``: the outputs of products
  with no batch dimension (``aten.mm``, ``aten.addmm``: a projection
  ``F.linear`` on ``(b, t, d)`` reaches these) are saved and everything else
  is recomputed, through ``create_selective_checkpoint_contexts``;
- ``dots_saveable``, ``checkpoint_dots``: the same, plus the batched products
  (``aten.bmm``, ``aten.baddbmm``);
- ``everything_saveable``: no recomputation: the function runs as it is;
- ``offload_dots``: what ``dots`` saves, kept in pinned host memory and copied
  back on the current stream for the backward (JAX's
  ``offload_dot_with_no_batch_dims("device", "pinned_host")``). Selective
  checkpointing keeps its saved outputs in a cache of its own, outside
  ``saved_tensors_hooks``, and torch's ``CPU_OFFLOAD`` policies are not acted
  on outside ``torch.compile``, so this policy has a pair of dispatch modes
  of its own (:class:`_SaveToHost`, :class:`_LoadFromHost`). On a CPU tensor
  the host is the device, and the output is kept as it is.

A hand-written kernel's output (the flash forward's, written through a raw
pointer into a ``torch.empty`` buffer) is never saved by a policy: only the
products above are, so the backward re-runs the kernel, as JAX's policies
re-run a ``pallas_call``. There is no RNG tracker: the port's randomness
comes from explicit generators, as JAX's comes from keys.
"""

import collections
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint as _torch_checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from ...utils.logging import logger

_aten = torch.ops.aten
NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
DOTS = NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default)
EVERYTHING = "everything"

_config = None

#: name → the ops whose outputs are saved (``()`` none, :data:`EVERYTHING` no
#: recompute) and where they are kept
POLICIES = {
    "nothing_saveable": ((), "device"),
    "full": ((), "device"),
    "dots": (NO_BATCH_DOTS, "device"),
    "dots_saveable": (DOTS, "device"),
    "dots_with_no_batch_dims_saveable": (NO_BATCH_DOTS, "device"),
    "checkpoint_dots": (DOTS, "device"),
    "everything_saveable": (EVERYTHING, "device"),
    # activation CPU offload (reference checkpoint_in_cpu / cpu_checkpointing):
    # the products are saved in pinned host memory and copied back for the
    # backward: the device memory of full remat, the compute of dots
    "offload_dots": (NO_BATCH_DOTS, "pinned_host"),
}


def _resolve_policy(name: str):
    if name not in POLICIES:
        raise ValueError(f"unknown activation-checkpointing policy {name!r}; "
                         f"known: {sorted(POLICIES)}")
    return POLICIES[name]


class _SaveToHost(TorchDispatchMode):
    """Forward of ``offload_dots``: each output of ``ops``, in order, copied
    to pinned host memory (kept as it is when it lies on the CPU)."""

    def __init__(self, ops, store):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            if out.device.type == "cpu":
                host = out.detach()
            else:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
            self.store.append((host, out.device))
        return out


class _LoadFromHost(TorchDispatchMode):
    """Recompute of ``offload_dots``: each op of ``ops`` takes its output from
    the store in the forward's order, copied back to its device on the
    current stream; every other op runs again."""

    def __init__(self, ops, store):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        if not self.store:
            raise RuntimeError(f"offload_dots: {func} has no saved output left: the "
                               "recompute ran more products than the forward, or a second "
                               "backward ran through the checkpoint")
        host, device = self.store.popleft()
        return host.to(device, non_blocking=True)


def _offload_contexts(ops):
    store = collections.deque()
    return _SaveToHost(ops, store), _LoadFromHost(ops, store)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Reference ``configure():831``: store the active config for
    :func:`checkpoint`. ``deepspeed_config`` is a ``DeepSpeedConfig`` (its
    ``activation_checkpointing`` block) or an ``ActivationCheckpointingConfig``;
    the keyword arguments override its keys. The keys the JAX package never
    acts on raise ``NotImplementedError`` set away from their defaults, here
    as in the config; ``mpu_`` (model parallelism) is not ported."""
    global _config
    from ...config.config import ActivationCheckpointingConfig
    if mpu_ is not None:
        raise NotImplementedError("configure(mpu_=...) (model parallelism) is not ported "
                                  "yet: ROADMAP.md queue 1 item 11")
    cfg = ActivationCheckpointingConfig()
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing", deepspeed_config)
    overrides = {"partition_activations": partition_activations,
                 "contiguous_memory_optimization": contiguous_checkpointing,
                 "number_checkpoints": num_checkpoints, "cpu_checkpointing": checkpoint_in_cpu,
                 "synchronize_checkpoint_boundary": synchronize, "profile": profile}
    _config = dataclasses.replace(cfg, **{k: v for k, v in overrides.items() if v is not None})
    logger.info(f"activation checkpointing configured: policy={_config.policy} "
                f"cpu_checkpointing={_config.cpu_checkpointing}")
    return _config


def is_configured() -> bool:
    return _config is not None


def _active_policy_name(policy: Optional[str]) -> str:
    if policy is not None:
        return policy
    if _config is not None:
        # checkpoint_in_cpu / cpu_checkpointing promotes the policy to host offload
        if _config.cpu_checkpointing:
            return "offload_dots"
        return _config.policy
    return "nothing_saveable"


def _wrap(function: Callable, name: str) -> Callable:
    saved, where = _resolve_policy(name)
    if saved is EVERYTHING:
        return function
    if not saved:
        return functools.partial(_torch_checkpoint, function, use_reentrant=False)
    if where == "pinned_host":
        context_fn = functools.partial(_offload_contexts, saved)
    else:
        context_fn = functools.partial(create_selective_checkpoint_contexts, list(saved))
    return functools.partial(_torch_checkpoint, function, use_reentrant=False,
                             context_fn=context_fn)


def checkpoint(function: Callable, *args, policy: Optional[str] = None) -> Any:
    """Recompute ``function``'s activations in the backward pass (reference
    ``checkpoint():749``). Usable before :func:`configure`: it then recomputes
    everything, like the reference's default config."""
    return _wrap(function, _active_policy_name(policy))(*args)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """Decorator form: a rematerialising version of ``function``, with the
    policy active when it is wrapped."""
    return _wrap(function, _active_policy_name(policy))


def reset():
    """Reference ``reset()``: clears the module-level config, so
    :func:`checkpoint` returns to the unconfigured default. Nothing else is
    buffered between iterations."""
    global _config
    _config = None


def model_parallel_cuda_manual_seed(seed: int):
    """Reference RNG-tracker API, a no-op as in the JAX package: the port's
    randomness comes from explicit generators. Kept for source
    compatibility."""
