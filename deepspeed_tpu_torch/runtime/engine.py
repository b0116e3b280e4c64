"""Training engine on one card.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``). The
engine keeps f32 master parameters, the optimizer state and the loss-scaler
state on the device. ``train_batch`` splits a batch into
``gradient_accumulation_steps`` micro-batches, and for each one casts the
masters to the compute dtype, runs the model's loss and differentiates the
scaled loss with respect to the masters (``torch.autograd.grad``), so the
gradients arrive in f32 and are summed in f32. Then it unscales by
``scale * gas``, optionally prescales, takes the global norm, clips, runs the
optimizer and updates the loss scaler. Under fp16 an overflow keeps the old
parameters and optimizer state, decided on the device. Nothing in a step reads
a value back to the host except the log line of a ``steps_per_print`` step:
``train_batch`` returns the mean loss as a device tensor.

The ``forward``/``backward``/``step`` triple does the same work a
micro-batch at a time. ZeRO stages 1-3 on one card partition over a
data-parallel group of one, so each is stage 0.

Every ``loss_fn`` call gets a key of the training random stream
(``runtime/rng.py``), derived on the host as the JAX engine derives its
threefry keys (``engine.py:607-613, 1174-1175, 1258-1263``): ``fold_in(base,
step)`` and then the micro-batch's index (``train_batch``) or the count of
micro-batches so far (``forward``), and a stream of its own for
``eval_batch``. The step is the host counter ``_host_steps``, which advances
on an fp16 overflow skip as ``global_step`` does and which
``load_checkpoint`` restores, so no step reads the device for a key. Dropout
and MoE gating noise draw from it.

``training_data`` (with ``collate_fn`` and ``dataloader_drop_last``) builds a
``runtime/dataloader.py:DeepSpeedDataLoader`` of micro-batches, one replica;
``train_batch()`` with no batch draws ``gradient_accumulation_steps`` of them.

ZeRO-Offload (``zero_optimization.offload_optimizer``, device ``cpu`` or
``nvme``; JAX ``engine.py:139-145, 398-423``) hands the freshly built f32
parameters to ``runtime/zero/offload.py:OffloadOptimizerTier``, which keeps
the masters and the optimizer state in host memory; ``TrainState.params``
become compute-dtype leaves and ``opt_state`` is empty. A step differentiates
with respect to those leaves, sums the gradients in f32 on the device, and
``_finalize_grads_offload`` unscales, prescales, takes the norm and overflow,
clips and updates the loss scaler there, then casts the gradients to the
transfer dtype; ``_host_optimizer_step`` runs the host step, which pushes each
updated leaf back. Under fp16 it reads the overflow flag on the host (its one
synchronise) and a skipped step leaves the masters alone.

``save_checkpoint`` and ``load_checkpoint`` follow the JAX engine's protocol
(``runtime/checkpoint_engine``): a tag holds every tensor of ``TrainState``
(``state/``, torch shards written from host copies) and the host counters,
the LR schedule and the client state (``client_state.pkl``), and is published
by one atomic rename before ``latest`` moves. A load validates the manifest,
reads everything to the host and checks it against the engine's state before
it copies a tensor in, so it never leaves half a state; the copies go into the
engine's own tensors. :class:`CheckpointAutoSaver` saves on an interval and on
SIGTERM. An offload engine's tags hold the tier's state too
(``offload_state``). Not ported yet (each raises ``NotImplementedError``
naming its ``ROADMAP.md`` queue-1 item): parameter offload (item 12b), the
monitor and flops profiler (item 9), pipelines (item 13) and data
parallelism (item 11).
"""

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..accelerator import resolve_device
from ..config.config import ADAM_TYPES, LAMB_TYPES, DeepSpeedConfig
from ..models.base import Model
from ..observability.trace import CAT_TRAIN, get_tracer
from ..ops.adagrad import adagrad
from ..ops.adam.fused_adam import fused_adam
from ..ops.lamb import fused_lamb
from ..ops.optimizer import Optimizer
from ..utils.fault_injection import fault_point
from ..utils.logging import log_dist, logger
from . import rng as rng_stream
from .checkpoint_engine.checkpoint_engine import (LATEST_FILE, CheckpointCorruptionError,
                                                  find_latest_committed_tag,
                                                  is_committed_tag, make_checkpoint_engine,
                                                  validate_manifest, write_latest_pointer)
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, concat_micro_batches
from .fp16.onebit import onebit_adam, onebit_lamb, zero_one_adam
from .fp16.loss_scaler import LossScaleState, create_loss_scaler
from .lr_schedules import get_lr_scheduler
from .utils import clip_by_global_norm, count_parameters, global_norm


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]     # f32 masters (offload: compute dtype), requires_grad
    opt_state: Any                      # offload: {} (the state is on the host)
    scaler: LossScaleState
    global_step: torch.Tensor           # i32 0-d
    skipped_steps: torch.Tensor         # i32 0-d


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1 {item}")


def state_tree(x) -> Any:
    """``TrainState`` as the nested dict of tensors a tag holds: each NamedTuple
    (the state, ``AdamState``, ``LossScaleState``) becomes a dict of its
    fields."""
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: state_tree(v) for k, v in x.items()}
    return x


def _check_like(current, restored, where: str, path: str = "") -> None:
    """``restored`` has ``current``'s keys, shapes and dtypes, or this raises
    naming what differs."""
    if isinstance(current, torch.Tensor):
        if not isinstance(restored, torch.Tensor) or restored.shape != current.shape \
                or restored.dtype != current.dtype:
            got = (f"{tuple(restored.shape)} {restored.dtype}"
                   if isinstance(restored, torch.Tensor) else type(restored).__name__)
            raise ValueError(f"checkpoint {where}: {path} is {got}, the engine's is "
                             f"{tuple(current.shape)} {current.dtype}")
        return
    if not isinstance(restored, dict):
        raise ValueError(f"checkpoint {where}: {path} is a {type(restored).__name__}, "
                         "not a dict")
    missing = sorted(set(current) - set(restored))
    extra = sorted(set(restored) - set(current))
    if missing or extra:
        raise ValueError(f"checkpoint {where} does not match the engine's state at "
                         f"{path or 'the top'}: missing {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}, unexpected {extra[:8]}"
                         f"{'...' if len(extra) > 8 else ''}")
    for key in current:
        _check_like(current[key], restored[key], where, f"{path}.{key}" if path else key)


@torch.no_grad()
def _copy_into(current, restored) -> None:
    """Write ``restored`` (host tensors) into the engine's own tensors, so any
    reference to them stays valid and no second copy lands on the device."""
    if isinstance(current, torch.Tensor):
        current.copy_(restored)
        return
    for key in current:
        _copy_into(current[key], restored[key])


class DeepSpeedEngine:
    def __init__(self, args=None, model: Optional[Model] = None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None, mpu=None,
                 collate_fn=None, config=None, device=None, seed: int = 42):
        if not isinstance(model, Model):
            raise TypeError("model must be a deepspeed_tpu_torch.models.Model "
                            f"(see models.gpt2.gpt2_model), got {type(model).__name__}")
        if mpu is not None:
            raise _unported("mpu= (model parallelism)", "item 11")
        self.module = model
        self.args = args
        self.collate_fn = collate_fn
        self._base_key = rng_stream.root_key(seed)
        self._eval_calls = 0
        self.device = resolve_device(device)
        self._config = (config if isinstance(config, DeepSpeedConfig)
                        else DeepSpeedConfig(config))
        self.zero_stage = self._config.zero_config.stage
        self.offload_enabled = self._config.zero_config.offload_optimizer.enabled
        self._offload_tier = None

        if self._config.fp16.enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16.enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self.loss_scaler, scaler_state0 = create_loss_scaler(self._config.fp16, self.device)

        self.optimizer = self._configure_optimizer(optimizer)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self._build_state(scaler_state0, seed)
        self.checkpoint_engine = make_checkpoint_engine(self._config.checkpoint_config)
        self.training_dataloader = self._configure_dataloader(training_data)
        self._train_iter = None

        self.micro_steps = 0
        self._host_steps = 0        # host mirror of state.global_step (no device read)
        self._grad_acc: Optional[List[torch.Tensor]] = None
        self._cached_loss: Optional[torch.Tensor] = None
        self._last_metrics: Dict[str, Any] = {}
        log_dist(f"engine ready: model={model.name} "
                 f"params={count_parameters(self.state.params):,} zero_stage={self.zero_stage} "
                 f"dtype={str(self.compute_dtype)[6:]} device={self.device} "
                 f"batch={self.train_batch_size()}(micro="
                 f"{self.train_micro_batch_size_per_gpu()}×gas="
                 f"{self.gradient_accumulation_steps()})", ranks=[0])

    # ------------------------------------------------------------------ config
    def _configure_optimizer(self, optimizer) -> Optional[Optimizer]:
        """The device optimizer; None under offload, whose tier is built in
        ``_build_state``."""
        if optimizer is not None:
            if self.offload_enabled:
                raise ValueError("zero_optimization.offload_optimizer needs a config-declared "
                                 "optimizer (adam/adamw/adagrad), not an optimizer object")
            if isinstance(optimizer, Optimizer):
                return optimizer
            raise TypeError(f"unsupported optimizer object {optimizer!r}: pass a "
                            "deepspeed_tpu_torch.ops.optimizer.Optimizer or configure one")
        name = self._config.optimizer_name or "adam"
        oc = self._config.optimizer_params
        self._base_lr = oc.lr
        if self.offload_enabled:
            if name not in ADAM_TYPES + ("adagrad",):
                raise ValueError(f"offload tiers support adam/adamw/adagrad, got {name!r}")
            return None
        adam_w = name == "adamw" or bool(oc.adam_w_mode)
        if name == "adagrad":
            return adagrad(eps=oc.eps, weight_decay=oc.weight_decay)
        if name in ADAM_TYPES:
            return fused_adam(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                              adam_w_mode=adam_w, bias_correction=oc.bias_correction)
        if name in LAMB_TYPES:
            return fused_lamb(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                              max_coeff=oc.max_coeff, min_coeff=oc.min_coeff)
        if name == "onebitadam":
            return onebit_adam(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                               freeze_step=oc.freeze_step, adam_w_mode=adam_w)
        if name == "onebitlamb":
            return onebit_lamb(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                               freeze_step=oc.freeze_step, max_coeff=oc.max_coeff,
                               min_coeff=oc.min_coeff)
        if name == "zerooneadam":
            return zero_one_adam(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                                 var_freeze_step=oc.var_freeze_step,
                                 var_update_scaler=oc.var_update_scaler, adam_w_mode=adam_w)
        raise ValueError(f"unknown optimizer {name!r}")

    def _configure_dataloader(self, training_data):
        """JAX ``engine.py:352-362`` with one replica: an iterable without
        ``__getitem__`` repeats as it is; an indexable dataset is batched into
        micro-batches."""
        if training_data is None:
            return None
        if hasattr(training_data, "__iter__") and not hasattr(training_data, "__getitem__"):
            return RepeatingLoader(training_data)
        return DeepSpeedDataLoader(training_data,
                                   batch_size=self.train_micro_batch_size_per_gpu(),
                                   collate_fn=self.collate_fn,
                                   drop_last=self._config.dataloader_drop_last)

    def _configure_lr_scheduler(self, lr_scheduler):
        if lr_scheduler is not None:
            return lr_scheduler
        if self._config.scheduler_name:
            return get_lr_scheduler(self._config.scheduler_name,
                                    self._config.scheduler_params)
        return None

    def _build_state(self, scaler_state0: LossScaleState, seed: int) -> None:
        params = self.module.init(seed, self.device)
        params = {k: p.detach().to(self.device, torch.float32, copy=True).requires_grad_(
                  not self.offload_enabled) for k, p in params.items()}
        if self.offload_enabled:
            self._offload_tier = self._build_offload_tier(params)
            del params          # the tier holds the masters; the device frees the f32 copies
            params = {k: p.requires_grad_()
                      for k, p in self._offload_tier.initial_device_params().items()}
            opt_state = {}
        else:
            opt_state = self.optimizer.init(params)
        self.state = TrainState(
            params=params, opt_state=opt_state, scaler=scaler_state0,
            global_step=torch.zeros((), dtype=torch.int32, device=self.device),
            skipped_steps=torch.zeros((), dtype=torch.int32, device=self.device))

    def _build_offload_tier(self, params: Dict[str, torch.Tensor]):
        """JAX ``engine.py:398-423``: the host tier from the optimizer block and
        ``offload_optimizer`` (nvme: Adam only, moments under ``nvme_path``)."""
        from .zero.offload import OffloadOptimizerTier
        name = self._config.optimizer_name or "adam"
        oc = self._config.optimizer_params
        off = self._config.zero_config.offload_optimizer
        kind = "adagrad" if name == "adagrad" else "adam"
        if off.device == "nvme" and kind != "adam":
            raise ValueError("nvme offload supports adam/adamw only")
        aio = self._config.aio_config
        return OffloadOptimizerTier(
            params, self.compute_dtype, kind=kind, betas=oc.betas, eps=oc.eps,
            weight_decay=oc.weight_decay,
            adam_w_mode=name == "adamw" or bool(oc.adam_w_mode),
            bias_correction=oc.bias_correction,
            nvme_path=off.nvme_path if off.device == "nvme" else None,
            aio_config={"thread_count": aio.thread_count, "block_size": aio.block_size,
                        "queue_depth": aio.queue_depth})

    # --------------------------------------------------------------- internals
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Batch leaves (numpy or tensors) on the engine's device. Host data goes
        through pinned memory without blocking, so the copy does not wait on
        the card."""
        out = {}
        for key, leaf in batch.items():
            x = torch.as_tensor(leaf)
            if x.device != self.device:
                if self.device.type == "cuda":
                    x = x.pin_memory().to(self.device, non_blocking=True)
                else:
                    x = x.to(self.device)
            out[key] = x
        return out

    def _loss(self, batch: Dict[str, torch.Tensor], key: int) -> torch.Tensor:
        """The micro-batch loss under the random stream's ``key``, from the
        masters cast to the compute dtype (under offload the parameters are in
        it already)."""
        cast = {k: p.to(self.compute_dtype) for k, p in self.state.params.items()}
        loss = self.module.loss_fn(cast, batch, key)
        return loss[0] if isinstance(loss, tuple) else loss

    def _step_key(self) -> int:
        return rng_stream.fold_in(self._base_key, self._host_steps)

    def _next_train_batch(self) -> Dict[str, Any]:
        """``gradient_accumulation_steps`` micro-batches of the dataloader,
        joined along the leading axis (JAX ``engine.py:1149-1155``)."""
        if self._train_iter is None:
            loader = self.training_dataloader
            self._train_iter = (loader if hasattr(loader, "__next__")
                                else iter(RepeatingLoader(loader)))
        return concat_micro_batches([next(self._train_iter)
                                     for _ in range(self.gradient_accumulation_steps())])

    def _accumulate(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss * scale`` with respect to the parameters (the
        masters, or under offload the compute-dtype leaves), summed in f32 into
        the accumulator."""
        scale = self.state.scaler.cur_scale
        grads = torch.autograd.grad(loss * scale.to(loss.dtype),
                                    list(self.state.params.values()))
        if self._grad_acc is None:
            self._grad_acc = [g.float() for g in grads]
        else:
            for acc, g in zip(self._grad_acc, grads):
                acc.add_(g.float())

    def _unscale_clip_and_check(self, n_micro: int):
        """Both update paths' device-side start (JAX ``engine.py:540``): unscale
        the accumulator by ``scale * n_micro``, prescale, global norm, fp16's
        overflow flag, clip. Returns (grads, norm, overflow)."""
        cfg, scale = self._config, self.state.scaler.cur_scale
        grads = [g / (scale * float(n_micro)) for g in self._grad_acc]
        self._grad_acc = None
        if cfg.prescale_gradients:
            grads = [g / float(cfg.gradient_predivide_factor) for g in grads]
        norm = global_norm(grads)
        if cfg.fp16.enabled:
            overflow = torch.logical_not(torch.isfinite(norm))
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if cfg.gradient_clipping > 0:
            safe_norm = torch.where(torch.isfinite(norm), norm, torch.ones_like(norm))
            grads = clip_by_global_norm(grads, cfg.gradient_clipping, norm=safe_norm)
        return grads, norm, overflow

    def _step_counters(self, overflow: torch.Tensor) -> None:
        state = self.state
        self.state = state._replace(scaler=self.loss_scaler.update(state.scaler, overflow),
                                    global_step=state.global_step + 1,
                                    skipped_steps=state.skipped_steps + overflow.int())

    def _apply_update(self, lr: float, n_micro: int) -> Dict[str, torch.Tensor]:
        """Unscale, prescale, global norm, overflow check, clip, optimizer step,
        scaler step; every decision stays on the device."""
        state, scale = self.state, self.state.scaler.cur_scale
        grads, norm, overflow = self._unscale_clip_and_check(n_micro)
        # bf16 and f32 cannot overflow-skip: their keep-old would be a no-op
        self.optimizer.update(dict(zip(state.params, grads)), state.opt_state, state.params,
                              lr, keep=overflow if self._config.fp16.enabled else None)
        self._step_counters(overflow)
        return {"grad_norm": norm, "overflow": overflow, "loss_scale": scale}

    def _finalize_grads_offload(self, n_micro: int):
        """The offload step's device side (JAX ``engine.py:580-600``): as
        :meth:`_apply_update` up to the clip, then the scaler and the step
        counters, and the gradients cast to the transfer dtype (bf16 for bf16
        runs; fp16's narrow exponent would flush small gradients, so fp16 and
        f32 runs send f32). Returns (gradients, metrics)."""
        scale = self.state.scaler.cur_scale
        grads, norm, overflow = self._unscale_clip_and_check(n_micro)
        self._step_counters(overflow)
        dtype = self._offload_tier.transfer_dtype
        return [g.to(dtype) for g in grads], {"grad_norm": norm, "overflow": overflow,
                                              "loss_scale": scale}

    def _host_optimizer_step(self, grads, lr: float, metrics) -> None:
        """The host step (JAX ``engine.py:1052-1061``). Under fp16 the overflow
        flag is read on the host, the step's one synchronise; a skipped step
        leaves the masters and the tier's step count alone."""
        skip = bool(metrics["overflow"]) if self._config.fp16.enabled else False
        self._offload_tier.step(grads, lr, skip=skip)

    def _update(self, lr: float, n_micro: int) -> Dict[str, torch.Tensor]:
        """The optimizer step at a boundary: on the device, or through the tier."""
        if not self.offload_enabled:
            return self._apply_update(lr, n_micro)
        grads, metrics = self._finalize_grads_offload(n_micro)
        self._host_optimizer_step(grads, lr, metrics)
        return metrics

    def _finish_step(self, metrics: Dict[str, torch.Tensor]) -> None:
        self._host_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._last_metrics = metrics

    # ------------------------------------------------------------------- API
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """One global batch (``gradient_accumulation_steps`` micro-batches along
        the leading axis) and one optimizer step. Returns the mean micro-batch
        loss as a 0-d device tensor."""
        if batch is None:
            if data_iter is not None:
                batch = next(data_iter)
            elif self.training_dataloader is not None:
                batch = self._next_train_batch()
            else:
                raise ValueError("train_batch needs batch=, data_iter=, or training_data")
        gas = self.gradient_accumulation_steps()
        batch = self._to_device(batch)
        for key, x in batch.items():
            if x.shape[0] % gas:
                raise ValueError(f"train_batch: {key!r} leading dim {x.shape[0]} is not "
                                 f"divisible by gradient_accumulation_steps {gas}")
        lr = self.get_lr_value()
        step_key = self._step_key()
        losses = []
        for i in range(gas):
            micro = {k: x.reshape(gas, x.shape[0] // gas, *x.shape[1:])[i]
                     for k, x in batch.items()}
            loss = self._loss(micro, rng_stream.fold_in(step_key, i))
            self._accumulate(loss)
            losses.append(loss.detach())
        metrics = self._update(lr, gas)
        metrics["loss"] = torch.stack(losses).mean()
        self.micro_steps += gas
        self._finish_step(metrics)
        if self._host_steps % self._config.steps_per_print == 0:     # the one host read
            log_dist(f"step={self._host_steps} loss={float(metrics['loss']):.4f} "
                     f"lr={lr:.3e} loss_scale={float(metrics['loss_scale']):.0f}", ranks=[0])
        return metrics["loss"]

    def forward(self, batch) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph to the masters
        (consumed by :meth:`backward`). Its key folds the count of
        micro-batches so far into the step's, as JAX's ``forward`` does."""
        key = rng_stream.fold_in(self._step_key(), self.micro_steps)
        self._cached_loss = self._loss(self._to_device(batch), key)
        return self._cached_loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Add the gradients of ``loss`` (default: the last :meth:`forward`'s)
        to the accumulator."""
        loss = self._cached_loss if loss is None else loss
        if loss is None:
            raise RuntimeError("backward() called before forward()")
        self._accumulate(loss)
        self._cached_loss = None
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() == 0

    def step(self) -> None:
        """An optimizer step at a gradient-accumulation boundary; otherwise only
        counts the micro-batch."""
        take_step = self.is_gradient_accumulation_boundary()
        self.micro_steps += 1
        if not take_step:
            return
        if self._grad_acc is None:
            raise RuntimeError("step() called with no accumulated gradients")
        self._finish_step(self._update(self.get_lr_value(), self.gradient_accumulation_steps()))

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of ``batch`` without a step. As in the JAX engine,
        ``loss_fn`` runs as in training (dropout on) under a key of the eval
        stream, disjoint from every training step's."""
        self._eval_calls += 1
        key = rng_stream.fold_in(rng_stream.fold_in(self._base_key, rng_stream.EVAL_STREAM),
                                 self._eval_calls)
        return self._loss(self._to_device(batch), key)

    # ------------------------------------------------------------- accessors
    @property
    def global_steps(self) -> int:
        return int(self.state.global_step)

    @property
    def skipped_steps(self) -> int:
        return int(self.state.skipped_steps)

    def get_global_grad_norm(self) -> float:
        return float(self._last_metrics.get("grad_norm", 0.0))

    def loss_scale(self) -> float:
        return float(self.state.scaler.cur_scale)

    def get_lr_value(self) -> float:
        if self.lr_scheduler is not None:
            if self.lr_scheduler.last_batch_iteration < 0:
                self.lr_scheduler.step(0)
            return float(self.lr_scheduler.get_last_lr()[0])
        return float(getattr(self, "_base_lr", 1e-3))

    def get_lr(self) -> List[float]:
        return [self.get_lr_value()]

    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_batch_info(self):
        return (self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    # ------------------------------------------------------------ checkpointing
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True) -> str:
        """Reference ``engine.py:3085``. Every tensor of the state (staged under
        ``<save_dir>/<tag>.tmp/state``, from host copies taken before this
        returns) and the host-side counters, LR schedule and ``client_state``
        (``client_state.pkl``); then ``commit_tag`` (manifest + fsync + one
        atomic rename) and only after it the ``latest`` pointer, so a kill at
        any point leaves the previous committed tag loadable. Returns the tag's
        directory."""
        tag = tag or f"global_step{self.global_steps}"
        ckpt = self.checkpoint_engine
        path = ckpt.begin_tag(save_dir, tag)
        fault_point("ckpt.save.begin")
        ckpt.save(state_tree(self.state), os.path.join(path, "state"))
        if self.offload_enabled:
            # the host tier's masters and state (JAX engine.py:1422-1427); the
            # NVMe tier copies its moment files, never through host memory
            self._offload_tier.save_to(ckpt, os.path.join(path, "offload_state"))
        side = {
            "global_step": self.global_steps,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None else None),
            "client_state": client_state or {},
        }
        ckpt.save(side, os.path.join(path, "client_state.pkl"))
        tracer = get_tracer()
        span = tracer.begin("checkpoint_commit", cat=CAT_TRAIN,
                            attrs={"tag": str(tag), "step": self._host_steps})
        final = ckpt.commit_tag(save_dir, tag)
        if save_latest:
            t0 = time.perf_counter()
            write_latest_pointer(save_dir, tag)
            ckpt.add_time("rename_s", t0)
        tracer.end_span(span)
        return final

    def _resolve_load_tag(self, load_dir: str, tag: Optional[str]) -> Optional[str]:
        """An explicit ``tag`` is trusted (validation still runs at load);
        otherwise follow ``latest``, and when it names a missing or uncommitted
        tag fall back to the newest committed tag on disk."""
        if tag is not None:
            return str(tag)
        latest_path = os.path.join(load_dir, LATEST_FILE)
        pointed = None
        if os.path.isfile(latest_path):
            with open(latest_path) as f:
                pointed = f.read().strip()
        if pointed and is_committed_tag(load_dir, pointed):
            return pointed
        fallback = find_latest_committed_tag(load_dir, exclude=pointed)
        if fallback is not None:
            if pointed:
                logger.error(f"[ckpt] '{LATEST_FILE}' points at {pointed!r} which is "
                             "missing or uncommitted — falling back to newest committed "
                             f"tag {fallback!r}")
            return fallback
        # nothing committed to fall back to: a torn tag surfaces at load
        return pointed or None

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False,
                        validate: bool = True):
        """Reference ``engine.py:2725``. Returns ``(path, client_state)``, or
        ``(None, {})`` when ``load_dir`` holds no committed tag.

        The manifest is validated first (``CheckpointCorruptionError`` names the
        offending file); then the state and side data are read to the host and
        checked against the engine's state; only then is anything copied in.
        ``load_module_only`` or ``load_optimizer_states=False`` take the
        parameters and ``global_step`` and keep the engine's optimizer state,
        loss scaler and skipped-step count, as the JAX engine does. The host
        step mirror and ``micro_steps`` follow the checkpoint; the LR schedule
        too unless ``load_lr_scheduler_states=False``. An offload engine
        restores its tier from the tag's ``offload_state`` (read and checked
        with the rest, before anything is copied) and pushes the masters;
        for a module-only load, or a tag without the tier, it reseeds the
        masters from the loaded parameters (JAX ``engine.py:1548-1561``)."""
        resolved = self._resolve_load_tag(load_dir, tag)
        if resolved is None:
            logger.warning(f"No '{LATEST_FILE}' file at {load_dir} and no committed tags "
                           "found; nothing loaded")
            return None, {}
        path = os.path.join(load_dir, resolved)
        if not os.path.isdir(path):
            raise CheckpointCorruptionError(f"checkpoint tag {resolved!r} does not exist "
                                            f"under {load_dir}")
        ckpt = self.checkpoint_engine
        ckpt.timings = {}
        t0 = time.perf_counter()
        if validate:
            validate_manifest(path)
        ckpt.add_time("validate_s", t0)
        fault_point("ckpt.load.begin")
        restored = ckpt.load(os.path.join(path, "state"))
        side = ckpt.load(os.path.join(path, "client_state.pkl"))
        current = state_tree(self.state)
        if self.offload_enabled and isinstance(restored.get("params"), dict):
            # an in-device engine's tag holds f32 masters: they load as the
            # compute-dtype device copies, which reseed the masters below
            restored["params"] = {k: v.to(self.compute_dtype) if isinstance(v, torch.Tensor)
                                  and v.dtype == torch.float32 else v
                                  for k, v in restored["params"].items()}
        if load_module_only or not load_optimizer_states:
            current = {k: current[k] for k in ("params", "global_step")}
            restored = {k: restored.get(k) for k in current}
        _check_like(current, restored, path)
        offload = None
        if self.offload_enabled and load_optimizer_states and not load_module_only \
                and self._offload_tier.has_checkpoint(os.path.join(path, "offload_state")):
            offload = self._offload_tier.read_checkpoint(ckpt, os.path.join(path,
                                                                             "offload_state"))
        t0 = time.perf_counter()
        _copy_into(current, restored)
        if offload is not None:
            # the masters are the truth under offload: the device copies follow them
            self._offload_tier.install(offload)
            self._offload_tier.push()
        elif self.offload_enabled:
            # else the next host step would overwrite the loaded weights with
            # the init-time masters
            self._offload_tier.reseed_from_device(self.state.params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ckpt.add_time("h2d_s", t0)
        self._host_steps = int(self.state.global_step)
        self.micro_steps = side.get("micro_steps", 0)
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and side.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(side["lr_scheduler"])
        log_dist(f"loaded checkpoint {path} at global_step={self._host_steps}", ranks=[0])
        return path, side.get("client_state", {})


class CheckpointAutoSaver:
    """Preemption-aware automatic checkpointing around a :class:`DeepSpeedEngine`
    (JAX ``runtime/engine.py:1580``).

    - every ``interval_steps`` optimizer steps, ``after_step()`` saves a tag;
    - on SIGTERM the handler only sets a flag; the save happens at the next
      ``after_step()``, a step boundary where the state is consistent; then a
      ``preempted`` marker naming the tag is written and
      ``SystemExit(128 + SIGTERM)`` is raised so the scheduler restarts the job,
      which resumes through ``resume()``.

    Usage::

        saver = CheckpointAutoSaver(engine, save_dir, interval_steps=100)
        saver.resume()                     # load the latest committed tag, if any
        with saver:                        # installs the SIGTERM handler
            for batch in data:
                engine.train_batch(batch)
                saver.after_step()
    """

    PREEMPT_MARKER = "preempted"

    def __init__(self, engine, save_dir: str, interval_steps: int = 0,
                 tag_prefix: str = "global_step", exit_on_preempt: bool = True,
                 client_state_fn: Optional[Callable[[], dict]] = None):
        self.engine = engine
        self.save_dir = save_dir
        self.interval_steps = int(interval_steps)
        self.tag_prefix = tag_prefix
        self.exit_on_preempt = exit_on_preempt
        self.client_state_fn = client_state_fn
        self._preempt = threading.Event()
        self._prev_handler = None
        self._installed = False
        self.last_saved_tag: Optional[str] = None

    def install(self) -> "CheckpointAutoSaver":
        """Install the SIGTERM handler (main thread only; it only sets a flag)."""
        self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev_handler or signal.SIG_DFL)
            self._installed = False

    def __enter__(self) -> "CheckpointAutoSaver":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_sigterm(self, signum, frame):
        logger.warning("[autosave] SIGTERM received — checkpoint at next step boundary, "
                       "then exit for scheduler restart")
        self._preempt.set()

    @property
    def preempted(self) -> bool:
        return self._preempt.is_set()

    def save(self, mark_preempted: bool = False) -> str:
        tag = f"{self.tag_prefix}{self.engine.global_steps}"
        client_state = self.client_state_fn() if self.client_state_fn else None
        path = self.engine.save_checkpoint(self.save_dir, tag=tag, client_state=client_state)
        self.last_saved_tag = tag
        if mark_preempted:
            marker = os.path.join(self.save_dir, self.PREEMPT_MARKER)
            with open(marker + ".tmp", "w") as f:
                f.write(tag)
            os.rename(marker + ".tmp", marker)
        return path

    def after_step(self) -> Optional[str]:
        """Call once per optimizer step. Saves when the interval elapses or a
        preemption is pending; on preemption also exits (``exit_on_preempt``).
        Returns the saved path, or None when no save was due."""
        if self._preempt.is_set():
            path = self.save(mark_preempted=True)
            if self.exit_on_preempt:
                raise SystemExit(128 + signal.SIGTERM)
            self._preempt.clear()
            return path
        steps = self.engine.global_steps
        if self.interval_steps > 0 and steps > 0 and steps % self.interval_steps == 0 \
                and self.last_saved_tag != f"{self.tag_prefix}{steps}":
            return self.save()
        return None

    def resume(self):
        """Load the newest committed checkpoint (``latest``, with the torn-tag
        fallback) and clear any preemption marker. Returns ``(path,
        client_state)``, or ``(None, {})`` when nothing is saved yet."""
        path, client_state = self.engine.load_checkpoint(self.save_dir)
        marker = os.path.join(self.save_dir, self.PREEMPT_MARKER)
        if os.path.isfile(marker):
            with open(marker) as f:
                logger.info(f"[autosave] resuming after preemption (marker tag "
                            f"{f.read().strip()!r})")
            os.unlink(marker)
        return path, client_state
