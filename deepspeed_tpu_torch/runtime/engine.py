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
micro-batch at a time. ZeRO stage 1 on one card partitions the optimizer state
over a data-parallel group of one, so it is stage 0. Not ported yet (each
raises ``NotImplementedError`` naming its ``ROADMAP.md`` queue-1 item): ZeRO
stages 2 and 3, offload and checkpoints (item 12), the monitor and flops
profiler (item 9), pipelines (item 13), data parallelism (item 11), and
``training_data`` (the dataloader, item 5).
"""

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..accelerator import resolve_device
from ..config.config import ADAM_TYPES, DeepSpeedConfig
from ..models.base import Model
from ..ops.adam.fused_adam import fused_adam
from ..ops.optimizer import Optimizer
from ..utils.logging import log_dist
from .fp16.loss_scaler import LossScaleState, create_loss_scaler
from .lr_schedules import get_lr_scheduler
from .utils import clip_by_global_norm, count_parameters, global_norm


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]     # f32 masters, requires_grad
    opt_state: Any
    scaler: LossScaleState
    global_step: torch.Tensor           # i32 0-d
    skipped_steps: torch.Tensor         # i32 0-d


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1 {item}")


class DeepSpeedEngine:
    def __init__(self, args=None, model: Optional[Model] = None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None, mpu=None,
                 collate_fn=None, config=None, device=None, seed: int = 42):
        if not isinstance(model, Model):
            raise TypeError("model must be a deepspeed_tpu_torch.models.Model "
                            f"(see models.gpt2.gpt2_model), got {type(model).__name__}")
        if training_data is not None or collate_fn is not None:
            raise _unported("training_data= (the dataloader)", "item 5 (remainder)")
        if mpu is not None:
            raise _unported("mpu= (model parallelism)", "item 11")
        self.module = model
        self.args = args
        self.device = resolve_device(device)
        self._config = (config if isinstance(config, DeepSpeedConfig)
                        else DeepSpeedConfig(config))
        self.zero_stage = self._config.zero_config.stage

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
        self.training_dataloader = None

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
    def _configure_optimizer(self, optimizer) -> Optimizer:
        if optimizer is not None:
            if isinstance(optimizer, Optimizer):
                return optimizer
            raise TypeError(f"unsupported optimizer object {optimizer!r}: pass a "
                            "deepspeed_tpu_torch.ops.optimizer.Optimizer or configure one")
        name = self._config.optimizer_name or "adam"
        if name not in ADAM_TYPES:
            raise ValueError(f"unknown optimizer {name!r}")
        oc = self._config.optimizer_params
        self._base_lr = oc.lr
        adam_w = name == "adamw" or bool(oc.adam_w_mode)
        return fused_adam(betas=oc.betas, eps=oc.eps, weight_decay=oc.weight_decay,
                          adam_w_mode=adam_w, bias_correction=oc.bias_correction)

    def _configure_lr_scheduler(self, lr_scheduler):
        if lr_scheduler is not None:
            return lr_scheduler
        if self._config.scheduler_name:
            return get_lr_scheduler(self._config.scheduler_name,
                                    self._config.scheduler_params)
        return None

    def _build_state(self, scaler_state0: LossScaleState, seed: int) -> None:
        params = self.module.init(seed, self.device)
        params = {k: p.detach().to(self.device, torch.float32, copy=True).requires_grad_()
                  for k, p in params.items()}
        self.state = TrainState(
            params=params, opt_state=self.optimizer.init(params), scaler=scaler_state0,
            global_step=torch.zeros((), dtype=torch.int32, device=self.device),
            skipped_steps=torch.zeros((), dtype=torch.int32, device=self.device))

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

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The micro-batch loss, from the masters cast to the compute dtype."""
        cast = {k: p.to(self.compute_dtype) for k, p in self.state.params.items()}
        loss = self.module.loss_fn(cast, batch)
        return loss[0] if isinstance(loss, tuple) else loss

    def _accumulate(self, loss: torch.Tensor) -> None:
        """Gradients of ``loss * scale`` with respect to the masters, summed in
        f32 into the accumulator."""
        scale = self.state.scaler.cur_scale
        grads = torch.autograd.grad(loss * scale.to(loss.dtype),
                                    list(self.state.params.values()))
        if self._grad_acc is None:
            self._grad_acc = [g.float() for g in grads]
        else:
            for acc, g in zip(self._grad_acc, grads):
                acc.add_(g.float())

    def _apply_update(self, lr: float, n_micro: int) -> Dict[str, torch.Tensor]:
        """Unscale, prescale, global norm, overflow check, clip, optimizer step,
        scaler step; every decision stays on the device."""
        cfg, state = self._config, self.state
        scale = state.scaler.cur_scale
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
        # bf16 and f32 cannot overflow-skip: their keep-old would be a no-op
        self.optimizer.update(dict(zip(state.params, grads)), state.opt_state, state.params,
                              lr, keep=overflow if cfg.fp16.enabled else None)
        self.state = state._replace(scaler=self.loss_scaler.update(state.scaler, overflow),
                                    global_step=state.global_step + 1,
                                    skipped_steps=state.skipped_steps + overflow.int())
        return {"grad_norm": norm, "overflow": overflow, "loss_scale": scale}

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
            if data_iter is None:
                raise ValueError("train_batch needs batch= or data_iter=")
            batch = next(data_iter)
        gas = self.gradient_accumulation_steps()
        batch = self._to_device(batch)
        for key, x in batch.items():
            if x.shape[0] % gas:
                raise ValueError(f"train_batch: {key!r} leading dim {x.shape[0]} is not "
                                 f"divisible by gradient_accumulation_steps {gas}")
        lr = self.get_lr_value()
        losses = []
        for i in range(gas):
            micro = {k: x.reshape(gas, x.shape[0] // gas, *x.shape[1:])[i]
                     for k, x in batch.items()}
            loss = self._loss(micro)
            self._accumulate(loss)
            losses.append(loss.detach())
        metrics = self._apply_update(lr, gas)
        metrics["loss"] = torch.stack(losses).mean()
        self.micro_steps += gas
        self._finish_step(metrics)
        if self._host_steps % self._config.steps_per_print == 0:     # the one host read
            log_dist(f"step={self._host_steps} loss={float(metrics['loss']):.4f} "
                     f"lr={lr:.3e} loss_scale={float(metrics['loss_scale']):.0f}", ranks=[0])
        return metrics["loss"]

    def forward(self, batch) -> torch.Tensor:
        """The loss of one micro-batch, with its autograd graph to the masters
        (consumed by :meth:`backward`)."""
        self._cached_loss = self._loss(self._to_device(batch))
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
        self._finish_step(self._apply_update(self.get_lr_value(),
                                             self.gradient_accumulation_steps()))

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        return self._loss(self._to_device(batch))

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

    def save_checkpoint(self, *args, **kwargs):
        raise _unported("save_checkpoint", "item 12")

    def load_checkpoint(self, *args, **kwargs):
        raise _unported("load_checkpoint", "item 12")
