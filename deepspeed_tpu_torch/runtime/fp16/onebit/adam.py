"""1-bit Adam and 0/1 Adam on the device.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/adam.py`` (DeepSpeed's
``OnebitAdam`` and ``ZeroOneAdam``), term by term:

- 1-bit Adam: Adam for ``freeze_step`` steps; after them the variance is
  frozen and the momentum is replaced by its sign-compressed form with error
  feedback (``comm/compressed.py:sign_compress``).
- 0/1 Adam: the momentum is always compressed; the variance is refreshed at
  intervals that double up to ``var_update_scaler``, until ``var_freeze_step``.

On one card the gradient is already the global mean, so the compression
applies to it directly, as in the JAX package's single-controller view. Every
switch (frozen, refresh) is a ``torch.where`` on the device step tensor and is
never read on the host. State and arithmetic are f32; the state's field names
are JAX's, so a tag's tree has JAX's keys.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ....comm.compressed import sign_compress
from ....ops.optimizer import Optimizer, assigner


class OnebitAdamState(NamedTuple):
    step: torch.Tensor                    # i32 0-d
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    error: Dict[str, torch.Tensor]        # error feedback of the compression stage


class ZeroOneAdamState(NamedTuple):
    step: torch.Tensor
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    error: Dict[str, torch.Tensor]
    last_var_update: torch.Tensor         # i32 0-d: the step of the last refresh
    var_interval: torch.Tensor            # i32 0-d: steps between refreshes


def zeros_like_f32(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def i32(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=like.device)


def _adam_delta(p, g, m_new, v_new, bc1, bc2, eps, weight_decay, adam_w_mode):
    delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if weight_decay != 0.0 and adam_w_mode:
        delta = delta + weight_decay * p
    return delta


def onebit_adam(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0, freeze_step: int = 100,
                adam_w_mode: bool = False) -> Optimizer:
    """DeepSpeed ``OnebitAdam``'s defaults."""
    beta1, beta2 = betas

    def init(params: Dict[str, torch.Tensor]) -> OnebitAdamState:
        p0 = next(iter(params.values()))
        return OnebitAdamState(step=i32(0, p0), exp_avg=zeros_like_f32(params),
                               exp_avg_sq=zeros_like_f32(params), error=zeros_like_f32(params))

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: OnebitAdamState,
               params: Dict[str, torch.Tensor], lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        step = state.step + 1
        frozen = step > freeze_step
        bc1 = 1.0 - beta1 ** step.float()
        bc2 = 1.0 - beta2 ** step.float()
        assign = assigner(keep)
        for name, p in params.items():
            g = grads[name].float()
            m, v, e = state.exp_avg[name], state.exp_avg_sq[name], state.error[name]
            if weight_decay != 0.0 and not adam_w_mode:
                g = g + weight_decay * p
            m_raw = beta1 * m + (1.0 - beta1) * g
            m_comp, e_new = sign_compress(m_raw, e)
            m_new = torch.where(frozen, m_comp, m_raw)
            e_out = torch.where(frozen, e_new, e)
            v_new = torch.where(frozen, v, beta2 * v + (1.0 - beta2) * g * g)
            delta = _adam_delta(p, g, m_new, v_new, bc1, bc2, eps, weight_decay, adam_w_mode)
            assign(p, p - lr * delta)
            assign(m, m_new)
            assign(v, v_new)
            assign(e, e_out)
        assign(state.step, step)

    return Optimizer(init=init, update=update, name="OnebitAdam")


def zero_one_adam(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                  weight_decay: float = 0.0, var_freeze_step: int = 100000,
                  var_update_scaler: int = 16, adam_w_mode: bool = False) -> Optimizer:
    """0/1 Adam with the JAX package's interval schedule. DeepSpeed's
    ``local_step_scaler`` and ``local_step_clipper`` schedule how often
    workers sync at all; on one card every step is global, so they do not
    exist here either."""
    beta1, beta2 = betas

    def init(params: Dict[str, torch.Tensor]) -> ZeroOneAdamState:
        p0 = next(iter(params.values()))
        return ZeroOneAdamState(step=i32(0, p0), exp_avg=zeros_like_f32(params),
                                exp_avg_sq=zeros_like_f32(params), error=zeros_like_f32(params),
                                last_var_update=i32(0, p0), var_interval=i32(1, p0))

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: ZeroOneAdamState,
               params: Dict[str, torch.Tensor], lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        step = state.step + 1
        bc1 = 1.0 - beta1 ** step.float()
        bc2 = 1.0 - beta2 ** step.float()
        refresh = torch.logical_and(step - state.last_var_update >= state.var_interval,
                                    step <= var_freeze_step)
        new_interval = torch.where(
            refresh, torch.clamp(state.var_interval * 2, max=var_update_scaler),
            state.var_interval)
        new_last = torch.where(refresh, step, state.last_var_update)
        assign = assigner(keep)
        for name, p in params.items():
            g = grads[name].float()
            m, v, e = state.exp_avg[name], state.exp_avg_sq[name], state.error[name]
            if weight_decay != 0.0 and not adam_w_mode:
                g = g + weight_decay * p
            m_raw = beta1 * m + (1.0 - beta1) * g
            m_new, e_new = sign_compress(m_raw, e)
            v_new = torch.where(refresh, beta2 * v + (1.0 - beta2) * g * g, v)
            delta = _adam_delta(p, g, m_new, v_new, bc1, bc2, eps, weight_decay, adam_w_mode)
            assign(p, p - lr * delta)
            assign(m, m_new)
            assign(v, v_new)
            assign(e, e_new)
        assign(state.last_var_update, new_last)
        assign(state.var_interval, new_interval.to(torch.int32))
        assign(state.step, step)

    return Optimizer(init=init, update=update, name="ZeroOneAdam")
