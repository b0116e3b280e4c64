"""Static and dynamic loss scaling, on the device.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``: scale the loss
before differentiation so fp16 gradients do not underflow; on an overflow skip
the step and halve the scale (after ``hysteresis`` overflows); after
``scale_window`` clean steps double it. The state is four 0-d tensors on the
device and :meth:`DynamicLossScaler.update` is ``torch.where`` arithmetic, so a
training step never reads the overflow flag on the host.
"""

from typing import NamedTuple, Tuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: torch.Tensor          # f32 0-d
    cur_hysteresis: torch.Tensor     # i32 0-d
    last_overflow_iter: torch.Tensor  # i32 0-d
    iteration: torch.Tensor          # i32 0-d


def _state(scale: float, hysteresis: int, device) -> LossScaleState:
    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return LossScaleState(cur_scale=torch.tensor(scale, dtype=torch.float32, device=device),
                          cur_hysteresis=i32(hysteresis), last_overflow_iter=i32(-1),
                          iteration=i32(0))


def make_static_state(scale: float, device=None) -> LossScaleState:
    return _state(scale, 1, device)


class DynamicLossScaler:
    """Update rules over :class:`LossScaleState`, with the JAX package's
    defaults (DeepSpeed's engine starts at ``2 ** initial_scale_power``)."""

    def __init__(self, init_scale: float = 2.0**16, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0, delayed_shift: int = 1,
                 consecutive_hysteresis: bool = False):
        self.init_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift  # "hysteresis" in the config
        self.consecutive_hysteresis = consecutive_hysteresis

    def init_state(self, device=None) -> LossScaleState:
        return _state(self.init_scale, self.delayed_shift, device)

    def update(self, state: LossScaleState, overflow: torch.Tensor) -> LossScaleState:
        """One iteration's update; ``overflow`` is a 0-d bool tensor."""
        it = state.iteration
        # overflow: shrink the scale once the hysteresis is used up
        exhausted = state.cur_hysteresis <= 1
        dec_scale = torch.clamp(state.cur_scale / self.scale_factor, min=self.min_scale)
        of_scale = torch.where(exhausted, dec_scale, state.cur_scale)
        of_hyst = torch.where(exhausted, state.cur_hysteresis, state.cur_hysteresis - 1)
        # clean: grow when scale_window clean iterations have passed since the
        # last overflow
        window_done = (it - state.last_overflow_iter) % self.scale_window == 0
        ok_scale = torch.where(window_done, state.cur_scale * self.scale_factor,
                               state.cur_scale)
        ok_hyst = (torch.full_like(state.cur_hysteresis, self.delayed_shift)
                   if self.consecutive_hysteresis else state.cur_hysteresis)
        return LossScaleState(
            cur_scale=torch.where(overflow, of_scale, ok_scale),
            cur_hysteresis=torch.where(overflow, of_hyst, ok_hyst).to(torch.int32),
            last_overflow_iter=torch.where(overflow, it, state.last_overflow_iter),
            iteration=it + 1,
        )


def create_loss_scaler(fp16_config, device=None) -> Tuple[DynamicLossScaler, LossScaleState]:
    """Scaler and initial state from an ``FP16Config`` (dynamic iff
    ``loss_scale == 0``); a fixed scale of 1 when fp16 is off."""
    if not fp16_config.enabled:
        scaler = DynamicLossScaler(init_scale=1.0, scale_window=10**9, min_scale=1.0)
        return scaler, make_static_state(1.0, device)
    if fp16_config.dynamic:
        scaler = DynamicLossScaler(init_scale=2.0**fp16_config.initial_scale_power,
                                   scale_window=fp16_config.loss_scale_window,
                                   min_scale=fp16_config.min_loss_scale,
                                   delayed_shift=fp16_config.hysteresis)
        return scaler, scaler.init_state(device)
    scaler = DynamicLossScaler(init_scale=fp16_config.loss_scale, scale_window=10**9,
                               min_scale=fp16_config.loss_scale)
    return scaler, make_static_state(fp16_config.loss_scale, device)
