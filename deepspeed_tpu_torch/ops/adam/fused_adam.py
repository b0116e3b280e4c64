"""Adam / AdamW as plain tensor code.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py`` (DeepSpeed's
``FusedAdam``), its formula term by term: with bias correction from an f32
step count, ``delta = m_hat / (sqrt(v_hat) + eps)``, plus ``weight_decay * p``
in AdamW mode (in Adam mode the decay is added to the gradient instead), then
``p -= lr * delta``. That is not ``torch.optim.AdamW``, which decays ``p`` by
``(1 - lr * wd)`` in a separate step. State and arithmetic are f32.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..optimizer import Optimizer, assigner


class AdamState(NamedTuple):
    step: torch.Tensor                    # i32 0-d
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]


def fused_adam(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True) -> Optimizer:
    """DeepSpeed ``FusedAdam``'s defaults."""
    beta1, beta2 = betas

    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        p0 = next(iter(params.values()))
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=p0.device),
            exp_avg={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            exp_avg_sq={k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor], lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        step = state.step + 1
        if bias_correction:
            bc1 = 1.0 - beta1 ** step.float()
            bc2 = 1.0 - beta2 ** step.float()
        else:
            bc1 = bc2 = 1.0

        assign = assigner(keep)

        for name, p in params.items():
            g = grads[name].float()
            m, v = state.exp_avg[name], state.exp_avg_sq[name]
            if weight_decay != 0.0 and not adam_w_mode:
                g = g + weight_decay * p
            m_new = beta1 * m + (1.0 - beta1) * g
            v_new = beta2 * v + (1.0 - beta2) * (g * g)
            denom = torch.sqrt(v_new / bc2) + eps
            delta = (m_new / bc1) / denom
            if weight_decay != 0.0 and adam_w_mode:
                delta = delta + weight_decay * p
            assign(p, p - lr * delta)
            assign(m, m_new)
            assign(v, v_new)
        assign(state.step, step)

    return Optimizer(init=init, update=update,
                     name="FusedAdam(adam_w)" if adam_w_mode else "FusedAdam")


def fused_adamw(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, **kw) -> Optimizer:
    return fused_adam(betas=betas, eps=eps, weight_decay=weight_decay, adam_w_mode=True, **kw)
