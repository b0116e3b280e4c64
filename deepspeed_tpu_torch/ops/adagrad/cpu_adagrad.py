"""Adagrad on the device.

Counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py`` (the reference's
``DeepSpeedCPUAdagrad``): with the squared-gradient sum ``s += g * g``, ``p -=
lr * g / (sqrt(s) + eps)``, the decay added to the gradient first. State and
arithmetic are f32. The host-offloaded variant is ``ops/adam/cpu_adam.py:
adagrad_step``, run by the ZeRO-Offload tier.
"""

from typing import Dict, NamedTuple, Optional

import torch

from ..optimizer import Optimizer


class AdagradState(NamedTuple):
    step: torch.Tensor                    # i32 0-d
    sum_sq: Dict[str, torch.Tensor]


def adagrad(eps: float = 1e-10, weight_decay: float = 0.0) -> Optimizer:
    def init(params: Dict[str, torch.Tensor]) -> AdagradState:
        p0 = next(iter(params.values()))
        return AdagradState(step=torch.zeros((), dtype=torch.int32, device=p0.device),
                            sum_sq={k: torch.zeros_like(p, dtype=torch.float32)
                                    for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdagradState,
               params: Dict[str, torch.Tensor], lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        def assign(old, new):
            old.copy_(new if keep is None else torch.where(keep, old, new))

        for name, p in params.items():
            g = grads[name].float()
            if weight_decay != 0.0:
                g = g + weight_decay * p.float()
            s = state.sum_sq[name]
            s_new = s + g * g
            assign(p, p - lr * g / (torch.sqrt(s_new) + eps))
            assign(s, s_new)
        assign(state.step, state.step + 1)

    return Optimizer(init=init, update=update, name="Adagrad")
