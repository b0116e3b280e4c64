"""1-bit LAMB on the device.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py`` (DeepSpeed's
``OnebitLamb``): LAMB for ``freeze_step`` steps; after them the variance is
frozen, the momentum is sign-compressed with error feedback, and each
tensor's trust ratio is the one recorded at step ``freeze_step`` (the
boundary). As in the JAX package, the ratio is recorded only when the
boundary step is met, so with ``freeze_step=0`` it never is and the frozen
ratio stays 1.0.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ....comm.compressed import sign_compress
from ....ops.lamb.fused_lamb import trust_ratio
from ....ops.optimizer import Optimizer, assigner
from .adam import i32, zeros_like_f32


class OnebitLambState(NamedTuple):
    step: torch.Tensor                    # i32 0-d
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    error: Dict[str, torch.Tensor]
    frozen_trust: Dict[str, torch.Tensor]  # f32 0-d a tensor: the boundary's ratio


def onebit_lamb(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0, freeze_step: int = 100,
                max_coeff: float = 10.0, min_coeff: float = 0.01) -> Optimizer:
    beta1, beta2 = betas

    def init(params: Dict[str, torch.Tensor]) -> OnebitLambState:
        p0 = next(iter(params.values()))
        return OnebitLambState(
            step=i32(0, p0), exp_avg=zeros_like_f32(params), exp_avg_sq=zeros_like_f32(params),
            error=zeros_like_f32(params),
            frozen_trust={k: torch.ones((), dtype=torch.float32, device=p.device)
                          for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: OnebitLambState,
               params: Dict[str, torch.Tensor], lr: float,
               keep: Optional[torch.Tensor] = None) -> None:
        step = state.step + 1
        frozen = step > freeze_step
        at_boundary = step == freeze_step
        bc1 = 1.0 - beta1 ** step.float()
        bc2 = 1.0 - beta2 ** step.float()
        assign = assigner(keep)
        for name, p in params.items():
            g = grads[name].float()
            m, v, e = state.exp_avg[name], state.exp_avg_sq[name], state.error[name]
            tr = state.frozen_trust[name]
            m_raw = beta1 * m + (1.0 - beta1) * g
            m_comp, e_new = sign_compress(m_raw, e)
            m_new = torch.where(frozen, m_comp, m_raw)
            e_out = torch.where(frozen, e_new, e)
            v_new = torch.where(frozen, v, beta2 * v + (1.0 - beta2) * g * g)
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay != 0.0:
                u = u + weight_decay * p
            live = trust_ratio(p, u, min_coeff, max_coeff)
            tr_new = torch.where(at_boundary, live, tr)
            trust = torch.where(frozen, tr_new, live)
            assign(p, p - lr * trust * u)
            assign(m, m_new)
            assign(v, v_new)
            assign(e, e_out)
            assign(tr, tr_new)
        assign(state.step, step)

    return Optimizer(init=init, update=update, name="OnebitLamb")
