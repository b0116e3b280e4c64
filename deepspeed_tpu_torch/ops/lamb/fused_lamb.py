"""LAMB as plain tensor code.

Counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (DeepSpeed's
``FusedLamb``): the Adam direction ``u = m_hat / (sqrt(v_hat) + eps)``, plus
``weight_decay * p``, rescaled per tensor by the trust ratio ``||p|| / ||u||``
clipped to ``[min_coeff, max_coeff]`` (1 where either norm is 0), then ``p -=
lr * trust * u``. State, arithmetic and both norms are f32 and stay on the
device.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..optimizer import Optimizer, assigner


class LambState(NamedTuple):
    step: torch.Tensor                    # i32 0-d
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]


def trust_ratio(p: torch.Tensor, u: torch.Tensor, min_coeff: float,
                max_coeff: float) -> torch.Tensor:
    """``||p|| / ||u||`` as a 0-d f32 tensor, 1 where ``||u||`` or ``||p||`` is 0,
    clipped to ``[min_coeff, max_coeff]`` (JAX's guards, in its order)."""
    p_norm = torch.linalg.vector_norm(p.float().reshape(-1))
    u_norm = torch.linalg.vector_norm(u.reshape(-1))
    one = torch.ones((), dtype=torch.float32, device=p.device)
    trust = torch.where(u_norm > 0, p_norm / u_norm, one)
    trust = torch.where(p_norm > 0, trust, one)
    return trust.clamp(min_coeff, max_coeff)


def fused_lamb(betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0, bias_correction: bool = True,
               max_coeff: float = 10.0, min_coeff: float = 0.01) -> Optimizer:
    """DeepSpeed ``FusedLamb``'s defaults."""
    beta1, beta2 = betas

    def init(params: Dict[str, torch.Tensor]) -> LambState:
        p0 = next(iter(params.values()))
        return LambState(
            step=torch.zeros((), dtype=torch.int32, device=p0.device),
            exp_avg={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            exp_avg_sq={k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: LambState,
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
            m_new = beta1 * m + (1.0 - beta1) * g
            v_new = beta2 * v + (1.0 - beta2) * (g * g)
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            if weight_decay != 0.0:
                u = u + weight_decay * p.float()
            trust = trust_ratio(p, u, min_coeff, max_coeff)
            assign(p, p - lr * trust * u)
            assign(m, m_new)
            assign(v, v_new)
        assign(state.step, step)

    return Optimizer(init=init, update=update, name="FusedLamb")
