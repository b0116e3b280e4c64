"""The MoE layer: gate, experts, and the optional residual branch.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoE``): tokens ``(..., m)``
are routed by ``TopKGate`` over ``gate_wg (m, e)``, dispatched to
:class:`~.experts.Experts` and combined (``sharded_moe.moe_dispatch_combine``).
With ``use_residual`` (residual MoE, the DeepSpeed-MoE NLG design) a dense
MLP branch is mixed with the sparse one through a learned two-way
coefficient, ``softmax(x @ coefficient)`` in f32.

Training or eval follows the key: with a key of the random stream
(``runtime/rng.py``) the gate runs in training mode (``capacity_factor``,
the noise policy, random token selection, drawn from one generator built
from the key), without one in eval mode (``eval_capacity_factor``, no noise),
as JAX's ``deterministic`` does. One card: no token sharding.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from ..models.gpt2 import Dense
from ..runtime import rng as rng_stream
from .experts import Experts
from .sharded_moe import TopKGate, moe_dispatch_combine


class MoE(nn.Module):
    """Sparse MoE FFN: ``(..., m)`` → ``((..., m), l_aux, exp_counts)``."""

    def __init__(self, hidden_size: int, ffn_hidden_size: Optional[int] = None,
                 num_experts: int = 1, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, top2_2nd_expert_sampling: bool = True,
                 use_residual: bool = False, activation: str = "gelu",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        m = hidden_size
        f = ffn_hidden_size or 4 * m
        self.hidden_size = m
        self.dtype = dtype
        self.use_residual = use_residual
        self.noisy_gate_policy = noisy_gate_policy
        self.use_rts = use_rts
        self.gate = TopKGate(k=k, capacity_factor=capacity_factor,
                             eval_capacity_factor=eval_capacity_factor,
                             min_capacity=min_capacity, noisy_gate_policy=noisy_gate_policy,
                             drop_tokens=drop_tokens, use_rts=use_rts,
                             top2_2nd_expert_sampling=top2_2nd_expert_sampling)
        self.gate_wg = nn.Parameter(torch.empty(m, num_experts, device=device))
        self.experts = Experts(num_experts, m, f, activation, dtype, device)
        if use_residual:
            self.residual_fc1 = Dense(m, f, dtype, device)
            self.residual_fc2 = Dense(f, m, dtype, device)
            self.coefficient = Dense(m, 2, torch.float32, device)

    def forward(self, x: torch.Tensor, key: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``key``: the gating draws' key (training mode), or None (eval)."""
        shape = x.shape
        tokens = x.reshape(-1, self.hidden_size)
        train = key is not None
        gen = (rng_stream.generator(key, x.device)
               if train and (self.noisy_gate_policy or self.use_rts) else None)
        l_aux, combine, dispatch, exp_counts = self.gate(self.gate_wg, tokens, train=train,
                                                         generator=gen)
        y = moe_dispatch_combine(tokens, combine, dispatch, self.experts).reshape(shape)
        if self.use_residual:
            dense = self.residual_fc2(self.experts.activation(self.residual_fc1(x)))
            coef = torch.softmax(self.coefficient(x.float()), dim=-1)
            y = y * coef[..., 0:1] + dense * coef[..., 1:2]
        return y.to(x.dtype), l_aux, exp_counts
