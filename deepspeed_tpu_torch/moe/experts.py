"""Stacked expert FFNs.

Counterpart of ``deepspeed_tpu/moe/experts.py`` (``Experts``): one f32 weight
tensor per projection with a leading expert axis, ``w1 (e, m, f)``, ``b1 (e,
f)``, ``w2 (e, f, m)``, ``b2 (e, m)`` (the JAX layout, so weights carry across
unchanged), applied to every expert's capacity slots at once. JAX computes it
with ``einsum`` outside any Pallas kernel; here it is a batched
``torch.matmul`` in the compute dtype. Expert parallelism (the expert axis
sharded over a mesh) waits for ROADMAP.md queue 1 item 11.
"""

import torch
from torch import nn

from ..ops.moe import ACTIVATIONS


class Experts(nn.Module):
    """``e`` parallel MLP experts: ``(e, c, m)`` → ``(e, c, m)``, weights and
    biases cast to ``dtype``, the biases added after each product in it."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int, activation: str = "gelu",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        e, m, f = num_experts, d_model, d_ff
        self.dtype = dtype
        self.activation = ACTIVATIONS[activation]
        self.w1 = nn.Parameter(torch.empty(e, m, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, m, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, m, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.matmul(x.to(dt), self.w1.to(dt)) + self.b1[:, None, :].to(dt)
        h = self.activation(h)
        return torch.matmul(h, self.w2.to(dt)) + self.b2[:, None, :].to(dt)
