"""GPT-2 with mixture-of-experts FFNs, the DeepSpeed-MoE NLG architecture.

Counterpart of ``deepspeed_tpu/models/gpt2_moe.py`` (``GPT2MoEConfig``,
``MoEBlock``, ``GPT2MoE``, ``gpt2_moe_model``): every ``moe_layer_interval``-th
block's FFN is an ``moe/layer.py:MoE``, the others are GPT-2's dense
``Block``; the head is tied to ``wte`` and taken in f32 (JAX's ``x.astype(f32)
@ wte.T``, where dense GPT-2 multiplies in the compute dtype); the loss is
the LM loss plus ``moe_loss_coef`` times the sum of the MoE layers' ``l_aux``
(``gpt2_moe.py:122-136``).

In ``loss_fn`` the random stream's key (``runtime/rng.py``) drives both
dropout (GPT-2's sites) and the gates' training mode and noise (an MoE
block's gating site). ``apply_fn`` ignores its ``rng`` and runs the forward
deterministic, the gates in eval mode (``eval_capacity_factor``, no noise),
as JAX's ``apply_fn`` runs ``deterministic=True``.

Parameter names: the blocks are ``h.{i}`` whether dense or MoE (JAX: ``h_{i}``
and ``h_moe_{i}``, ``models/convert.py:gpt2_moe_params_from_jax``), an MoE
block's FFN is ``h.{i}.moe.gate_wg`` ``(m, e)`` and ``h.{i}.moe.experts.{w1, b1,
w2, b2}`` in JAX's layout. JAX's ``GPT2MoE`` reads neither ``remat`` nor
``vocab_chunk``; set away from their defaults they are refused here.
"""

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..moe.layer import MoE
from ..ops.transformer.attention import get_attention_impl
from ..runtime.rng import dropout, site_key
from .base import Model, Params
from .gpt2 import (SITE_BLOCKS, SITE_GATING, SITE_MLP_OUT, Block, Dense, GPT2Config, LayerNorm,
                   cross_entropy_loss, embed, init_params, shift_labels)


@dataclasses.dataclass
class GPT2MoEConfig(GPT2Config):
    num_experts: int = 8
    moe_layer_interval: int = 2      # every k-th layer is MoE
    top_k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = "RSample"
    moe_loss_coef: float = 0.01
    use_residual: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.remat or self.vocab_chunk:
            raise ValueError("GPT2MoEConfig: the JAX package's GPT2MoE reads neither remat nor "
                             "vocab_chunk; leave them at their defaults (remat=False, "
                             "vocab_chunk=0)")

    def is_moe_layer(self, i: int) -> bool:
        return (i + 1) % self.moe_layer_interval == 0


class MoEBlock(Block):
    """A transformer block whose FFN is an :class:`~..moe.layer.MoE`; its
    attention is the dense block's, with the fused ``c_attn`` as in JAX's
    ``MoEBlock``."""

    def __init__(self, cfg: GPT2MoEConfig, device):
        nn.Module.__init__(self)
        self.cfg = cfg
        d, dt = cfg.n_embd, cfg.dtype
        self.attn = get_attention_impl(cfg.attention_impl)
        self.split_qkv = False
        self.ln_1 = LayerNorm(d, device)
        self.c_attn = Dense(d, 3 * d, dt, device)
        self.c_proj = Dense(d, d, dt, device)
        self.ln_2 = LayerNorm(d, device)
        self.moe = MoE(d, 4 * d, num_experts=cfg.num_experts, k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       eval_capacity_factor=cfg.eval_capacity_factor,
                       min_capacity=cfg.min_capacity, noisy_gate_policy=cfg.noisy_gate_policy,
                       use_residual=cfg.use_residual, dtype=dt, device=device)

    def forward(self, x, key: Optional[int] = None):
        """``(x', l_aux, exp_counts)``."""
        cfg = self.cfg
        x = self.attend(x, key)
        y, l_aux, exp_counts = self.moe(self.ln_2(x).to(cfg.dtype), site_key(key, SITE_GATING))
        return x + dropout(y, cfg.dropout, site_key(key, SITE_MLP_OUT)), l_aux, exp_counts


class GPT2MoE(nn.Module):
    def __init__(self, cfg: GPT2MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.n_embd, device=device))
        self.wpe = nn.Parameter(torch.empty(cfg.n_positions, cfg.n_embd, device=device))
        self.h = nn.ModuleList(MoEBlock(cfg, device) if cfg.is_moe_layer(i) else Block(cfg, device)
                               for i in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, device)

    def forward(self, input_ids: torch.Tensor, rng: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """``input_ids (b, t)`` → ``(f32 logits (b, t, vocab), [l_aux], [exp_counts])``,
        one entry a MoE layer. ``rng``: the random stream's key, or None."""
        x = embed(self, input_ids, rng)
        aux, counts = [], []
        for i, block in enumerate(self.h):
            key = site_key(rng, SITE_BLOCKS, i)
            if isinstance(block, MoEBlock):
                x, l_aux, exp_counts = block(x, key)
                aux.append(l_aux)
                counts.append(exp_counts)
            else:
                x = block(x, key)
        x = self.ln_f(x)
        return x.float() @ self.wte.float().t(), aux, counts


def gpt2_moe_model(config: GPT2MoEConfig) -> Model:
    """A :class:`Model` for the engine: batch = ``{"input_ids": (B, T)}`` with
    optional ``"labels"``; the loss adds ``moe_loss_coef × Σ l_aux``."""
    module = GPT2MoE(config, device="meta")

    def loss_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        logits, aux, _ = functional_call(module, params, (batch["input_ids"],), {"rng": rng})
        lm_loss = cross_entropy_loss(logits, shift_labels(batch))
        if not aux:
            return lm_loss
        return lm_loss + config.moe_loss_coef * torch.stack(aux).sum()

    def apply_fn(params: Params, batch, rng: Optional[int] = None) -> torch.Tensor:
        ids = batch["input_ids"] if isinstance(batch, dict) else batch
        return functional_call(module, params, (ids,))[0]

    return Model(loss_fn=loss_fn,
                 init_fn=lambda seed, device: init_params(config, seed, device, module),
                 apply_fn=apply_fn,
                 name=f"GPT2MoE(L{config.n_layer},d{config.n_embd},E{config.num_experts})")


def moe_stats(config: GPT2MoEConfig, params: Dict[str, torch.Tensor], batch,
              rng: Optional[int] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(Σ l_aux, [exp_counts a MoE layer])`` of one forward of the model of
    ``config`` on ``params``, without gradients (for logs)."""
    with torch.no_grad():
        _, aux, counts = functional_call(GPT2MoE(config, device="meta"), params,
                                         (batch["input_ids"],), {"rng": rng})
    return torch.stack(aux).sum(), counts
