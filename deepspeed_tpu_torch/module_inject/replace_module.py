"""Training model -> serving model conversion.

Counterpart of ``convert_training_model`` in
``deepspeed_tpu/module_inject/replace_module.py`` (the in-framework analogue of
the reference's Megatron state-dict loader, ``runtime/state_dict_factory.py``):
train GPT-2 or GPT-2 MoE, checkpoint, then serve through the inference
engine with KV caches. The rest of that module (the Hugging Face policies) is ROADMAP.md
queue 1 item 4.
"""

from typing import Dict, Tuple

import torch

from ..models.causal_lm import CausalLMConfig, gpt2_cfg
from ..models.gpt2 import GPT2Config

# GPT-2 training names -> CausalLM serving names, per block
_BLOCK_NAMES = {"ln_1": "ln_attn", "ln_2": "ln_mlp", "c_proj": "o_proj", "c_fc": "fc_in",
                "mlp_c_proj": "fc_out"}


def convert_training_model(train_cfg: GPT2Config, params: Dict[str, torch.Tensor]
                           ) -> Tuple[CausalLMConfig, Dict[str, torch.Tensor]]:
    """This package's GPT-2 or GPT-2 MoE training parameters
    (``models/gpt2.py``, ``models/gpt2_moe.py``: ``wte``, ``wpe``, ``ln_f``,
    ``h.{i}.c_attn`` ...) as a ``(CausalLMConfig, state_dict)`` that
    ``init_inference`` serves: the fused ``c_attn`` weight ``(3d, d)`` and
    bias split row-wise into q, k and v (``split_qkv`` trees carry them apart
    already), the other names mapped one to one; an MoE block's gate and
    expert stacks become ``moe_gate`` and ``moe_experts.*`` unchanged (JAX
    ``replace_module.py:429-489``), with the config's ``num_experts``,
    ``moe_layer_interval`` and ``moe_top_k``. Residual MoE raises, as in JAX.
    The config's LayerNorm epsilon is the training model's (1e-6), so the
    served forward is the trained one; the JAX package's conversion leaves
    ``gpt2_cfg``'s 1e-5. The tensors are the given ones, detached (no copy)."""
    num_experts = int(getattr(train_cfg, "num_experts", 0) or 0)
    if num_experts and any(".moe.residual_fc1." in k for k in params):
        raise NotImplementedError("residual-MoE serving is not supported (nor in the JAX "
                                  "package)")
    cfg = gpt2_cfg(vocab_size=train_cfg.vocab_size, max_seq_len=train_cfg.n_positions,
                   n_embd=train_cfg.n_embd, n_layer=train_cfg.n_layer,
                   n_head=train_cfg.n_head, ln_eps=1e-6, num_experts=num_experts,
                   moe_layer_interval=getattr(train_cfg, "moe_layer_interval", 2),
                   moe_top_k=getattr(train_cfg, "top_k", 1))
    sd = {k: params[k].detach() for k in ("wte", "wpe", "ln_f.weight", "ln_f.bias")}
    for i in range(cfg.n_layer):
        h, pre = f"h.{i}", f"layers.{i}"
        moe = cfg.is_moe_layer(i)
        if moe:
            sd[f"{pre}.moe_gate"] = params[f"{h}.moe.gate_wg"].detach()
            for name in ("w1", "b1", "w2", "b2"):
                sd[f"{pre}.moe_experts.{name}"] = params[f"{h}.moe.experts.{name}"].detach()
        for kind in ("weight", "bias"):
            if f"{h}.c_attn.{kind}" in params:
                q, k, v = params[f"{h}.c_attn.{kind}"].detach().chunk(3, dim=0)
            else:
                q, k, v = (params[f"{h}.{n}_attn.{kind}"].detach() for n in "qkv")
            sd.update({f"{pre}.q_proj.{kind}": q, f"{pre}.k_proj.{kind}": k,
                       f"{pre}.v_proj.{kind}": v})
            for old, new in _BLOCK_NAMES.items():
                if not (moe and old in ("c_fc", "mlp_c_proj")):
                    sd[f"{pre}.{new}.{kind}"] = params[f"{h}.{old}.{kind}"].detach()
    return cfg, sd
