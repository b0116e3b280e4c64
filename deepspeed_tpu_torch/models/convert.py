"""Weights carried across from the JAX package.

:func:`causal_lm_params_from_jax` turns the flax parameter tree of
``deepspeed_tpu.models.causal_lm.CausalLM`` (as numpy arrays, e.g.
``jax.device_get(engine.params)``) into a ``state_dict`` for this package's
:class:`~.causal_lm.CausalLM`; :func:`gpt2_params_from_jax` does the same for
``deepspeed_tpu.models.gpt2.GPT2`` and this package's :class:`~.gpt2.GPT2`,
and :func:`gpt2_moe_params_from_jax` for ``GPT2MoE`` and
:class:`~.gpt2_moe.GPT2MoE`;
:func:`tiled_dense_params_from_jax` carries a JAX ``TiledDense`` tree to
``runtime/zero/tiling.py:TiledDense``. A flax ``kernel`` ``(in, out)`` becomes a
``weight`` ``(out, in)`` (transposed); ``scale`` becomes ``weight``; embeddings
keep their layout. Values keep their dtype: the engine casts to the serve dtype.
A weight-quantized tree (``jax.device_get`` of a JAX engine serving with
``weight_quant``) carries its quant nodes across unchanged, neither transposed
nor re-quantized: a projection's ``{"__int8_q__", "__int8_scale__"}`` becomes
``<prefix>.int8_q`` / ``<prefix>.int8_scale`` (int4 likewise), which the
inference engine serves through :class:`~.causal_lm.QuantDense`. An MoE
layer's raw gate ``moe_gate (d, e)`` and its expert stacks
``moe_experts/{w1,b1,w2,b2}`` keep the JAX layout; a quantized stack (3-D
payload and scales) becomes ``<prefix>.moe_experts.w1.int8_q`` /
``...int8_scale``, served as an :class:`~.causal_lm.ExpertWeights` quant node.
"""

from typing import Any, Dict

import numpy as np
import torch

from ..ops.quantizer import is_quant_node, node_bits, node_qs
from .causal_lm import CausalLMConfig
from .gpt2 import GPT2Config


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _quant(sd, prefix: str, node) -> None:
    bits = node_bits(node)
    q, s = node_qs(node)
    sd[f"{prefix}.int{bits}_q"] = torch.from_numpy(np.array(q, dtype=np.int8))
    sd[f"{prefix}.int{bits}_scale"] = _t(s)


def _dense(sd, prefix: str, node: Dict[str, Any]):
    kernel = node["kernel"]
    if is_quant_node(kernel):
        _quant(sd, prefix, kernel)
    else:
        sd[f"{prefix}.weight"] = _t(kernel).t().contiguous()
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _norm(sd, prefix: str, node: Dict[str, Any]):
    sd[f"{prefix}.weight"] = _t(node["scale"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def causal_lm_params_from_jax(params: Dict[str, Any],
                              cfg: CausalLMConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``CausalLM`` tree (``wte``, ``wpe``, ``ln_embed``, ``layers_{i}``,
    ``ln_f``, ``lm_head``) → this package's ``state_dict``, f32 on the CPU."""
    sd = {"wte": _t(params["wte"])}
    if cfg.pos_emb == "learned":
        sd["wpe"] = _t(params["wpe"])
    if cfg.embed_layernorm:
        _norm(sd, "ln_embed", params["ln_embed"])
    for i in range(cfg.n_layer):
        layer = params[f"layers_{i}"]
        pre = f"layers.{i}"
        _norm(sd, f"{pre}.ln_attn", layer["ln_attn"])
        _norm(sd, f"{pre}.ln_mlp", layer["ln_mlp"])
        names = ["q_proj", "k_proj", "v_proj", "o_proj"]
        if cfg.is_moe_layer(i):
            sd[f"{pre}.moe_gate"] = _t(layer["moe_gate"])
            for name, leaf in layer["moe_experts"].items():
                if is_quant_node(leaf):
                    _quant(sd, f"{pre}.moe_experts.{name}", leaf)
                else:
                    sd[f"{pre}.moe_experts.{name}"] = _t(leaf)
        else:
            names += ["fc_out"] + (["gate_proj", "up_proj"] if cfg.gated_mlp else ["fc_in"])
        for name in names:
            _dense(sd, f"{pre}.{name}", layer[name])
    _norm(sd, "ln_f", params["ln_f"])
    if not cfg.tie_word_embeddings:
        _dense(sd, "lm_head", params["lm_head"])
    return sd


_GPT2_NORMS = ("ln_1", "ln_2")
_GPT2_DENSES = ("c_proj", "c_fc", "mlp_c_proj")


def gpt2_params_from_jax(params: Dict[str, Any], cfg: GPT2Config) -> Dict[str, torch.Tensor]:
    """The JAX ``GPT2`` tree (``wte``, ``wpe``, ``ln_f``, and the blocks: ``h``
    with every leaf stacked along a leading ``n_layer`` axis under
    ``scan_layers=True``, else ``h_{i}``) → this package's parameter dict, f32
    on the CPU. The fused ``c_attn`` kernel ``(d, 3d)`` keeps its q|k|v column
    order; ``split_qkv`` trees carry ``q_attn``/``k_attn``/``v_attn``."""
    sd = {"wte": _t(params["wte"]), "wpe": _t(params["wpe"])}
    _norm(sd, "ln_f", params["ln_f"])
    qkv = ("q_attn", "k_attn", "v_attn") if cfg.split_qkv else ("c_attn",)
    for i in range(cfg.n_layer):
        if "h" in params:               # scanned: take layer i of every stacked leaf
            block = {name: {k: np.asarray(v)[i] for k, v in node.items()}
                     for name, node in params["h"].items()}
        else:
            block = params[f"h_{i}"]
        _gpt2_block(sd, f"h.{i}", block, qkv)
    return sd


def _gpt2_block(sd, prefix: str, block: Dict[str, Any], qkv) -> None:
    for name in _GPT2_NORMS:
        _norm(sd, f"{prefix}.{name}", block[name])
    for name in qkv + tuple(n for n in _GPT2_DENSES if n in block):
        _dense(sd, f"{prefix}.{name}", block[name])


def gpt2_moe_params_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX ``GPT2MoE`` tree (``wte``, ``wpe``, ``ln_f``, dense blocks ``h_{i}``,
    MoE blocks ``h_moe_{i}``) → this package's ``GPT2MoE`` parameter dict
    (``h.{i}`` either way), f32 on the CPU. An MoE block's ``moe/gate_wg``
    and ``moe/experts/{w1,b1,w2,b2}`` keep JAX's layout; residual MoE's
    ``residual_fc1``, ``residual_fc2`` and ``coefficient`` are Denses."""
    sd = {"wte": _t(params["wte"]), "wpe": _t(params["wpe"])}
    _norm(sd, "ln_f", params["ln_f"])
    for i in range(cfg.n_layer):
        pre = f"h.{i}"
        if f"h_moe_{i}" in params:
            block = params[f"h_moe_{i}"]
            _gpt2_block(sd, pre, block, ("c_attn",))
            moe = block["moe"]
            sd[f"{pre}.moe.gate_wg"] = _t(moe["gate_wg"])
            for name, leaf in moe["experts"].items():
                sd[f"{pre}.moe.experts.{name}"] = _t(leaf)
            for name in ("residual_fc1", "residual_fc2", "coefficient"):
                if name in moe:
                    _dense(sd, f"{pre}.moe.{name}", moe[name])
        else:
            _gpt2_block(sd, pre, params[f"h_{i}"],
                        ("q_attn", "k_attn", "v_attn") if cfg.split_qkv else ("c_attn",))
    return sd


def tiled_dense_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX ``TiledDense`` tree (``kernel_{i}_{o}`` ``(in_i, out_o)``,
    ``bias_{o}``) → :class:`~..runtime.zero.tiling.TiledDense`'s parameters:
    each tile becomes ``weight_{i}_{o}`` ``(out_o, in_i)``, transposed as a
    ``Dense`` kernel is; biases keep their layout. f32 on the CPU."""
    sd = {}
    for name, leaf in params.items():
        if name.startswith("kernel_"):
            sd["weight_" + name[len("kernel_"):]] = _t(leaf).t().contiguous()
        else:
            sd[name] = _t(leaf)
    return sd
