"""Weights carried across from the JAX package.

:func:`causal_lm_params_from_jax` turns the flax parameter tree of
``deepspeed_tpu.models.causal_lm.CausalLM`` (as numpy arrays, e.g.
``jax.device_get(engine.params)``) into a ``state_dict`` for this package's
:class:`~.causal_lm.CausalLM`; :func:`gpt2_params_from_jax` does the same for
``deepspeed_tpu.models.gpt2.GPT2`` and this package's :class:`~.gpt2.GPT2`. A flax ``kernel`` ``(in, out)`` becomes a
``weight`` ``(out, in)`` (transposed); ``scale`` becomes ``weight``; embeddings
keep their layout. Values keep their dtype: the engine casts to the serve dtype.
"""

from typing import Any, Dict

import numpy as np
import torch

from .causal_lm import CausalLMConfig
from .gpt2 import GPT2Config


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd, prefix: str, node: Dict[str, Any]):
    sd[f"{prefix}.weight"] = _t(node["kernel"]).t().contiguous()
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
        names = ["q_proj", "k_proj", "v_proj", "o_proj", "fc_out"]
        names += ["gate_proj", "up_proj"] if cfg.gated_mlp else ["fc_in"]
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
        for name in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{name}", block[name])
        for name in qkv + _GPT2_DENSES:
            _dense(sd, f"h.{i}.{name}", block[name])
    return sd
