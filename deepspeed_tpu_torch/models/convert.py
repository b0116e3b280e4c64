"""Weights carried across from the JAX package.

:func:`causal_lm_params_from_jax` turns the flax parameter tree of
``deepspeed_tpu.models.causal_lm.CausalLM`` (as numpy arrays, e.g.
``jax.device_get(engine.params)``) into a ``state_dict`` for this package's
:class:`~.causal_lm.CausalLM`. A flax ``kernel`` ``(in, out)`` becomes a
``weight`` ``(out, in)`` (transposed); ``scale`` becomes ``weight``; embeddings
keep their layout. Values keep their dtype: the engine casts to the serve dtype.
"""

from typing import Any, Dict

import numpy as np
import torch

from .causal_lm import CausalLMConfig


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
