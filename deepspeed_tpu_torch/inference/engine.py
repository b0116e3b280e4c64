"""Inference engine: serve a :class:`CausalLM` on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``):
the model comes as a :class:`CausalLMConfig` (seeded random weights) or as
``(cfg, state_dict)``; weights of two or more dimensions are cast to the serve
dtype, 1-D norms and biases stay f32. With weight quantization on
(``weight_quant``, or the legacy ``dtype="int8"`` / ``quant`` spellings) the
projections and MoE expert stacks are then quantized, as the JAX engine's
``_place_params`` does; projections are served through the dequant-GEMM
kernel. ``moe_decode_impl`` overrides the model's before the module is
built. ``generate`` runs the prefill, then a Python decode loop, and
records ``ttft``, ``tpot`` and ``decode_tps``, each bracketed by a device
synchronise on the card.
"""

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models.causal_lm import (QUANT_NAMES, CausalLM, CausalLMConfig, Dense, ExpertWeights,
                                QuantDense, QuantNode, init_cache)
from ..ops.quantizer import (dense_weight_bytes, make_quant_node, node_logical_shape,
                             node_weight_bytes, quantize_with_audit, validate_quant_config)
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig
from .decode_fns import decode_loop, make_select_fn, prefill


class InferenceEngine:
    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 device=None, seed: int = 0):
        self._config = config or DeepSpeedInferenceConfig()
        self.device = resolve_device(device)
        self.dtype = self._config.torch_dtype()
        cfg, state_dict = self._resolve_model(model)
        # the serve dtype wins over the model's own, and the config's MoE decode
        # impl over the model's, before the module exists
        overrides = {"dtype": self.dtype}
        if self._config.moe_decode_impl is not None:
            overrides["moe_decode_impl"] = self._config.moe_decode_impl
        self.model_config = dataclasses.replace(cfg, **overrides)
        self.module = CausalLM(self.model_config, device=self.device)
        if state_dict is None:
            self.module.init_weights(seed)
        else:
            self._adopt_quant_nodes(state_dict)
            self.module.load_state_dict(state_dict)
        self._place_params()
        self.module.requires_grad_(False).eval()
        self.ttft: Optional[float] = None
        self.tpot: Optional[float] = None          # seconds per decode token (per seq)
        self.decode_tps: Optional[float] = None    # decode tokens/sec across the batch
        log_dist(f"inference engine ready: {self.model_config.name} "
                 f"params≈{self.model_config.num_params():,} device={self.device} "
                 f"dtype={self.dtype}", ranks=[0])

    @staticmethod
    def _resolve_model(model):
        if isinstance(model, CausalLMConfig):
            return model, None
        if isinstance(model, tuple) and len(model) == 2 \
                and isinstance(model[0], CausalLMConfig):
            return model
        if isinstance(model, torch.nn.Module):
            raise NotImplementedError("serving a Hugging Face module (policy injection) "
                                      "is not ported yet: ROADMAP.md queue 1 item 4")
        raise NotImplementedError(
            f"cannot serve a {type(model).__name__}: this package serves a CausalLMConfig "
            "or (CausalLMConfig, state_dict); encoder serving is ROADMAP.md queue 1 item 13")

    def _adopt_quant_nodes(self, state_dict) -> None:
        """Projections and expert stacks that come quantized in ``state_dict``
        (``<prefix>.int8_q`` / ``int4_q`` and their scales, from
        ``models/convert.py``) become :class:`QuantDense` (or an
        :class:`ExpertWeights` quant node) before the load, and are served as
        they are."""
        for key in state_dict:
            prefix, _, leaf = key.rpartition(".")
            if leaf not in ("int8_q", "int4_q"):
                continue
            bits = 8 if leaf == "int8_q" else 4
            parent_name, _, name = prefix.rpartition(".")
            parent = self.module.get_submodule(parent_name)
            node = make_quant_node(state_dict[key], state_dict[f"{prefix}.int{bits}_scale"], bits)
            if isinstance(parent, ExpertWeights):
                parent.quantize(name, node)
            else:
                dense = getattr(parent, name)
                setattr(parent, name, QuantDense(node, dense.bias, dense.dtype))

    @torch.no_grad()
    def _place_params(self):
        """Cast every floating parameter of two or more dimensions to the serve
        dtype (1-D norms and biases stay f32; an MoE layer's gate and expert
        biases are 2-D and are cast, as in JAX), then, with weight quantization
        on, quantize the projections and expert stacks as the JAX engine does.

        Each ``Dense`` at a ``QUANT_NAMES`` site, in the serve dtype and in the
        JAX ``(in, out)`` layout (``weight.t()``), and each expert stack
        ``w1 (e, d, f)`` / ``w2 (e, f, d)`` (grouped per expert along its
        second-last axis) passes the audit of ``quantize_with_audit``:
        outlier-heavy matrices and paths matching a ``weight_quant.exclude``
        substring stay fp; the rest become :class:`QuantDense` or an expert
        quant node. Paths are the JAX tree's (``layers_0/q_proj/kernel``,
        ``layers_1/moe_experts/w1``) so that one config excludes the same
        matrices in both packages. Weights already quantized (from the state
        dict) pass through. The decisions land in ``self.quant_audit`` with the
        JAX engine's keys and go to the log."""
        if self._config.quant.enabled or self._config.is_int8():
            validate_quant_config(self._config.quant)
        wq = self._config.resolved_weight_quant()
        if wq.enabled and wq.bits not in (8, 4):
            raise ValueError(f"weight_quant.bits={wq.bits} not in (8, 4)")
        if wq.enabled and wq.group < 1:
            raise ValueError(f"weight_quant.group={wq.group} must be >= 1")
        for p in self.module.parameters():
            if p.ndim >= 2 and p.is_floating_point():
                p.data = p.data.to(self.dtype)
        threshold = wq.resolved_threshold()
        audit = []

        def quantize(path, w):
            """The quant node of ``w`` (JAX layout), or None where it stays fp."""
            if any(sub in path for sub in wq.exclude):
                audit.append({"name": path, "decision": "excluded",
                              "reason": "weight_quant.exclude match", "bits": wq.bits,
                              "group_requested": wq.group, "group_effective": None,
                              "rel_err": None})
                return None
            node, info = quantize_with_audit(w, bits=wq.bits, group_size=wq.group,
                                             threshold=threshold, name=path)
            audit.append(info)
            return node

        if wq.enabled:
            for i, layer in enumerate(self.module.layers):
                for name in QUANT_NAMES:
                    dense = getattr(layer, name, None)
                    if isinstance(dense, Dense):
                        node = quantize(f"layers_{i}/{name}/kernel", dense.weight.t())
                        if node is not None:
                            setattr(layer, name, QuantDense(node, dense.bias, dense.dtype))
                experts = getattr(layer, "moe_experts", None)
                for name in ("w1", "w2"):
                    w = getattr(experts, name, None)
                    if isinstance(w, torch.nn.Parameter):
                        node = quantize(f"layers_{i}/moe_experts/{name}", w)
                        if node is not None:
                            experts.quantize(name, node)
        self.quant_audit = audit
        if wq.enabled:
            n_q = sum(1 for e in audit if e["decision"] == "quantized")
            for e in audit:
                if e["decision"] != "quantized":
                    log_dist(f"weight_quant: {e['name']} kept fp — {e['reason']}", ranks=[0])
                elif e["group_effective"] != e["group_requested"]:
                    log_dist(f"weight_quant: {e['name']} effective group "
                             f"{e['group_effective']} (requested {wq.group})", ranks=[0])
            log_dist(f"weight_quant: int{wq.bits} group={wq.group} — {n_q} matrices "
                     f"quantized, {len(audit) - n_q} kept fp (outlier_threshold={threshold})",
                     ranks=[0])

    def weight_stream_report(self) -> Dict[str, float]:
        """Modeled device-memory weight bytes of one full pass over the
        parameters (about one decode step), as the JAX engine reports them:
        quantized projections and expert stacks at the kernel's own count
        (payload and scales, each read once, ``node_weight_bytes``); every fp
        matrix (expert stacks, gates and expert biases included), and the bf16
        equivalent of each quantized one, at 2 bytes an element whatever the
        serve dtype. ``reduction_quantized_nodes`` is over the quantized set,
        ``reduction_total`` includes the fp matrices (embeddings, head,
        excluded projections)."""
        acc = {"quantized_bytes": 0, "quantized_bf16_equiv": 0, "fp_bytes": 0}
        for mod in self.module.modules():
            if isinstance(mod, QuantNode):
                node = mod.node()
                acc["quantized_bytes"] += node_weight_bytes(node)
                acc["quantized_bf16_equiv"] += dense_weight_bytes(node_logical_shape(node),
                                                                  torch.bfloat16)
        for p in self.module.parameters():
            if p.ndim >= 2:
                acc["fp_bytes"] += dense_weight_bytes(p.shape, torch.bfloat16)
        step = acc["quantized_bytes"] + acc["fp_bytes"]
        bf16_equiv = acc["quantized_bf16_equiv"] + acc["fp_bytes"]
        return {
            **acc,
            "modeled_step_bytes": step,
            "bf16_equiv_step_bytes": bf16_equiv,
            "reduction_total": bf16_equiv / step if step else 1.0,
            "reduction_quantized_nodes": (acc["quantized_bf16_equiv"] / acc["quantized_bytes"]
                                          if acc["quantized_bytes"] else 1.0),
        }

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence f32 logits ``(b, t, V)``."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device)
        with torch.inference_mode():
            return self.module(ids)

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 attention_mask=None, prompt_lengths=None, **kwargs) -> np.ndarray:
        """Greedy or sampled generation; returns ``(b, t + n)`` tokens as numpy.

        Prompts of unequal length come right-padded, with ``attention_mask``
        (1s then 0s) or ``prompt_lengths``; positions, the prefill's logits read
        and the KV append point are then per sequence. Sampling draws from one
        ``torch.Generator`` seeded with ``seed``."""
        if kwargs.get("num_beams", 1) != 1:
            raise NotImplementedError("beam search is not supported (reference parity: "
                                      "DeepSpeed inference rejects num_beams > 1)")
        ids = np.asarray(input_ids)
        b, t = ids.shape
        if max_new_tokens <= 0:
            return ids
        if attention_mask is not None:
            am = np.asarray(attention_mask).astype(bool)
            lens_np = am.sum(axis=1).astype(np.int32)
            if not np.array_equal(am, np.arange(t)[None, :] < lens_np[:, None]):
                raise ValueError("attention_mask must be right-padded (1s then 0s); "
                                 "left-padded prompts are not supported")
            if (lens_np < 1).any():
                raise ValueError("attention_mask rows must contain at least one valid token")
        elif prompt_lengths is not None:
            lens_np = np.asarray(prompt_lengths, dtype=np.int32)
            if lens_np.shape != (b,) or (lens_np < 1).any() or (lens_np > t).any():
                raise ValueError(f"prompt_lengths must be (b,) in [1, {t}]")
        else:
            lens_np = np.full((b,), t, dtype=np.int32)
        cfg = self.model_config
        if cfg.pos_emb == "learned" and t + max_new_tokens - 1 > cfg.max_seq_len:
            raise ValueError(f"prompt {t} + {max_new_tokens} new tokens runs past the "
                             f"{cfg.max_seq_len} learned positions")

        cap = max(self._config.max_out_tokens, t + max_new_tokens)
        select = make_select_fn(do_sample, temperature, top_k, top_p)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        with torch.inference_mode():
            caches = init_cache(cfg, b, cap, dtype=self.dtype, device=self.device)
            ids_dev = torch.from_numpy(ids.astype(np.int64)).to(self.device)
            lens0 = torch.from_numpy(lens_np).to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self._sync()
            t0 = time.perf_counter()
            tok0 = select(prefill(self.module, ids_dev, caches, lens0), gen)
            tok0.cpu()                                  # host sync: honest TTFT
            self.ttft = time.perf_counter() - t0

            t1 = time.perf_counter()
            toks = decode_loop(self.module, select, tok0, caches, lens0, max_new_tokens,
                               eos, gen)
            gen_np = toks.cpu().numpy()                 # host sync ends the decode clock
            decode_time = time.perf_counter() - t1
        n = gen_np.shape[1]
        if n > 1 and decode_time > 0:
            self.tpot = decode_time / (n - 1)
            self.decode_tps = b * (n - 1) / decode_time
        else:
            self.tpot = None
            self.decode_tps = None
        return np.concatenate([ids, gen_np.astype(ids.dtype)], axis=1)
