"""Inference engine: serve a :class:`CausalLM` on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``):
the model comes as a :class:`CausalLMConfig` (seeded random weights) or as
``(cfg, state_dict)``; weights of two or more dimensions are cast to the serve
dtype, 1-D norms and biases stay f32. ``generate`` runs the prefill, then a
Python decode loop, and records ``ttft``, ``tpot`` and ``decode_tps``, each
bracketed by a device synchronise on the card.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..models.causal_lm import CausalLM, CausalLMConfig, init_cache
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
        # the serve dtype wins over the model's own
        self.model_config = dataclasses.replace(cfg, dtype=self.dtype)
        self.module = CausalLM(self.model_config, device=self.device)
        if state_dict is None:
            self.module.init_weights(seed)
        else:
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

    @torch.no_grad()
    def _place_params(self):
        """Cast every floating parameter of two or more dimensions to the serve
        dtype; 1-D norms and biases stay f32."""
        for p in self.module.parameters():
            if p.ndim >= 2 and p.is_floating_point():
                p.data = p.data.to(self.dtype)

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
