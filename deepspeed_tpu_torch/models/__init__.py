from .base import Model  # noqa: F401
from .causal_lm import (FAMILIES, CausalLM, CausalLMConfig, bloom_cfg,  # noqa: F401
                        causal_lm_model, gpt2_cfg, gptj_cfg, gptneox_cfg, init_cache,
                        llama_cfg, opt_cfg)
from .convert import (causal_lm_params_from_jax, gpt2_moe_params_from_jax,  # noqa: F401
                      gpt2_params_from_jax, tiled_dense_params_from_jax)
from .gpt2 import (GPT2, GPT2_PRESETS, GPT2Config, cross_entropy_loss,  # noqa: F401
                   gpt2_config, gpt2_model)
from .gpt2_moe import GPT2MoE, GPT2MoEConfig, gpt2_moe_model  # noqa: F401
