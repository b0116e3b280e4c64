"""Reference-format checkpoint tools (import and export of DeepSpeed/Megatron runs).

Counterpart of ``deepspeed_tpu/checkpoint/``: :class:`DeepSpeedCheckpoint`
inspects a 3D (pp × tp × dp) training checkpoint folder, merges
tensor-parallel shards, rebuilds f32 weights from ZeRO optimizer shards, and
:func:`to_causal_lm_params` turns a Megatron GPT into this package's
``CausalLM`` state dict. :func:`export_universal_checkpoint` and
:func:`export_fp32_state_dict` write a trained engine out in the reference's
universal and ``zero_to_fp32`` formats. The engine's own tags
(``runtime/checkpoint_engine``) need none of this.
"""

from .constants import *  # noqa: F401,F403
from .deepspeed_checkpoint import (DeepSpeedCheckpoint, merge_tp_shards,  # noqa: F401
                                   split_megatron_qkv, to_causal_lm_params)
from .export import export_fp32_state_dict, export_universal_checkpoint  # noqa: F401
from .reshape import (Model3DDescriptor, get_model_3d_descriptor,  # noqa: F401
                      get_zero_files, reshape_3d, reshape_meg_2d_parallel)
