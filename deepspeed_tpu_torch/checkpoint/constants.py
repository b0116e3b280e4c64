"""DeepSpeed/Megatron checkpoint names and keys.

A copy of ``deepspeed_tpu/checkpoint/constants.py`` (itself
``deepspeed/checkpoint/constants.py``): the on-disk names of DeepSpeed and
Megatron training checkpoints (file prefixes and state-dict keys).
"""

# optimizer checkpoint keys
OPTIMIZER_STATE_DICT = "optimizer_state_dict"
BASE_OPTIMIZER_STATE = "base_optimizer_state"
SINGLE_PARTITION_OF_FP32_GROUPS = "single_partition_of_fp32_groups"
GROUP_PADDINGS = "group_paddings"
PARTITION_COUNT = "partition_count"
ZERO_STAGE = "zero_stage"

# module checkpoint keys
PARAM_SHAPES = "param_shapes"
BUFFER_NAMES = "buffer_names"
ITERATION_KEY = "iteration"
ARGS_KEY = "args"

# checkpoint file naming
MODEL_FILE_PREFIX = "mp_rank_"
ZERO_FILE_PREFIX = "zero_pp_rank_"
LAYER_FILE_PREFIX = "layer_"
OPTIM_FILE_SUFFIX = "_optim_states.pt"
MODEL_FILE_SUFFIX = "_model_states.pt"
BF16_ZERO_FILE_PREFIX = "bf16_" + ZERO_FILE_PREFIX
FP16_ZERO_FILE_PREFIX = "fp16_" + ZERO_FILE_PREFIX

DS_VERSION = "ds_version"
