"""Mixture of experts: gating (``sharded_moe``), the stacked experts, the
``MoE`` layer with residual MoE, and the parameter-group helpers.

The token mappings of expert tensor parallelism (``gather_tokens``,
``drop_tokens``) are the identity on one card and wait with the rest of
tensor and expert parallelism: those names raise ``NotImplementedError``
naming the ROADMAP item.
"""

from .experts import Experts  # noqa: F401
from .layer import MoE  # noqa: F401
from .sharded_moe import (JITTER_EPS, TopKGate, _capacity, moe_dispatch_combine,  # noqa: F401
                          top1gating, top2gating, topk_select)
from .utils import (is_moe_param_path, map_moe_params, split_moe_param_paths,  # noqa: F401
                    split_params_into_different_moe_groups_for_optimizer)

_NOT_PORTED = ("expert_param_specs", "drop_tokens", "gather_tokens")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"deepspeed_tpu_torch.moe.{name}: expert and tensor "
                                  "parallelism are not ported yet: ROADMAP.md queue 1 item 11")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
