"""Mixture-of-experts gating for serving (``sharded_moe``).

The training side of the JAX package's ``moe/`` (the ``MoE`` layer, the
``Experts`` module, the token mappings and the parameter-group helpers) is not
ported: those names raise ``NotImplementedError`` naming the ROADMAP item.
"""

from .sharded_moe import (JITTER_EPS, TopKGate, _capacity, top1gating,  # noqa: F401
                          top2gating, topk_select)

_NOT_PORTED = ("MoE", "Experts", "expert_param_specs", "drop_tokens", "gather_tokens",
               "moe_dispatch_combine", "is_moe_param_path", "map_moe_params",
               "split_moe_param_paths", "split_params_into_different_moe_groups_for_optimizer")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"deepspeed_tpu_torch.moe.{name}: MoE training is not "
                                  "ported yet: ROADMAP.md queue 1 item 10")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
