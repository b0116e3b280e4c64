"""MoE parameter bookkeeping.

Counterpart of ``deepspeed_tpu/moe/utils.py``: expert and gate parameters are
told from dense ones by name (``experts`` or ``gate_wg`` in the path; the
port's names are dotted, ``h.1.moe.experts.w1``, JAX's slashed, and both
match), so an engine or optimizer can treat the groups apart.
"""

from typing import Any, Callable, Dict, List, Tuple


def is_moe_param_path(path_str: str) -> bool:
    return "experts" in path_str or "gate_wg" in path_str


def split_moe_param_paths(params: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """``(moe_names, dense_names)`` of a parameter dict, in its order."""
    moe, dense = [], []
    for name in params:
        (moe if is_moe_param_path(name) else dense).append(name)
    return moe, dense


def map_moe_params(params: Dict[str, Any], moe_fn: Callable, dense_fn: Callable
                   ) -> Dict[str, Any]:
    """``params`` with ``moe_fn`` applied to expert and gate parameters and
    ``dense_fn`` to the rest."""
    return {name: (moe_fn if is_moe_param_path(name) else dense_fn)(leaf)
            for name, leaf in params.items()}


def split_params_into_different_moe_groups_for_optimizer(
        param_groups: List[Dict]) -> List[Dict]:
    """The reference's signature: each torch-style parameter group split into
    its dense parameters and (as a second group marked ``moe``) those with
    ``allreduce = False``. The engine itself keeps no groups; this serves
    ported user code."""
    out = []
    for group in param_groups:
        moe, dense = [], []
        for p in group.get("params", []):
            (moe if getattr(p, "allreduce", True) is False else dense).append(p)
        out.append(dict(group, params=dense))
        if moe:
            out.append(dict(group, params=moe, moe=True, name="moe"))
    return out
