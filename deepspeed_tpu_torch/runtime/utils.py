"""Runtime helpers: global norm, clipping, overflow check, parameter count.

Counterpart of ``deepspeed_tpu/runtime/utils.py:17-62``. A "tree" here is a
dict of tensors by name or a sequence of tensors; every result stays on the
device (0-d tensors), so none of these waits on the card.
"""

from typing import Dict, List, Optional, Sequence, Union

import torch

Tree = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


def _leaves(tree: Tree) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over every leaf, summed in f32, as a 0-d f32 tensor."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clip_by_global_norm(tree: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Every leaf times ``min(1, max_norm / (norm + 1e-6))``, in its own dtype;
    ``norm`` defaults to :func:`global_norm`. Returns the leaves as a list."""
    leaves = _leaves(tree)
    if norm is None:
        norm = global_norm(leaves)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [(x * factor).to(x.dtype) for x in leaves]


def has_overflow(tree: Tree) -> torch.Tensor:
    """Whether any leaf holds a non-finite value, as a 0-d bool tensor."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    finite = torch.stack([torch.isfinite(x.float()).all() for x in leaves]).all()
    return torch.logical_not(finite)


def count_parameters(tree: Tree) -> int:
    return sum(int(x.numel()) for x in _leaves(tree))
