"""Optimizer protocol.

Counterpart of ``deepspeed_tpu/ops/optimizer.py``: an optimizer is a pair of
functions over the engine's parameter dict, with the learning rate passed in
each step, so a schedule is a Python float and never a rebuild. Where the JAX
functions return new trees, ``update`` here writes the new parameters and
state into the old tensors, which saves a copy of both; ``keep`` (a 0-d bool
tensor) makes it keep every old value instead (the fp16 overflow skip), decided
on the device.
"""

from typing import Any, Callable, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params, lr, keep=None)``
    updates ``params`` and ``state`` in place."""
    init: Callable[[Any], Any]
    update: Callable[..., None]
    name: str = "optimizer"


def assigner(keep: Optional[torch.Tensor]) -> Callable[[torch.Tensor, torch.Tensor], None]:
    """``assign(old, new)``: write ``new`` into ``old``, or with ``keep`` (a 0-d
    bool tensor) keep ``old`` where it is set, decided on the device."""
    def assign(old: torch.Tensor, new: torch.Tensor) -> None:
        old.copy_(new if keep is None else torch.where(keep, old, new))
    return assign
