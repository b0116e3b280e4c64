"""Model contract for the training engine.

Counterpart of ``deepspeed_tpu/models/base.py`` (``Model``). The engine keeps
the parameters itself, as a dict of f32 master tensors by name, and the model
is a pair of functions over such a dict: ``init_fn(seed, device)`` makes it,
``loss_fn(params, batch, rng)`` returns the scalar loss of one micro-batch (or
``(loss, aux)``, of which the engine uses the loss). The
engine hands ``loss_fn`` the masters cast to the compute dtype, so gradients
land on the f32 masters through the cast, as they do in the JAX engine.
``rng`` is a key of the engine's random stream (``runtime/rng.py``: an int,
where JAX passes a threefry key), for dropout and gating noise; a model that
draws nothing ignores it, and ``None`` means a deterministic forward.

``Segment`` (the ZeRO-3 parameter-offload unit) waits for item 12.
"""

import dataclasses
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Model:
    loss_fn: Callable        # (params, batch, rng) -> scalar loss, or (loss, aux)
    init_fn: Callable        # (seed, device) -> params, f32
    apply_fn: Optional[Callable] = None     # (params, batch) -> outputs
    flops_per_sample: Optional[float] = None
    name: str = "model"

    def init(self, seed: int, device) -> Params:
        return self.init_fn(seed, device)
