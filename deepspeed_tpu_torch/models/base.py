"""Model contract for the training engine.

Counterpart of ``deepspeed_tpu/models/base.py`` (``Model``, ``Segment``). The
engine keeps the parameters itself, as a dict of f32 master tensors by name,
and the model is a pair of functions over such a dict: ``init_fn(seed,
device)`` makes it, ``loss_fn(params, batch, rng)`` returns the scalar loss of
one micro-batch (or ``(loss, aux)``, of which the engine uses the loss). The
engine hands ``loss_fn`` the masters cast to the compute dtype, so gradients
land on the f32 masters through the cast, as they do in the JAX engine.
``rng`` is a key of the engine's random stream (``runtime/rng.py``: an int,
where JAX passes a threefry key), for dropout and gating noise; a model that
draws nothing ignores it, and ``None`` means a deterministic forward.

``segments`` cuts a model into :class:`Segment` slices for ZeRO-3 parameter
offload (``zero_optimization.offload_param``): the engine then keeps no
parameter on the device and streams one slice's parameters at a time
(``runtime/zero/param_offload.py``). ``models/causal_lm.py:causal_lm_model``
sets it; a model without it refuses ``offload_param``.
"""

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Segment:
    """One host-streamable slice of a model, the ZeRO-3 parameter-offload unit
    (JAX ``base.py:19-45``). The engine pushes one segment's parameters to the
    device at a time, runs its forward, and in the backward recomputes that
    forward and differentiates it. ``kind`` fixes ``apply_fn``'s signature:

    - ``first``: ``apply_fn(params, batch, rng) -> carry``
    - ``mid``:   ``apply_fn(params, carry, batch, rng) -> carry``
    - ``last``:  ``apply_fn(params, carry, batch, rng) -> scalar loss``

    ``params`` is a tuple ordered like ``param_keys``, each entry that key's
    dict of tensors by their names in the whole model's parameter dict (a key
    is a prefix of those names: ``layers.3`` holds ``layers.3.q_proj.weight``
    and the rest of that layer). ``init_keys`` are the keys the segment makes:
    a key shared with an earlier segment (a tied embedding) is in
    ``param_keys`` only. ``init_fn(seed, device)`` returns one dict of f32
    tensors a key of ``init_keys``, in that order; on the ``meta`` device it
    returns the shapes without drawing.
    """
    name: str
    kind: str                      # "first" | "mid" | "last"
    param_keys: Tuple[str, ...]
    init_keys: Tuple[str, ...]
    init_fn: Callable              # (seed, device) -> tuple of dicts, one a init key
    apply_fn: Callable


@dataclasses.dataclass
class Model:
    loss_fn: Callable        # (params, batch, rng) -> scalar loss, or (loss, aux)
    init_fn: Callable        # (seed, device) -> params, f32
    apply_fn: Optional[Callable] = None     # (params, batch) -> outputs
    flops_per_sample: Optional[float] = None
    name: str = "model"
    # the ZeRO-3 parameter-offload decomposition (None: offload_param is refused)
    segments: Optional[List[Segment]] = None

    def init(self, seed: int, device) -> Params:
        return self.init_fn(seed, device)
