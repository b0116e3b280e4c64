"""The training random stream: host-side keys and the draws made from them.

The JAX engine hands ``loss_fn`` a threefry key: ``fold_in(base, step)``, then
``fold_in(·, micro-batch)``; the models split it further per draw site. Here
a key is a Python int (64 bits) and ``fold_in`` is a splitmix64 mix, so every
key is a pure function of (seed, step, micro-batch, site), computed on the
host without reading the device. The values are this package's own: bit
parity with threefry is not attempted.

A draw site never holds a generator across calls. It builds one from its key
when it draws (:func:`bernoulli`, :func:`generator`), so a recompute of the
same forward (``torch.utils.checkpoint`` under ``GPT2Config.remat``) draws
the same mask: checkpointing restores only the default generators' state,
and a generator consumed in the forward would draw another mask there.
"""

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

#: the engine's ``eval_batch`` stream root, disjoint from the training steps'
#: (JAX folds 0xFFFFFFFF, outside the non-negative int32 step range)
EVAL_STREAM = 0xFFFFFFFF


def _mix(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit ints."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def root_key(seed: int) -> int:
    """The stream's root for ``seed`` (JAX's ``PRNGKey(seed)``)."""
    return _mix((int(seed) + _GOLDEN) & _MASK64)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (JAX's ``random.fold_in``)."""
    return _mix(key ^ _mix((int(data) + _GOLDEN) & _MASK64))


def generator(key: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``key``."""
    return torch.Generator(device=device).manual_seed(key & ((1 << 63) - 1))


def bernoulli(key: int, p: float, shape, device) -> torch.Tensor:
    """A bool tensor of ``shape``, each entry True with probability ``p`` (JAX's
    ``random.bernoulli``): ``uniform < p`` from :func:`generator`."""
    return torch.rand(shape, generator=generator(key, device), device=device) < p


def dropout(x: torch.Tensor, rate: float, key: Optional[int]) -> torch.Tensor:
    """flax ``nn.Dropout``: each entry kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)`` in x's dtype, the rest zero. The identity at
    rate 0 or without a key (deterministic)."""
    if rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = bernoulli(key, keep, x.shape, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def site_key(key: Optional[int], *path: int) -> Optional[int]:
    """``key`` folded with each integer of ``path`` in turn; None stays None
    (a deterministic forward)."""
    if key is None:
        return None
    for data in path:
        key = fold_in(key, data)
    return key
