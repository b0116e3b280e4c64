"""Attention implementations by name, and the plain attention.

Counterpart of ``deepspeed_tpu/ops/transformer/attention.py``: models ask
:func:`get_attention_impl` for an implementation by name and stay agnostic of
it. ``auto`` and ``flash`` give the flash kernels (``ops/attention/flash.py``,
differentiable through ``FlashAttnFunction``); ``xla`` gives
:func:`reference_attention`, the port's counterpart of the JAX package's
``xla_attention`` (without attention dropout, which is not ported), in plain
tensor code. The JAX package's ``flash_eligible`` length rule is a TPU tuning
constant and is not carried over: ``auto`` sends every length to the kernels.
A callable is taken as it is: block-sparse attention is the impl that
``ops/attention/block_sparse.py:make_sparse_attention_impl`` binds from a
``SparsityConfig`` (its kernels forward and backward), as in
``GPT2Config(attention_impl=make_sparse_attention_impl(config))``.
"""

from typing import Callable, Optional, Union

import torch

from ..attention.flash import flash_attention


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, mask: Optional[torch.Tensor] = None,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q ``(b, t, h, d)``, k/v ``(b, s, h, d)`` → ``(b, t, h, d)``: the plain
    attention the flash kernels are held to.

    Scores and softmax in f32; the probabilities are cast to v's dtype before
    the product with v. ``mask`` is a ``(b, s)`` padding mask or a
    ``(b, 1, t, s)`` full mask (nonzero = attend)."""
    t, d = q.shape[1], q.shape[-1]
    s = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / d ** 0.5
    neg = torch.finfo(torch.float32).min
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t)
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        logits = logits.masked_fill(~mask.bool(), neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


def get_attention_impl(name: Union[str, Callable] = "xla") -> Callable:
    """``auto`` | ``flash`` → the flash kernels; ``xla`` →
    :func:`reference_attention`; a callable, such as the block-sparse impl of
    ``make_sparse_attention_impl(config)``, is returned as it is. ``ring`` and
    ``ulysses`` (sequence parallelism) are not ported yet."""
    if callable(name):
        return name
    if name in ("auto", "flash"):
        return flash_attention
    if name == "xla":
        return reference_attention
    if name in ("ring", "ulysses"):
        raise NotImplementedError(f"attention_impl={name!r} (sequence parallelism) is not "
                                  "ported yet: ROADMAP.md queue 1 item 13")
    raise ValueError(f"Unknown attention impl {name!r}")
