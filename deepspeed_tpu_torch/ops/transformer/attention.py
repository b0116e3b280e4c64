"""Plain multi-head attention: the reference the flash kernel is held to.

Mirrors ``deepspeed_tpu/ops/transformer/attention.py:xla_attention`` without
dropout. The JAX package's ``flash_eligible`` length rule is a TPU tuning
constant and is not carried over: the model sends every prefill to the flash
kernel.
"""

from typing import Optional

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, mask: Optional[torch.Tensor] = None,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q ``(b, t, h, d)``, k/v ``(b, s, h, d)`` → ``(b, t, h, d)``.

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
