"""Tiled linear layers and the chunked-vocab cross-entropy.

Counterpart of ``deepspeed_tpu/runtime/zero/tiling.py`` (reference
``deepspeed/runtime/zero/tiling.py``, ``TiledLinear:22``).

:class:`TiledDense` stores one projection's weight as an ``in_splits ×
out_splits`` grid of tiles, each its own parameter, so a ZeRO stage or an
offload tier could hold or stream one tile at a time; the math is exactly
``x @ W + b`` with ``W = concat(tiles)``. The transposition rule is
``Dense``'s (``models/gpt2.py``): tile ``weight_{i}_{o}`` is ``(out_o,
in_i)``, the JAX tile ``kernel_{i}_{o}`` ``(in_i, out_o)`` transposed
(``models/convert.py:tiled_dense_params_from_jax``); ``bias_{o}`` keeps its
layout.

:func:`chunked_vocab_cross_entropy` is what the reference uses tiling for in
practice, the LM head: the mean next-token loss against a tied embedding
without the ``(b, t, V)`` logits, in the forward or the backward. JAX gets
that from a ``lax.scan`` over vocab slices; here it is a
``torch.autograd.Function`` whose backward recomputes each slice's logits.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _bounds(total: int, splits: int):
    """The tile edges along a dimension of ``total``: as even as possible,
    JAX ``TiledDense._bounds``."""
    cuts = [round(i * total / splits) for i in range(splits + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


class TiledDense(nn.Module):
    """JAX ``TiledDense``: a ``Dense`` of ``in_features → features`` whose
    weight is an ``in_splits × out_splits`` grid of tiles (uneven dims split
    as evenly as possible). Each output tile is the sum over input tiles of
    ``x[..., in_i] @ tile`` in ``dtype`` (default: x's), plus its bias cast
    to ``dtype``; the output tiles are concatenated.

    Initialisation (:meth:`reset_parameters`) is JAX's: truncated normal
    (two standard deviations) with variance ``(1 / in_splits) / fan_in`` of
    the tile's own fan-in, so the sum of ``in_splits`` partials has a plain
    ``Dense``'s statistics; zero biases."""

    def __init__(self, in_features: int, features: int, in_splits: int = 1,
                 out_splits: int = 1, use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.in_bounds = _bounds(in_features, in_splits)
        self.out_bounds = _bounds(features, out_splits)
        self.in_splits, self.use_bias, self.dtype = in_splits, use_bias, dtype
        for oi, (o0, o1) in enumerate(self.out_bounds):
            for ii, (i0, i1) in enumerate(self.in_bounds):
                self.register_parameter(f"weight_{ii}_{oi}", nn.Parameter(
                    torch.empty(o1 - o0, i1 - i0, device=device)))
            if use_bias:
                self.register_parameter(f"bias_{oi}", nn.Parameter(
                    torch.zeros(o1 - o0, device=device)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters():
            if name.startswith("bias_"):
                p.zero_()
                continue
            # flax variance_scaling(1 / in_splits, "fan_in", "truncated_normal")
            std = math.sqrt(1.0 / self.in_splits / p.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        outs = []
        for oi in range(len(self.out_bounds)):
            acc = None
            for ii, (i0, i1) in enumerate(self.in_bounds):
                part = F.linear(x[..., i0:i1].to(dt), getattr(self, f"weight_{ii}_{oi}").to(dt))
                acc = part if acc is None else acc + part
            if self.use_bias:
                acc = acc + getattr(self, f"bias_{oi}").to(dt)
            outs.append(acc)
        return torch.cat(outs, dim=-1)


def tiled_kernel_from_dense(weight, in_splits: int, out_splits: int,
                            bias=None) -> Dict[str, torch.Tensor]:
    """A ``Dense`` weight ``(out, in)`` (and bias) as :class:`TiledDense`'s
    parameters (JAX ``tiled_kernel_from_dense``, which takes the flax kernel
    ``(in, out)``; reference ``TiledLinear.copy_params_from``)."""
    weight = torch.as_tensor(weight)
    out_dim, in_dim = weight.shape
    params = {}
    for oi, (o0, o1) in enumerate(_bounds(out_dim, out_splits)):
        for ii, (i0, i1) in enumerate(_bounds(in_dim, in_splits)):
            params[f"weight_{ii}_{oi}"] = weight[o0:o1, i0:i1].clone()
        if bias is not None:
            params[f"bias_{oi}"] = torch.as_tensor(bias)[o0:o1].clone()
    return params


def _slice_logits(xc: torch.Tensor, wte: torch.Tensor, c0: int, c1: int,
                  cd: torch.dtype) -> torch.Tensor:
    """Vocab rows ``c0:c1``'s f32 logits, rounded as the full head rounds
    them (``models/gpt2.py``): the product of ``cd`` operands, then
    ``.float()``."""
    return torch.matmul(xc, wte[c0:c1].to(cd).t()).float()


class ChunkedVocabCrossEntropy(torch.autograd.Function):
    """The forward keeps three running vectors of N = b·t values (max, sum of
    exponentials, target logit) over the vocab slices and saves ``x``,
    ``wte``, the labels and the f32 logsumexp; the backward recomputes each
    slice's logits and accumulates ``dx`` (in f32) and the slice's
    ``dwte`` from ``(softmax − onehot) · mask / count``. No ``(N, V)``
    tensor exists in either."""

    @staticmethod
    def forward(ctx, x, wte, labels, chunk, ignore_index, compute_dtype):
        cd = compute_dtype or torch.float32
        vocab = wte.shape[0]
        xc = x.reshape(-1, x.shape[-1]).to(cd)
        lab = labels.reshape(-1).long()
        n = xc.shape[0]
        m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
        s = torch.zeros(n, dtype=torch.float32, device=x.device)
        tgt = torch.zeros(n, dtype=torch.float32, device=x.device)
        for c0 in range(0, vocab, chunk):
            c1 = min(c0 + chunk, vocab)
            logits = _slice_logits(xc, wte, c0, c1, cd)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = (lab - c0).clamp(0, c1 - c0 - 1)
            score = logits.gather(1, idx[:, None])[:, 0]
            tgt = torch.where((lab >= c0) & (lab < c1), score, tgt)
        lse = m + torch.log(s)
        mask = lab != ignore_index
        loss = torch.where(mask, lse - tgt, 0.0).sum() / mask.sum().clamp(min=1)
        ctx.save_for_backward(x, wte, labels, lse)
        ctx.args = (chunk, ignore_index, cd)
        return loss

    @staticmethod
    def backward(ctx, grad):
        x, wte, labels, lse = ctx.saved_tensors
        chunk, ignore_index, cd = ctx.args
        vocab = wte.shape[0]
        xc = x.reshape(-1, x.shape[-1]).to(cd)
        lab = labels.reshape(-1).long()
        mask = lab != ignore_index
        weight = mask.float() * (grad.float() / mask.sum().clamp(min=1))
        dx = torch.zeros(xc.shape, dtype=torch.float32, device=x.device)
        dwte = torch.empty_like(wte)
        for c0 in range(0, vocab, chunk):
            c1 = min(c0 + chunk, vocab)
            p = _slice_logits(xc, wte, c0, c1, cd).sub_(lse[:, None]).exp_()
            idx = (lab - c0).clamp(0, c1 - c0 - 1)
            inside = ((lab >= c0) & (lab < c1)).float()
            p.scatter_add_(1, idx[:, None], -inside[:, None])
            dlogits = p.mul_(weight[:, None]).to(cd)
            dx += torch.matmul(dlogits, wte[c0:c1].to(cd)).float()
            dwte[c0:c1] = torch.matmul(dlogits.t(), xc).to(wte.dtype)
        return dx.reshape(x.shape).to(x.dtype), dwte, None, None, None, None


def chunked_vocab_cross_entropy(x: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                                chunk: int = 8192, ignore_index: int = -100,
                                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mean next-token cross-entropy against a tied embedding head without
    the ``(b, t, V)`` logits (JAX ``chunked_vocab_cross_entropy``).

    ``x``: final hidden states ``(b, t, d)`` (after ``ln_f``); ``wte``:
    ``(V, d)``; ``labels``: ``(b, t)``, ``ignore_index`` masked; 0 when every
    label is masked. ``compute_dtype`` (e.g. bf16) is the head product's
    operand dtype. Each slice's logits are rounded as the port's full head
    rounds them (the product in ``compute_dtype``, then f32), so ``chunk``
    changes memory, not the function: the loss equals the full-logits loss
    up to the order of f32 sums. JAX pads ``wte`` to a whole number of
    slices and masks the padding; here the last slice is short."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return ChunkedVocabCrossEntropy.apply(x, wte, labels, chunk, ignore_index, compute_dtype)
