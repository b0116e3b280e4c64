"""Gated sparse mixture-of-experts: the gating math, in torch.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (``_capacity``,
``top1gating``, ``top2gating``, ``topk_select``, ``TopKGate``), with the same
results: fp32 one-hot/cumsum math for capacity, random token selection and
the load-balancing aux loss. Noise comes only from a ``torch.Generator`` the
caller passes (JAX's ``rng`` key); without one, gating is deterministic.
Serving uses the eval settings: no noise, no drops, ``capacity = s`` (top-1)
or ``2 s`` (top-2). The dispatch/combine exchange across an expert mesh is
not ported (ROADMAP.md queue 1 item 11).

``s`` tokens, ``e`` experts, ``c`` capacity slots, ``m`` model width, as in
the GShard paper and the JAX package.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# uniform multiplicative jitter half-width (the JAX package's JITTER_EPS)
JITTER_EPS = 1e-2


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside ``[0, n)`` gives a row of zeros, as
    ``jax.nn.one_hot`` does (``F.one_hot`` would raise)."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).float()


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device).clamp(1e-20, 1.0)
    return -torch.log(-torch.log(u).clamp(min=1e-20))


def top1gating(logits: torch.Tensor,
               capacity_factor: float = 1.0,
               min_capacity: int = 4,
               used_token_mask: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               drop_tokens: bool = True,
               use_rts: bool = True,
               capacity: Optional[int] = None):
    """Top-1 gating (Switch-style). Returns ``(l_aux, combine_sec, dispatch_sec,
    exp_counts)``: RSample noise on the logits, capacity-bounded assignment
    with random token selection (RTS) priority, load-balancing aux loss ``E *
    sum(me * ce)``. Noise and RTS need ``generator``."""
    s, e = logits.shape
    if capacity is None:
        # drop_tokens=False must not drop: s slots is the static upper bound
        capacity = _capacity(s, e, capacity_factor, min_capacity) if drop_tokens else s

    if noisy_gate_policy == "RSample" and generator is not None:
        logits_w_noise = logits + _gumbel(logits.shape, generator, logits.device)
    else:
        logits_w_noise = logits

    gates = torch.softmax(logits.float(), dim=1)
    idx1 = torch.argmax(logits_w_noise, dim=1)
    mask1 = _one_hot(idx1, e)
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None].to(mask1.dtype)

    exp_counts = mask1.sum(dim=0)

    # load-balance loss: fraction of probability mass vs fraction of routed tokens
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).sum() * e

    if use_rts and generator is not None:
        # random priority within each expert's queue: tokens admitted uniformly
        # rather than by position (matters when tokens overflow capacity)
        priority = torch.rand(s, generator=generator, device=logits.device)
        order = torch.argsort(priority)
        inv = torch.argsort(order)
        mask1_sorted = mask1[order]
        locations = (torch.cumsum(mask1_sorted, dim=0) - mask1_sorted)[inv]
    else:
        locations = torch.cumsum(mask1, dim=0) - mask1

    loc1 = (locations * mask1).sum(dim=1)        # (s,) slot index within the chosen expert
    if drop_tokens:
        mask1 = mask1 * (loc1 < capacity).to(mask1.dtype)[:, None]

    gates1 = (gates * mask1).sum(dim=1)          # prob of the chosen expert (0 if dropped)
    combine = gates1[:, None, None] * mask1[:, :, None] * _one_hot(loc1, capacity)[:, None, :]
    dispatch = combine > 0
    return l_aux, combine, dispatch, exp_counts


def top2gating(logits: torch.Tensor,
               capacity_factor: float = 1.0,
               min_capacity: int = 4,
               generator: Optional[torch.Generator] = None,
               drop_tokens: bool = True,
               top2_2nd_expert_sampling: bool = True,
               capacity: Optional[int] = None):
    """Top-2 gating (GShard-style): the second expert is chosen after masking
    the first (with Gumbel sampling noise when ``generator`` is given), the
    pair's probabilities are renormalised, capacity is doubled."""
    s, e = logits.shape
    if capacity is None:
        capacity = (_capacity(s, e, 2.0 * capacity_factor, min_capacity)
                    if drop_tokens else 2 * s)

    gates = torch.softmax(logits.float(), dim=1)
    idx1 = torch.argmax(gates, dim=1)
    mask1 = _one_hot(idx1, e)

    logits2 = logits.float()
    if top2_2nd_expert_sampling and generator is not None:
        logits2 = logits2 + _gumbel(logits2.shape, generator, logits.device)
    logits2 = logits2.masked_fill(mask1 > 0, float("-inf"))
    idx2 = torch.argmax(logits2, dim=1)
    mask2 = _one_hot(idx2, e)

    # positions: expert queues fill with first choices before second choices
    locations1 = torch.cumsum(mask1, dim=0) - mask1
    locations2 = torch.cumsum(mask2, dim=0) - mask2 + mask1.sum(dim=0, keepdim=True)

    exp_counts = (mask1 + mask2).sum(dim=0)
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).sum() * e

    loc1 = (locations1 * mask1).sum(dim=1)
    loc2 = (locations2 * mask2).sum(dim=1)
    if drop_tokens:
        mask1 = mask1 * (loc1 < capacity).to(mask1.dtype)[:, None]
        mask2 = mask2 * (loc2 < capacity).to(mask2.dtype)[:, None]

    gates1 = (gates * mask1).sum(dim=1)
    gates2 = (gates * mask2).sum(dim=1)
    denom = (gates1 + gates2).clamp(min=1e-9)
    gates1, gates2 = gates1 / denom, gates2 / denom

    combine1 = gates1[:, None, None] * mask1[:, :, None] * _one_hot(loc1, capacity)[:, None, :]
    combine2 = gates2[:, None, None] * mask2[:, :, None] * _one_hot(loc2, capacity)[:, None, :]
    combine = combine1 + combine2
    dispatch = combine > 0
    return l_aux, combine, dispatch, exp_counts


def topk_select(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode expert selection: ``(idx (s, k) int64, weights (s, k) f32)``.

    The index/weight half of :func:`top1gating`/:func:`top2gating` at eval
    settings (no noise, no drops): the top-1 weight is the UNNORMALISED softmax
    probability of the argmax of the logits; top-2 takes its first choice by
    argmax of the gates, masks it before the second argmax and renormalises
    the pair with the same 1e-9 clamp. ``torch.argmax`` returns the first
    maximum, as ``jnp.argmax`` does. Everything stays on the logits' device:
    no host synchronisation."""
    if k not in (1, 2):
        raise AssertionError("only top-1 and top-2 gating are supported (reference limit)")
    e = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    if k == 1:
        idx = torch.argmax(logits, dim=-1)[:, None]                   # (s, 1)
        return idx, gates.gather(-1, idx)
    idx1 = torch.argmax(gates, dim=-1)
    masked = logits.float().masked_fill(_one_hot(idx1, e) > 0, float("-inf"))
    idx = torch.stack([idx1, torch.argmax(masked, dim=-1)], dim=-1)  # (s, 2)
    g = gates.gather(-1, idx)
    return idx, g / g.sum(-1, keepdim=True).clamp(min=1e-9)


class TopKGate:
    """Gate projection + top-k routing. Functional: the gate weight ``wg (m, e)``
    is passed in (the enclosing module owns it)."""

    def __init__(self, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 use_rts: bool = True, top2_2nd_expert_sampling: bool = True):
        if k not in (1, 2):
            raise AssertionError("only top-1 and top-2 gating are supported (reference limit)")
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.top2_2nd_expert_sampling = top2_2nd_expert_sampling

    def __call__(self, wg: torch.Tensor, x: torch.Tensor, train: bool = True,
                 generator: Optional[torch.Generator] = None):
        """x ``(s, m)`` tokens → ``(l_aux, combine_sec, dispatch_sec, exp_counts)``."""
        inp = x
        if train and self.noisy_gate_policy == "Jitter" and generator is not None:
            u = torch.rand(x.shape, generator=generator, device=x.device)
            inp = x * (1.0 - JITTER_EPS + 2.0 * JITTER_EPS * u).to(x.dtype)
        logits = inp.float() @ wg.float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(
                logits, cf, self.min_capacity,
                noisy_gate_policy=self.noisy_gate_policy if train else None,
                generator=generator, drop_tokens=self.drop_tokens,
                use_rts=self.use_rts and train)
        return top2gating(
            logits, cf, self.min_capacity, generator=generator, drop_tokens=self.drop_tokens,
            top2_2nd_expert_sampling=self.top2_2nd_expert_sampling and train)
