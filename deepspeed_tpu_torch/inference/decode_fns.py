"""Generation steps: token selection, prefill and the decode loop.

Counterpart of ``deepspeed_tpu/inference/decode_fns.py`` (``logits_transform``,
``make_select_fn``, ``build_prefill``, ``build_decode_loop``). PyTorch runs
eagerly, so the builders become plain functions, and the compiled
``lax.while_loop`` becomes a Python loop. The loop stops after ``n_new`` tokens
or when every row has emitted EOS; that check reads one flag per step back to
the host.

Sampling draws from the ``torch.Generator`` the caller passes, one per
``generate`` call; its numbers differ from JAX's threefry keys for the same seed.
"""

from typing import Callable

import torch


def logits_transform(temperature: float, top_k: int,
                     top_p: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Temperature, top-k and top-p masking over ``(b, V)`` logits (sampling only)."""

    def transform(x):
        x = x / max(temperature, 1e-6)
        if top_k and top_k > 0:
            kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
            x = x.masked_fill(x < kth, float("-inf"))
        if top_p < 1.0:
            sorted_logits = torch.sort(x, dim=-1, descending=True).values
            cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
            cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
            cutoff = sorted_logits.gather(-1, cutoff_idx.clamp(max=x.shape[-1] - 1))
            x = x.masked_fill(x < cutoff, float("-inf"))
        return x

    return transform


def make_select_fn(do_sample: bool, temperature: float, top_k: int, top_p: float):
    """``(b, V)`` logits + a generator → ``(b, 1)`` int32 tokens."""
    transform = logits_transform(temperature, top_k, top_p)

    def select(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if not do_sample:
            return logits.argmax(dim=-1, keepdim=True).int()
        probs = torch.softmax(transform(logits.float()), dim=-1)
        return torch.multinomial(probs, 1, generator=generator).int()

    return select


def prefill(model, ids: torch.Tensor, caches, lens0: torch.Tensor) -> torch.Tensor:
    """One forward over the right-padded prompt ``ids (b, t)``: the prompt's
    K/V go into the caches and the logits are read only at each row's last
    valid position ``lens0 - 1``. Returns ``(b, V)`` f32 logits."""
    logits, _ = model(ids, caches=caches, cache_lens=torch.zeros_like(lens0),
                      logits_positions=(lens0 - 1).clamp(min=0))
    return logits[:, 0]


def decode_loop(model, select, tok0: torch.Tensor, caches, lens: torch.Tensor, n_new: int,
                eos: int, generator: torch.Generator) -> torch.Tensor:
    """Decode from ``tok0 (b, 1)`` (the prefill's token) until ``n_new`` tokens
    exist or every row has emitted ``eos`` (-1: never). Each step writes its
    K/V at row ``lens`` (a row's true prompt length, so generated tokens
    overwrite the pad rows) and advances it. A finished row keeps emitting
    ``max(eos, 0)``. Returns the ``(b, n)`` tokens, ``tok0`` first."""
    pad = max(eos, 0)
    tok = tok0
    finished = tok0[:, 0] == eos
    out = [tok0[:, 0]]
    for _ in range(1, n_new):
        if bool(finished.all()):
            break
        logits, _ = model(tok, positions=lens[:, None], caches=caches, cache_lens=lens)
        tok = select(logits[:, -1], generator).masked_fill(finished[:, None], pad)
        finished = finished | (tok[:, 0] == eos)
        out.append(tok[:, 0])
        lens = lens + 1
    return torch.stack(out, dim=1)
