"""Speculative decoding: draft-propose / one-pass-verify on the decode path.

Counterpart of ``deepspeed_tpu/inference/speculative.py``. A cheap *draft
proposer* guesses up to k tokens a slot, ONE target forward over each slot's
``[cur_tok, draft...]`` window scores all of them (``prefix_fill`` attention,
``decode_fns.spec_verify``), and the accept rule keeps the longest valid
prefix plus one bonus token: the weight bytes of one decode step, up to k + 1
tokens out.

- **proposers**: :class:`NgramProposer` (self-speculative: the stream's recent
  suffix matched against its own history) and :class:`DraftModelProposer` (a
  second engine greedy-decodes the draft). Both are deterministic, so a draft
  is a point-mass proposal and rejection sampling stays exact for either.
- **accept rules**: :func:`greedy_accept` is the longest prefix matching the
  verify argmax, so every emitted greedy token is a target argmax and greedy
  speculative output equals non-speculative greedy decode wherever the two
  passes' argmaxes agree (everywhere in the f32 CPU tests; on the card the
  verify pass attends in f32 plain code and the decode step in the paged
  kernel, so a near-tie may flip). :func:`accept_tokens` adds the sampled
  path.
- **rollback**: none on the KV side: the verify pass writes the window's K/V
  at rows ``[lens, lens + valid)`` and the caller advances ``lens`` by what it
  commits; rows past that stay masked and are overwritten by later appends.

Key-stream contract (sampled path), on the port's own stream (the Gumbel-max
over a counter hash of ``decode_fns``, not JAX's threefry): window position
``i`` of a request uses the per-(seed, step) state ``h`` of step ``step0 +
i``, the coordinates ``make_slot_select_fn`` uses. The accept uniform comes
from ``fold_hash(h, _FOLD_ACCEPT)`` and the residual resample from the token
hashes of ``fold_hash(h, _FOLD_RESAMPLE)``: two derived states that are none
of ``h``'s token hashes, so the three draws of a position never alias. A fully
accepted round draws its bonus token with ``make_slot_select_fn`` itself at
that step, so it equals the speculation-off draw bit for bit; a rejection
takes the residual stream instead, so a sampled trajectory may leave the
speculation-off one after a rejection: what is kept exactly is the
per-position distribution (accept x with probability p(x), else draw from p
with x taken out and renormalised: mass p(y) on every y).
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from .decode_fns import (fold_hash, gumbel_from_hash, hashes_over_vocab, logits_transform,
                         make_slot_select_fn, step_hashes)

#: tags of the derived states of a position's hash (bit 31 set: see
#: ``decode_fns.fold_hash``), one for the accept uniform, one for the
#: residual resample; the bonus token uses the step's own state
_FOLD_ACCEPT = 0x80000001
_FOLD_RESAMPLE = 0x80000002


@dataclass
class SpeculativeConfig:
    """Knobs for the draft-propose / one-pass-verify loop."""
    k: int = 4                      # draft tokens per verify window
    proposer: str = "ngram"         # "ngram" | "draft_model"
    ngram_max: int = 4              # longest suffix-match tried, down to min
    ngram_min: int = 1
    draft_engine: object = None     # InferenceEngine for "draft_model"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.proposer not in ("ngram", "draft_model"):
            raise ValueError(f"proposer must be 'ngram' or 'draft_model', "
                             f"got {self.proposer!r}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"({self.ngram_min}, {self.ngram_max})")


# ------------------------------------------------------------------ proposers
class NgramProposer:
    """Self-speculative n-gram draft: for ``n`` from ``ngram_max`` down to
    ``ngram_min``, find the latest earlier occurrence of the stream's last
    ``n`` tokens and propose the (up to) ``k`` tokens that followed it.
    Longest match wins; no match proposes nothing (the verify pass is then a
    plain one-token step for that slot). A pure function of the token
    stream, so a retry re-derives the same drafts."""

    deterministic = True

    def __init__(self, ngram_max: int = 4, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"({ngram_min}, {ngram_max})")
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, dtype=np.int32).reshape(-1)
        T = context.size
        if k < 1 or T < self.ngram_min + 1:
            return np.zeros(0, np.int32)
        for n in range(min(self.ngram_max, T - 1), self.ngram_min - 1, -1):
            # every earlier occurrence at once (JAX scans the starts one by
            # one in Python): windows starting at 0 .. T - n - 1, so each ends
            # strictly before the suffix itself
            windows = np.lib.stride_tricks.sliding_window_view(context[:T - 1], n)
            starts = np.flatnonzero((windows == context[T - n:]).all(axis=1))
            if starts.size:             # the latest; it is followed by >= 1 token
                start = int(starts[-1])
                return context[start + n:start + n + k].astype(np.int32)
        return np.zeros(0, np.int32)


class DraftModelProposer:
    """Draft-model proposer: a second ``InferenceEngine`` greedy-decodes ``k``
    tokens from the context's tail, cut to ``max_out_tokens - k`` so that the
    tail and the draft fit the draft engine's cap. Greedy drafting keeps the
    proposal a point mass. One ``generate`` (one prefill, ``k - 1`` decode
    steps, one host sync) a call; ``calls`` counts them. Keep the draft
    engine on the target's device."""

    deterministic = True

    def __init__(self, engine):
        self.engine = engine
        self.cap = int(engine._config.max_out_tokens)
        self.calls = 0

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, dtype=np.int32).reshape(-1)
        if k < 1 or context.size < 1:
            return np.zeros(0, np.int32)
        tail = context[-max(self.cap - k, 1):]
        self.calls += 1
        out = self.engine.generate(tail[None, :], max_new_tokens=k, do_sample=False)
        return np.asarray(out[0, tail.size:], dtype=np.int32)


def make_proposer(cfg: SpeculativeConfig):
    if cfg.proposer == "draft_model":
        if cfg.draft_engine is None:
            raise ValueError("proposer='draft_model' needs a draft_engine")
        return DraftModelProposer(cfg.draft_engine)
    return NgramProposer(cfg.ngram_max, cfg.ngram_min)


# ---------------------------------------------------------------- accept rules
def greedy_accept(draft: np.ndarray, target_argmax: np.ndarray) -> int:
    """Length of the longest prefix of ``draft`` equal to the verify argmax at
    the same positions."""
    n = int(min(draft.size, target_argmax.size))
    a = 0
    while a < n and int(draft[a]) == int(target_argmax[a]):
        a += 1
    return a


def window_draws(logits: torch.Tensor, drafts: torch.Tensor, sampling: Tuple,
                 base_seed: int, seeds: torch.Tensor, steps0: torch.Tensor
                 ) -> Dict[str, np.ndarray]:
    """Everything the accept rule reads of a slot-batch's verify logits
    ``(S, W, V)`` (``drafts (S, W - 1)``; ``seeds``, ``steps0 (S,)``: the
    request coordinates, ``steps0`` the stream index of window position 0),
    computed on the logits' device and fetched in one go: the round's host
    synchronisation.

    Greedy: ``argmax (S, W)``, the only thing read (integers, not the
    ``(S, W, V)`` logits). Sampled, at every window position ``i``: ``bonus``
    ``make_slot_select_fn``'s draw at step ``steps0 + i``; and at draft
    positions: ``p`` the target probability of the draft token, ``u`` the
    accept uniform, ``z`` the mass left without the draft token and
    ``resample`` a Gumbel-max draw from that renormalised residual."""
    if not sampling[0]:
        return {"argmax": logits.argmax(dim=-1).cpu().numpy()}
    S, W, V = logits.shape
    dev = logits.device
    steps = (steps0.long()[:, None] + torch.arange(W, device=dev)[None]).reshape(-1)
    seeds_w = seeds.long()[:, None].expand(S, W).reshape(-1)
    flat = logits.float().reshape(S * W, V)
    bonus = make_slot_select_fn(*sampling)(flat, base_seed, seeds_w, steps)[:, 0]
    h = step_hashes(base_seed, seeds_w, steps).reshape(S, W)[:, :W - 1].reshape(-1)
    probs = torch.softmax(logits_transform(*sampling[1:])(flat), dim=-1)
    probs = probs.reshape(S, W, V)[:, :W - 1].reshape(-1, V)
    d = drafts.long().reshape(-1, 1)
    p = probs.gather(1, d)[:, 0]
    u = (fold_hash(h, _FOLD_ACCEPT).double() + 0.5) / 2.0 ** 32
    resid = probs.double().scatter(1, d, 0.0)
    z = resid.sum(dim=1)
    noise = gumbel_from_hash(hashes_over_vocab(fold_hash(h, _FOLD_RESAMPLE), V)).double()
    resample = (torch.log(resid / z.clamp(min=1e-300)[:, None]) + noise).argmax(dim=1)
    out = {"bonus": bonus.reshape(S, W), "p": p.reshape(S, W - 1), "u": u.reshape(S, W - 1),
           "z": z.reshape(S, W - 1), "resample": resample.reshape(S, W - 1)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def accept_drawn(draft: np.ndarray, draws: Dict[str, np.ndarray],
                 slot: int) -> Tuple[List[int], int]:
    """Accept/reject slot ``slot``'s ``draft (L,)`` from :func:`window_draws`.
    Returns ``(emitted, accepted)``: the accepted draft prefix plus one
    bonus or correction token, and the accepted count.

    Greedy: longest prefix matching the argmax, then the argmax at the first
    mismatch (or at L on a full match). Sampled: accept draft ``x`` at
    position i when ``u < p(x)``; otherwise emit the residual draw and stop
    (a point mass at ``x``, ``z == 0``, accepts); a full acceptance emits
    the bonus at position L."""
    draft = np.asarray(draft, dtype=np.int32).reshape(-1)
    L = int(draft.size)
    if "argmax" in draws:
        tgt = draws["argmax"][slot]
        a = greedy_accept(draft, tgt[:L])
        return [int(x) for x in draft[:a]] + [int(tgt[a])], a
    emitted: List[int] = []
    for i in range(L):
        if draws["u"][slot, i] < draws["p"][slot, i] or draws["z"][slot, i] <= 0.0:
            emitted.append(int(draft[i]))
            continue
        # rejected: the residual's draw, and stop: later drafts were
        # conditioned on the rejected token
        emitted.append(int(draws["resample"][slot, i]))
        return emitted, i
    emitted.append(int(draws["bonus"][slot, L]))
    return emitted, L


def accept_tokens(draft: np.ndarray, logits, *, sampling: Tuple[bool, float, int, float],
                  base_seed: int, seed: int, step0: int) -> Tuple[List[int], int]:
    """Accept/reject one slot's ``draft (L,)`` against its verify logits ``(L +
    1, V)`` (position i scored the prefix through draft i - 1), the request
    at ``(seed, step0)``. Returns ``(emitted, accepted)``; see
    :func:`accept_drawn` and the module's key-stream contract."""
    draft = np.asarray(draft, dtype=np.int32).reshape(-1)
    logits = torch.as_tensor(np.asarray(logits) if not torch.is_tensor(logits) else logits)
    dev = logits.device
    draws = window_draws(logits.float()[None], torch.as_tensor(draft, device=dev)[None],
                         sampling, base_seed, torch.tensor([seed], device=dev),
                         torch.tensor([step0], device=dev))
    return accept_drawn(draft, draws, 0)


# ------------------------------------------------------------------- telemetry
@dataclass
class SpecStats:
    """Per-scheduler speculative-decoding counters (host-side, cumulative)."""
    rounds: int = 0          # verify rounds (== target forward passes)
    proposed: int = 0        # draft tokens offered to the verifier
    accepted: int = 0        # draft tokens that survived accept/reject
    tokens: int = 0          # tokens emitted by spec rounds (incl. bonus)
    draft_s: float = 0.0     # cumulative proposer wall time
    verify_s: float = 0.0    # cumulative verify launch + harvest wall time

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def passes_per_token(self) -> float:
        """Target forward passes per emitted decode token (non-speculative
        decode is exactly 1.0)."""
        return self.rounds / self.tokens if self.tokens else 1.0

    def snapshot(self) -> dict:
        return {
            "spec_rounds": self.rounds,
            "spec_proposed": self.proposed,
            "spec_accepted": self.accepted,
            "spec_tokens": self.tokens,
            "spec_acceptance_rate": self.acceptance_rate,
            "spec_passes_per_token": self.passes_per_token,
            "spec_draft_s": self.draft_s,
            "spec_verify_s": self.verify_s,
        }


def emit_spec_events(telemetry, stats: SpecStats, round_draft_s: float, tick: int) -> None:
    """Publish the ``serving/spec_*`` tags of one round through the owning
    ``ServingTelemetry`` (registry feed and monitor). The emission site sits
    here, in the module that owns the semantics, as in the JAX package."""
    telemetry._write([
        ("serving/spec_acceptance_rate", stats.acceptance_rate, tick),
        ("serving/spec_proposed_total", float(stats.proposed), tick),
        ("serving/spec_accepted_total", float(stats.accepted), tick),
        ("serving/spec_draft_ms", round_draft_s * 1e3, tick),
    ])
