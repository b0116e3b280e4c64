"""Generation steps: token selection, prefill, the decode loop, the serving
chunks and the speculative verify pass.

Counterpart of ``deepspeed_tpu/inference/decode_fns.py`` (``logits_transform``,
``make_select_fn``, ``make_slot_select_fn``, ``build_prefill``,
``build_prefix_prefill``, ``build_spec_verify``, ``build_paged_spec_verify``,
``build_decode_loop``, ``build_decode_chunk``, ``build_paged_decode_chunk``).
PyTorch runs eagerly, so the builders become plain functions, and the
compiled loops become Python loops. ``decode_loop``
(the ``generate`` path) stops after ``n_new`` tokens or when every row has
emitted EOS; that check reads one flag per step back to the host. A serving
chunk runs exactly ``chunk_size`` steps with every piece of per-slot state on
the device, so nothing inside it waits for the host: the caller's harvest at
the chunk's end is its only synchronisation.

``generate`` samples from the ``torch.Generator`` the caller passes, one per
call; its numbers differ from JAX's threefry keys for the same seed. The
serving chunks sample by Gumbel-max over noise hashed on the device from
``(base_seed, seed, step, token id)``: a request's tokens are a function of
its own seed and token index, independent of its slot and of who shares the
slot-batch, as in JAX, but they are not JAX's threefry draws.
"""

from typing import Callable, List

import torch

from ..ops.paged_attention import gather_kv_dense, page_rows


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


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, in two 16-bit
    halves of ``m`` so that no product leaves int64."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply, lowbias32 constants)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def step_hashes(base_seed: int, seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``(S,)`` int64 32-bit hashes of ``(base_seed, seeds[s], steps[s])``: the
    per-(request, token index) state every draw of that step derives from."""
    h = _mix32(torch.full_like(seeds, base_seed, dtype=torch.int64) & _MASK32)
    h = _mix32(h ^ (seeds.long() & _MASK32))
    return _mix32(h ^ (steps.long() & _MASK32))


def fold_hash(h: torch.Tensor, tag: int) -> torch.Tensor:
    """A state derived from ``h`` by the constant ``tag``. With bit 31 of
    ``tag`` set, ``h ^ tag`` differs from ``h ^ id`` for every token id below
    ``2**31``, and the mix is a bijection, so the derived state is none of
    ``h``'s token hashes."""
    return _mix32(h ^ tag)


def hashes_over_vocab(h: torch.Tensor, vocab: int) -> torch.Tensor:
    """``(S, vocab)`` hashes of each state ``h[s]`` with every token id."""
    ids = torch.arange(vocab, device=h.device, dtype=torch.int64)
    return _mix32(h[:, None] ^ ids[None, :])


def token_hashes(base_seed: int, seeds: torch.Tensor, steps: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``(S, vocab)`` int64 32-bit hashes of ``(base_seed, seeds[s], steps[s],
    token id)``, computed on the seeds' device."""
    return hashes_over_vocab(step_hashes(base_seed, seeds, steps), vocab)


def gumbel_from_hash(h: torch.Tensor) -> torch.Tensor:
    """f32 Gumbel noise from 32-bit hashes. The top 23 bits ``k`` give ``u = (k
    + 0.5) / 2**23``, which f32 holds exactly, so ``u`` lies in ``[2**-24, 1 -
    2**-24]`` and the noise is finite. With 24 bits, ``k + 0.5`` rounds up to
    ``2**24`` at the top value, ``u`` to 1 and the noise to +inf, which wins
    the argmax whatever the logit and turns a token masked to -inf into NaN,
    which argmax takes as well."""
    u = ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def gumbel_noise(base_seed: int, seeds: torch.Tensor, steps: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``(S, vocab)`` f32 Gumbel noise, a pure function of ``(base_seed,
    seeds[s], steps[s], token id)``, computed on the seeds' device."""
    return gumbel_from_hash(token_hashes(base_seed, seeds, steps, vocab))


def make_slot_select_fn(do_sample: bool, temperature: float, top_k: int, top_p: float):
    """``(S, V)`` logits, ``base_seed``, per-slot ``seeds`` and ``steps`` → ``(S, 1)``
    int32 tokens. Greedy is argmax; sampling is argmax of the transformed
    logits plus :func:`gumbel_noise`, so a request's draw depends on its own
    ``(seed, step)`` only, never on its slot or its neighbours."""
    transform = logits_transform(temperature, top_k, top_p)

    def select(logits: torch.Tensor, base_seed: int, seeds: torch.Tensor,
               steps: torch.Tensor) -> torch.Tensor:
        if not do_sample:
            return logits.argmax(dim=-1, keepdim=True).int()
        x = transform(logits.float())
        noise = gumbel_noise(base_seed, seeds, steps, x.shape[-1])
        return (x + noise).argmax(dim=-1, keepdim=True).int()

    return select


def prefix_prefill(model, ids: torch.Tensor, caches, prefix_len: torch.Tensor,
                   suffix_len: torch.Tensor) -> torch.Tensor:
    """Suffix prefill at a nonzero cache offset, the prefix-cache hit path:
    ``caches`` hold a prompt prefix in rows ``[0, prefix_len)``; the forward
    runs over the right-padded suffix ``ids (b, t)`` only, writes its K/V at
    rows ``prefix_len + i`` and reads the logits at the suffix's last valid
    position. Returns ``(b, V)`` f32 logits."""
    t = ids.shape[1]
    positions = prefix_len.long()[:, None] + torch.arange(t, device=ids.device)[None]
    logits, _ = model(ids, positions=positions, caches=caches, cache_lens=prefix_len,
                      logits_positions=(suffix_len - 1).clamp(min=0), prefix_fill=True)
    return logits[:, 0]


def spec_verify(model, ids: torch.Tensor, caches, lens: torch.Tensor) -> torch.Tensor:
    """Speculative one-pass verify over a slot-batch of slot-row caches ``(S,
    h_kv, cap, d)``, updated in place. ``ids (S, t)`` is each slot's window
    ``[cur_tok, draft_0 .. draft_{t-2}]``; the forward runs in ``prefix_fill``
    mode at offset ``lens``: the window's K/V go to rows ``lens + j`` (rows
    at or past ``cap`` are dropped) and each window position attends over
    the committed rows and the window up to itself. The head runs at every
    window position. Rows past what the accept rule keeps stay behind ``lens``
    and are overwritten by later appends: committing is a ``lens`` advance.
    Returns ``(S, t, V)`` f32 logits."""
    t = ids.shape[1]
    positions = lens.long()[:, None] + torch.arange(t, device=ids.device)[None]
    logits, _ = model(ids, positions=positions, caches=caches, cache_lens=lens,
                      logits_positions=None, prefix_fill=True)
    return logits


def paged_spec_verify(model, ids: torch.Tensor, caches: List[dict], page_table: torch.Tensor,
                      lens: torch.Tensor, valid: torch.Tensor, active: torch.Tensor,
                      kv_cap: int) -> torch.Tensor:
    """:func:`spec_verify` against a paged pool: each slot's pages are gathered
    into the dense view once, the verify forward runs on the view, and only
    the valid window rows ``[lens, lens + valid)`` of live slots go back
    through the page table (``valid (S,)`` is each slot's draft length + 1).
    Pad rows, inactive slots and rows at or past ``kv_cap`` go to the null
    page (:func:`page_rows`), so no shared, released or unreserved page is
    written. One index write a layer and tensor."""
    S, t = ids.shape
    dense = [dict(zip(("k", "v"), (x.contiguous() for x in gather_kv_dense(
        c["k"], c["v"], page_table, kv_cap)))) for c in caches]
    logits = spec_verify(model, ids, dense, lens)
    j = torch.arange(t, device=ids.device)
    rows = (lens.long()[:, None] + j[None]).reshape(-1)                    # (S * t,)
    keep = (active[:, None] & (j[None] < valid[:, None])).reshape(-1) & (rows < kv_cap)
    pidx, off = page_rows(page_table.repeat_interleave(t, dim=0), rows,
                          caches[0]["k"].shape[2], keep)
    slots = torch.arange(S, device=ids.device).repeat_interleave(t)
    src = rows.clamp(max=kv_cap - 1)
    for c, dn in zip(caches, dense):
        c["k"][pidx, :, off] = dn["k"][slots, :, src]
        c["v"][pidx, :, off] = dn["v"][slots, :, src]
    return logits


def _chunk_loop(step_logits, select, chunk_size: int, toks, lens, active, remaining,
                eos_ids, seeds, steps, base_seed: int):
    """``chunk_size`` decode steps over a slot-batch, every state tensor on the
    device. ``step_logits(toks, lens)`` runs the model one step and returns
    ``(S, V)`` logits. Inactive slots flow through (fixed shapes), emit
    ``max(eos, 0)`` and freeze; active turns inactive at EOS or when the
    budget runs out, never back, so a slot's real tokens are a prefix of its
    row of ``buf``."""
    buf = torch.zeros((toks.shape[0], chunk_size), dtype=torch.int32, device=toks.device)
    pad = eos_ids.clamp(min=0)[:, None]
    for i in range(chunk_size):
        nxt = select(step_logits(toks, lens), base_seed, seeds, steps)
        toks = torch.where(active[:, None], nxt, pad).int()
        buf[:, i] = toks[:, 0]
        live = active.int()
        remaining = remaining - live
        finished = (toks[:, 0] == eos_ids) | (remaining <= 0)
        lens = lens + live
        steps = steps + live
        active = active & ~finished
    return buf, toks, lens, active, remaining, steps


def decode_chunk(model, select, chunk_size: int, toks, caches, lens, active, remaining,
                 eos_ids, seeds, steps, base_seed: int):
    """``chunk_size`` steps against slot-row caches ``(S, h_kv, cap, d)``,
    updated in place. Per-slot state (all ``(S,)`` on the device unless
    noted): ``toks (S, 1)`` each slot's last token; ``lens`` its KV append
    position, which advances only while the slot is active; ``active``;
    ``remaining`` decode budget; ``eos_ids`` (-1: none); ``seeds``/``steps``
    the sampling coordinates. Returns ``(buf (S, chunk_size), toks, lens,
    active, remaining, steps)``, still on the device."""

    def step_logits(toks, lens):
        logits, _ = model(toks, positions=lens[:, None], caches=caches, cache_lens=lens)
        return logits[:, -1]

    return _chunk_loop(step_logits, select, chunk_size, toks, lens, active, remaining,
                       eos_ids, seeds, steps, base_seed)


def paged_decode_chunk(model, select, chunk_size: int, kv_cap: int, fused: bool, toks,
                       caches: List[dict], page_table: torch.Tensor, lens, active, remaining,
                       eos_ids, seeds, steps, base_seed: int):
    """:func:`decode_chunk` against a paged pool: ``caches`` are global pages
    ``(P, h_kv, page, d)`` per layer, updated in place, and ``page_table (S,
    max_pages)`` int32 on the device, uploaded once for the chunk (pages are
    bound at admission, so it never changes inside one).

    ``fused`` (every model but ALiBi, on the CPU as on the card): each step
    appends at the page-mapped row and attends through :func:`paged_attention`,
    the paged kernel on the card. Otherwise (ALiBi, whose bias the kernel does
    not take): the dense per-slot view is gathered once, the steps run the
    slot-row decode on it, and the rows this chunk appended are mirrored back
    into the pages, as JAX's fallback chunk does."""
    if fused:
        def step_logits(toks, lens):
            logits, _ = model(toks, positions=lens[:, None], caches=caches, cache_lens=lens,
                              page_table=page_table, kv_cap=kv_cap)
            return logits[:, -1]

        return _chunk_loop(step_logits, select, chunk_size, toks, lens, active, remaining,
                           eos_ids, seeds, steps, base_seed)
    dense = [dict(zip(("k", "v"), (x.contiguous() for x in gather_kv_dense(
        c["k"], c["v"], page_table, kv_cap)))) for c in caches]
    lens_in = lens
    out = decode_chunk(model, select, chunk_size, toks, dense, lens, active, remaining,
                       eos_ids, seeds, steps, base_seed)
    done = out[2] - lens_in
    ps = caches[0]["k"].shape[2]
    slots = torch.arange(lens.shape[0], device=lens.device)
    for j in range(chunk_size):
        rows = lens_in + j
        # rows a slot did not append this chunk, or past the cap, go to the
        # null page (page_rows): the mirror writes only rows the slot owns
        pidx, off = page_rows(page_table, rows, ps, (j < done) & (rows < kv_cap))
        src = rows.long().clamp(max=kv_cap - 1)
        for c, dn in zip(caches, dense):
            c["k"][pidx, :, off] = dn["k"][slots, :, src]
            c["v"][pidx, :, off] = dn["v"][slots, :, src]
    return out
