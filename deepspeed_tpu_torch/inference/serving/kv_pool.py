"""KV cache pools: slot rows, and the paged page-table pool.

Counterpart of ``deepspeed_tpu/inference/serving/kv_pool.py``.

:class:`SlotKVPool` is one allocation of ``init_cache(cfg, slots, cap)``;
requests borrow a slot (row) for their lifetime, so every slot reserves its
worst-case ``cap`` rows. Release zero-fills the row.

:class:`PagedKVPool` (the default) is one global pool of fixed-size KV pages
per layer, ``{"k": (P, h_kv, page, d), ...}``, behind a per-slot page table.
A slot allocates only the pages its ``prompt + max_new`` needs; pages are
refcounted, so the prefix cache shares a prompt's pages without copying (a
hit binds their indices into the new slot's table, and a partly covered
boundary page is copied on write). Released pages are not zero-filled: every
row below a slot's ``cache_len`` is freshly written or a verbatim shared
prefix row, and attention masks every row at or past ``cache_len``. Page 0 is
the null page: never allocated, it pads every table row.

The JAX pools update their buffers through donated ``jit`` movers that return
new arrays; here every mover writes the pool's tensors in place, and nothing
rebinds them. Only :meth:`ChunkedDecodeExecutor.reset_pool` replaces the
tensors, by building a new pool. Movers write only pages the slot owns
(table entries past its page count are the null page, and are skipped).

``gather_prefix``/``restore_prefix`` stay on both pools as the dense-slab
serialization API (page-granular underneath on the paged pool).

Per-slot sequence lengths are scheduler state (host numpy, uploaded with each
decode chunk); the pool owns the device tensors, the free lists and (paged)
the host page table and refcounts.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ...models.causal_lm import init_cache
from ...ops.paged_attention import NULL_PAGE

Slab = List[Dict[str, torch.Tensor]]     # per layer {"k": (hk, R, d), "v": ...}


def _slab_nbytes(caches, rows: int) -> int:
    """Bytes of a dense ``rows``-row slab of these per-layer caches (the head
    and feature sizes are the last-but-two and last dimensions of both pool
    layouts)."""
    total = 0
    for c in caches:
        hk, d = c["k"].shape[1], c["k"].shape[3]
        total += 2 * hk * int(rows) * d * c["k"].element_size()
    return total


class SlotKVPool:
    """Fixed ``slots × cap`` KV rows with acquire/release slot recycling."""

    def __init__(self, model_config, slots: int, cap: int, dtype=None, device=None):
        if slots < 1 or cap < 2:
            raise ValueError(f"need slots >= 1 and cap >= 2, got {slots}, {cap}")
        self.slots = int(slots)
        self.cap = int(cap)
        self.caches = init_cache(model_config, self.slots, self.cap, dtype=dtype,
                                 device=device)
        self._free: List[int] = list(range(self.slots))

    # ------------------------------------------------------------ slot lifecycle
    def can_admit(self, tokens: Optional[int] = None, matched: int = 0) -> bool:
        """Admission protocol shared with :class:`PagedKVPool`: a slot is the
        reservation, so only a free slot matters."""
        return bool(self._free)

    def acquire(self, tokens: Optional[int] = None, prefix_pages=None,
                matched: int = 0) -> Optional[int]:
        """Borrow a free slot, or ``None`` when the pool is full (the page
        arguments are the paged pool's and are ignored)."""
        return self._free.pop(0) if self._free else None

    def release(self, slot: int) -> None:
        """Zero-fill ``slot`` and return it: a recycled slot must never leak
        the previous request's KV."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        for c in self.caches:
            c["k"][slot].zero_()
            c["v"][slot].zero_()
        self._free.append(slot)

    def scatter_prefill(self, slot: int, one_caches) -> None:
        """Write a prefill's batch-1 per-layer cache into row ``slot``."""
        for c, o in zip(self.caches, one_caches):
            c["k"][slot] = o["k"][0]
            c["v"][slot] = o["v"][0]

    # --------------------------------------------------------- prefix-cache I/O
    def gather_prefix(self, slot: int, rows: int) -> Slab:
        """Copy rows ``[0, rows)`` of ``slot`` out as an independent slab."""
        R = int(rows)
        if not 0 < R <= self.cap:
            raise ValueError(f"rows must be in [1, cap={self.cap}], got {R}")
        return [{"k": c["k"][slot, :, :R].clone(), "v": c["v"][slot, :, :R].clone()}
                for c in self.caches]

    def slab_nbytes(self, rows: int) -> int:
        return _slab_nbytes(self.caches, rows)

    def restore_prefix(self, slot: int, slab: Slab) -> None:
        """Write a slab into rows ``[0, slab_rows)`` of ``slot``."""
        R = int(slab[0]["k"].shape[1])
        if R > self.cap:
            raise ValueError(f"slab rows {R} exceed pool cap {self.cap}")
        for c, s in zip(self.caches, slab):
            c["k"][slot, :, :R] = s["k"].to(c["k"].device)
            c["v"][slot, :, :R] = s["v"].to(c["v"].device)

    # ------------------------------------------------------------------ metrics
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.slots

    @property
    def paged(self) -> bool:
        return False


class PagedKVPool:
    """Global fixed-size KV pages behind per-slot page tables (see the module
    docstring). ``cap`` is the per-slot row capacity; pages round it up
    (``max_pages = ceil(cap / page)``), and every dense view is sliced back to
    exactly ``cap`` rows, so the attention math matches the slot-row pool's."""

    def __init__(self, model_config, slots: int, cap: int, page_size: int = 16,
                 dtype=None, total_pages: Optional[int] = None, device=None):
        if slots < 1 or cap < 2:
            raise ValueError(f"need slots >= 1 and cap >= 2, got {slots}, {cap}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.slots = int(slots)
        self.cap = int(cap)
        self.page_size = ps = int(page_size)
        self.max_pages = mp = math.ceil(self.cap / ps)   # table width per slot
        if total_pages is None:
            # default budget: the slot-row pool's bytes plus the null page
            total_pages = self.slots * mp + 1
        self.total_pages = P = int(total_pages)
        if P < mp + 1:
            raise ValueError(f"total_pages={P} cannot hold even one max-size request "
                             f"({mp} pages) plus the null page")
        cfg = model_config
        self.n_layer = cfg.n_layer
        dtype = dtype or cfg.dtype
        shape = (P, cfg.kv_heads, ps, cfg.head_dim)
        self.caches = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.n_layer)]
        self.page_nbytes = 2 * cfg.n_layer * cfg.kv_heads * ps * cfg.head_dim * \
            torch.tensor([], dtype=dtype).element_size()
        # host allocator state
        self.page_table = np.full((self.slots, mp), NULL_PAGE, np.int32)
        self._free_slots: List[int] = list(range(self.slots))
        self._free_pages: List[int] = list(range(1, P))     # 0 = null page
        self._ref = np.zeros(P, np.int64)
        self._slot_npages = np.zeros(self.slots, np.int32)
        self._slot_tokens = np.zeros(self.slots, np.int64)  # reserved tokens
        self.cow_copies_total = 0

    @property
    def device(self) -> torch.device:
        return self.caches[0]["k"].device

    # --------------------------------------------------------------- allocator
    def pages_for(self, tokens: int) -> int:
        return math.ceil(max(1, int(tokens)) / self.page_size)

    def _fresh_needed(self, tokens: int, matched: int = 0) -> int:
        """Pages a new request must allocate (shared full pages bind for free;
        a partly covered boundary page costs one copy-on-write page)."""
        return self.pages_for(tokens) - int(matched) // self.page_size

    def can_admit(self, tokens: Optional[int] = None, matched: int = 0) -> bool:
        tokens = self.cap if tokens is None else int(tokens)
        return bool(self._free_slots) and \
            len(self._free_pages) >= self._fresh_needed(tokens, matched)

    def acquire(self, tokens: Optional[int] = None, prefix_pages=None,
                matched: int = 0) -> Optional[int]:
        """Borrow a slot and allocate its pages, or ``None`` when slot or page
        capacity is exhausted. ``tokens`` is the reservation (``prompt +
        max_new``; default ``cap``). With ``prefix_pages``/``matched`` (a
        prefix-cache hit) the first ``matched // page`` table entries bind the
        shared pages (refcount bump, no copy) and a partly covered boundary
        page is copied into a fresh private page, so the new slot's suffix
        writes never touch shared rows."""
        tokens = self.cap if tokens is None else int(tokens)
        if tokens > self.cap:
            raise ValueError(f"reservation {tokens} exceeds cap {self.cap}")
        matched = int(matched) if prefix_pages is not None else 0
        need = self.pages_for(tokens)
        shared_full = matched // self.page_size
        cow = 1 if matched % self.page_size else 0
        if not self._free_slots or len(self._free_pages) < need - shared_full:
            return None
        if prefix_pages is not None and shared_full + cow > len(prefix_pages):
            raise ValueError(f"matched={matched} needs {shared_full + cow} prefix pages, "
                             f"entry holds {len(prefix_pages)}")
        slot = self._free_slots.pop(0)
        row = self.page_table[slot]
        n = 0
        for j in range(shared_full):                   # zero-copy shared bind
            p = int(prefix_pages[j])
            self._ref[p] += 1
            row[n] = p
            n += 1
        if cow:                                        # boundary page: copy on write
            src = int(prefix_pages[shared_full])
            dst = self._free_pages.pop(0)
            for c in self.caches:
                c["k"][dst] = c["k"][src]
                c["v"][dst] = c["v"][src]
            self.cow_copies_total += 1
            self._ref[dst] = 1
            row[n] = dst
            n += 1
        for _ in range(need - n):                      # private fresh pages
            p = self._free_pages.pop(0)
            self._ref[p] = 1
            row[n] = p
            n += 1
        self._slot_npages[slot] = need
        self._slot_tokens[slot] = tokens
        return slot

    def release(self, slot: int) -> None:
        """Return the slot and decref its pages; a page at refcount 0 goes back
        to the free list (one the prefix cache still holds survives). No
        zero-fill: see the module docstring."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} is already free")
        row = self.page_table[slot]
        for j in range(int(self._slot_npages[slot])):
            self._decref(int(row[j]))
        row[:] = NULL_PAGE
        self._slot_npages[slot] = 0
        self._slot_tokens[slot] = 0
        self._free_slots.append(slot)

    def _decref(self, page: int) -> None:
        if page == NULL_PAGE:
            return
        if self._ref[page] <= 0:
            raise AssertionError(f"refcount underflow on page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free_pages.append(page)

    # ----------------------------------------------------- prefix page sharing
    def share_prefix(self, slot: int, tokens: int) -> np.ndarray:
        """Refcount-bump the slot's pages covering rows ``[0, tokens)`` and
        return their indices: the prefix cache's zero-copy insert. The boundary
        page is shared too; a later hit trusts only its rows below the matched
        length and copies it before writing."""
        n = self.pages_for(tokens)
        if n > int(self._slot_npages[slot]):
            raise ValueError(f"slot {slot} holds {self._slot_npages[slot]} pages, "
                             f"cannot share {n}")
        pages = self.page_table[slot, :n].copy()
        for p in pages:
            self._ref[int(p)] += 1
        return pages

    def release_shared(self, pages) -> None:
        """Drop a prefix-cache entry's page references (its eviction)."""
        for p in pages:
            self._decref(int(p))

    def page_ref(self, page: int) -> int:
        return int(self._ref[int(page)])

    def table_row(self, slot: int) -> np.ndarray:
        return self.page_table[slot]

    # ------------------------------------------------------------ page movers
    def _write_rows(self, pages, slab: Slab) -> None:
        """Write dense per-layer rows ``(hk, R, d)`` into ``pages`` in order,
        zero-padding the last page past row R."""
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
        n = int(idx.shape[0])
        for c, s in zip(self.caches, slab):
            for name in ("k", "v"):
                x = s[name].to(device=self.device, dtype=c[name].dtype)
                hk, R, d = x.shape
                if R < n * self.page_size:
                    x = torch.cat([x, x.new_zeros(hk, n * self.page_size - R, d)], dim=1)
                x = x[:, :n * self.page_size].reshape(hk, n, self.page_size, d)
                c[name][idx] = x.permute(1, 0, 2, 3)

    def _read_rows(self, pages, rows: int) -> Slab:
        """A dense independent slab of rows ``[0, rows)`` of ``pages``."""
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)
        out = []
        for c in self.caches:
            hk, d = c["k"].shape[1], c["k"].shape[3]
            out.append({name: c[name][idx].permute(1, 0, 2, 3).reshape(hk, -1, d)[:, :rows]
                        for name in ("k", "v")})
        return out

    def scatter_prefill(self, slot: int, one_caches) -> None:
        """Write a prefill's dense batch-1 per-layer cache into the slot's own
        pages (rows past the last of them are not written)."""
        self._write_rows(self.page_table[slot, :int(self._slot_npages[slot])],
                         [{"k": o["k"][0], "v": o["v"][0]} for o in one_caches])

    # --------------------------------------------------------- slab I/O (wire)
    def slab_nbytes(self, rows: int) -> int:
        return _slab_nbytes(self.caches, rows)

    def gather_prefix(self, slot: int, rows: int) -> Slab:
        """Copy rows ``[0, rows)`` of ``slot`` out as an independent dense slab."""
        R = int(rows)
        if not 0 < R <= self.cap:
            raise ValueError(f"rows must be in [1, cap={self.cap}], got {R}")
        return self._read_rows(self.page_table[slot, :self.pages_for(R)], R)

    def gather_pages(self, pages, rows: int) -> Slab:
        """Dense slab of rows ``[0, rows)`` from any page-index vector: the
        prefix cache's spill path gathers an evicted entry's pages before its
        references drop."""
        R = int(rows)
        if not 0 < R <= self.cap:
            raise ValueError(f"rows must be in [1, cap={self.cap}], got {R}")
        n = self.pages_for(R)
        if n > len(pages):
            raise ValueError(f"{R} rows span {n} pages, got {len(pages)}")
        return self._read_rows(np.asarray(pages)[:n], R)

    def restore_prefix(self, slot: int, slab: Slab) -> None:
        """Write a dense slab into rows ``[0, slab_rows)`` of a freshly acquired
        slot; boundary-page rows past the slab are zero-padded, the state they
        are in unwritten."""
        R = int(slab[0]["k"].shape[1])
        if R > self.cap:
            raise ValueError(f"slab rows {R} exceed pool cap {self.cap}")
        n = self.pages_for(R)
        if n > int(self._slot_npages[slot]):
            raise ValueError(f"slot {slot} holds {self._slot_npages[slot]} pages, "
                             f"slab needs {n}")
        self._write_rows(self.page_table[slot, :n], slab)

    def promote_prefix(self, slot: int, slab: Slab, matched: int) -> None:
        """Restore a host-tier slab's first ``matched`` rows into a freshly
        acquired slot acquired without shared pages (the write would
        otherwise clobber rows other slots trust): the promote path of the
        tiered prefix cache. The pages covering ``matched`` are written whole,
        from the slab's rows or zeros; rows in ``[matched, page multiple)`` are
        overwritten by the suffix prefill or masked by ``cache_len``."""
        m = int(matched)
        rows = int(slab[0]["k"].shape[1])
        if not 0 < m <= min(rows, self.cap):
            raise ValueError(f"matched must be in [1, min(slab rows {rows}, cap "
                             f"{self.cap})], got {m}")
        n = self.pages_for(m)
        if n > int(self._slot_npages[slot]):
            raise ValueError(f"slot {slot} holds {self._slot_npages[slot]} pages, "
                             f"promote needs {n}")
        self._write_rows(self.page_table[slot, :n], slab)

    # ------------------------------------------------------------------ metrics
    @property
    def paged(self) -> bool:
        return True

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        return self.total_pages - 1 - len(self._free_pages)

    @property
    def occupancy(self) -> float:
        """Slot occupancy, as the slot-row pool's; page use is in :meth:`stats`."""
        return 1.0 - len(self._free_slots) / self.slots

    @property
    def shared_pages(self) -> int:
        """Pages referenced more than once (slot and cache, or two slots)."""
        return int(np.sum(self._ref > 1))

    @property
    def page_fragmentation(self) -> float:
        """The fraction of allocated page rows beyond the slots' token
        reservations (allocation-granularity waste)."""
        pages = int(np.sum(self._slot_npages))
        if pages == 0:
            return 0.0
        return 1.0 - int(np.sum(self._slot_tokens)) / (pages * self.page_size)

    def stats(self) -> Dict[str, float]:
        return {
            "pages_in_use": float(self.pages_in_use),
            "page_fragmentation": float(self.page_fragmentation),
            "prefix_shared_pages": float(self.shared_pages),
            "cow_copies_total": float(self.cow_copies_total),
            "total_pages": float(self.total_pages - 1),
            "page_size": float(self.page_size),
        }
