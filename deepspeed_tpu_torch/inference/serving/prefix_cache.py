"""Radix prompt-prefix KV cache: shared system prompts skip prefill.

Counterpart of ``deepspeed_tpu/inference/serving/prefix_cache.py``: a
path-compressed trie over token-ID prefixes whose entries hold the KV of a
prompt's prefill. On admission the scheduler walks the trie, splits the
prompt into ``cached_prefix + suffix``, binds (paged pool) or restores (slot
pool) the prefix's KV into the slot and prefills only the suffix.

Two residency rungs share the one trie. The **device rung** holds hot entries
under ``max_bytes``: gathered slabs on the slot pool, refcounted page indices
on the paged pool. With ``host_tier_bytes > 0`` an LRU eviction from the
device rung **spills**: the entry's KV is gathered into a dense slab in host
memory and the entry moves to the **host rung** under its own budget. A
lookup that lands on a host entry is a **promote** hit: the caller restores
the slab into the new slot (one host-to-device copy) instead of
re-prefilling. The JAX package keeps host slabs as numpy arrays; here they
are CPU tensors (numpy has no bfloat16).

Contracts: a lookup reuses only KV rows whose token path equals the
prompt's own prefix, token for token (a match may end mid-edge: rows ``0..i``
depend only on tokens ``0..i``); a hit never covers the whole prompt (the
first generated token comes from the suffix forward); each rung is an LRU
under its byte budget, and an entry lives in exactly one rung. Host slabs are
independent buffers, so pool rebuilds never invalidate them. No thread
safety is needed: the cache lives inside the single-threaded scheduler.
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class PrefixCacheConfig:
    """``ServingConfig.prefix_cache``; ``None`` disables the cache entirely."""
    enabled: bool = True
    max_bytes: int = 256 * 1024 * 1024   # device budget for cached slabs
    min_hit_tokens: int = 8              # shorter matches re-prefill in full
    min_insert_tokens: int = 8           # don't cache trivially short prompts
    insert_on: str = "completion"        # "completion" | "prefill" (watermark:
    #   insert the moment prefill lands, so concurrent same-prefix requests hit)
    host_tier_bytes: int = 0             # host-RAM spill rung; 0 disables

    def __post_init__(self):
        if self.insert_on not in ("completion", "prefill"):
            raise ValueError(f"insert_on must be 'completion' or 'prefill', "
                             f"got {self.insert_on!r}")
        if self.max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {self.max_bytes}")
        if self.host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes must be >= 0, "
                             f"got {self.host_tier_bytes}")


def slab_bytes(slab: List[Dict]) -> int:
    """Bytes held by one per-layer KV slab."""
    return sum(int(s["k"].nbytes) + int(s["v"].nbytes) for s in slab)


class _Entry:
    """A cached prefix anchored at a trie node (depth == covered tokens).

    Three storage forms: ``slab`` as device arrays — an independent gathered
    per-layer KV copy (slot-row pool, device rung); ``pages`` — REFCOUNTED
    physical page indices into the paged pool (zero-copy: a hit binds them
    into the new slot's table, an eviction is a refcount drop via the owner's
    ``page_release`` hook); ``slab`` as CPU tensors — a spilled dense copy on
    the host rung, restored device-side on a promote hit."""
    __slots__ = ("slab", "tokens", "bytes", "node", "pages")

    def __init__(self, slab: Optional[List[Dict]], tokens: int, node: "_Node",
                 pages=None, nbytes: Optional[int] = None):
        self.slab = slab            # per-layer {"k": (hk, R, d), "v": ...}
        self.pages = pages          # np (n,) physical page indices, or None
        self.tokens = int(tokens)   # real covered rows (== node depth)
        self.bytes = int(nbytes) if nbytes is not None else slab_bytes(slab)
        self.node = node


class _Node:
    """Path-compressed trie node; ``edge`` is the token run from the parent."""
    __slots__ = ("edge", "children", "parent", "entry", "depth")

    def __init__(self, edge: np.ndarray, parent: Optional["_Node"],
                 depth: int):
        self.edge = edge                      # (len,) int32 tokens from parent
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.entry: Optional[_Entry] = None
        self.depth = int(depth)               # tokens root -> this node


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixCache:
    """Radix trie over token-ID prefixes; leaves hold KV slabs; LRU by bytes
    over two residency rungs (device memory, spilled host RAM)."""

    def __init__(self, config: Optional[PrefixCacheConfig] = None):
        self.config = config or PrefixCacheConfig()
        # paged mode: the pool's release_shared, set by the owning scheduler —
        # LRU eviction of a page entry decrefs through it, and so does
        # clear(): against a still-live pool (idle-replica revive) the pages
        # must return to the free list or they leak forever; against a pool
        # about to be discarded (_rebuild_pool) the decref is harmless.
        self.page_release = None
        # paged-mode spill hook: gather_pages(pages, rows) -> dense slab, set
        # by the owning scheduler. Without it a paged eviction cannot spill
        # (there is no dense copy to keep) and falls back to a plain drop.
        self.page_gather = None
        self.root = _Node(np.zeros(0, np.int32), None, 0)
        self._lru: "OrderedDict[int, _Entry]" = OrderedDict()  # id(entry) keyed
        self._host: "OrderedDict[int, _Entry]" = OrderedDict()  # spilled rung
        self.total_bytes = 0
        self.host_bytes = 0
        # counters (telemetry reads these through stats())
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0          # prefill tokens skipped via restores
        self.lookup_tokens = 0       # prompt tokens seen by lookup
        self.inserted = 0
        self.evicted = 0
        self.insert_skipped = 0      # too short / over-budget single slab
        self.spills = 0              # device evictions that kept a host copy
        self.spill_skipped = 0       # evictions that could not spill
        self.promotions = 0          # host-rung hits handed to the restore path
        self.host_evicted = 0        # host-rung LRU drops

    # ------------------------------------------------------------------ lookup
    def lookup(self, prompt) -> Tuple[int, Optional[_Entry]]:
        """Longest exact token match usable as a restored prefix.

        Returns ``(matched_tokens, entry)``; ``(0, None)`` is a miss. The
        returned entry's slab covers *at least* ``matched_tokens`` valid rows
        (restore writes the whole padded slab; rows beyond the match are
        overwritten by the suffix prefill or masked by ``cache_len``).
        ``matched_tokens`` is capped at ``len(prompt) - 1`` so the suffix is
        never empty, and matches below ``min_hit_tokens`` report as misses.
        A host-rung entry (``entry.pages is None`` with a host slab) is a
        **promote** hit: the caller restores the slab into the slot instead
        of binding pages, paying one copy instead of a re-prefill.
        """
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.lookup_tokens += int(prompt.size)
        usable, entry = self._match(prompt)
        if entry is None:
            self.misses += 1
            return 0, None
        self.hits += 1
        self.hit_tokens += usable
        if id(entry) in self._host:
            self.promotions += 1
        self._touch(entry)
        return usable, entry

    def peek(self, prompt) -> Tuple[int, Optional[_Entry]]:
        """What ``lookup`` would return, with no side effects: no hit/miss
        counters, no LRU touch. Admission-pressure eviction peeks the head
        request's prefix to know which entry it must NOT evict (and how many
        fresh pages the head actually needs) without double-counting the
        real lookup that follows on admission; the router's prefix-aware
        dispatch peeks in-process replicas for the same reason."""
        return self._match(np.asarray(prompt, dtype=np.int32).reshape(-1))

    def _match(self, prompt: np.ndarray) -> Tuple[int, Optional[_Entry]]:
        node, i = self.root, 0
        best_anchor: Optional[_Entry] = None     # deepest full-node entry
        best_anchor_len = 0
        stopped: Optional[_Node] = None          # subtree a mid-edge match hit
        while i < prompt.size:
            child = node.children.get(int(prompt[i]))
            if child is None:
                break
            m = _common_len(prompt[i:], child.edge)
            i += m
            if m < child.edge.size:
                # diverged (or prompt ended) mid-edge: every entry below
                # `child` still shares the first `i` tokens with the prompt
                stopped = child
                break
            node = child
            if node.entry is not None:
                best_anchor, best_anchor_len = node.entry, node.depth
        matched, entry = best_anchor_len, best_anchor
        # deeper option: any entry in the subtree we stopped in covers `i`
        sub = stopped if stopped is not None else node
        if i > matched:
            deeper = self._first_entry(sub)
            if deeper is not None:
                matched, entry = i, deeper
        usable = min(matched, int(prompt.size) - 1)
        if entry is None or usable < max(1, self.config.min_hit_tokens):
            return 0, None
        return usable, entry

    def contains(self, prompt) -> bool:
        """Exact-path probe: is this full prompt already DEVICE-resident?
        (Read-only walk — lets callers skip the device gather whose slab
        ``insert`` would only drop; refreshes the resident entry's LRU
        position on True, since the caller's intent was an insert-or-touch.)
        A host-rung entry at the exact path reports False on purpose: the
        caller just finished a full device prefill of this prompt, and the
        re-insert upgrades the spilled copy back to the device rung — without
        that, a spilled prefix would pay the promote copy on every repeat
        forever."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        node, i = self.root, 0
        while i < prompt.size:
            child = node.children.get(int(prompt[i]))
            if child is None:
                return False
            m = _common_len(prompt[i:], child.edge)
            i += m
            if m < child.edge.size:
                return False
            node = child
        if (node.depth == prompt.size and node.entry is not None
                and id(node.entry) in self._lru):
            self._touch(node.entry)
            return True
        return False

    def _first_entry(self, node: _Node) -> Optional[_Entry]:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    # ------------------------------------------------------------------ insert
    def insert(self, prompt, slab: List[Dict]) -> bool:
        """Index ``slab`` (rows padded; rows ``[0, len(prompt))`` are the
        prompt's KV) under the full prompt token path. Re-inserting an already
        device-resident path just refreshes its LRU position (same tokens ⇒
        bit-identical KV, so the resident slab is kept and the new one
        dropped); re-inserting over a host-rung entry upgrades the path back
        to the device rung. Returns True when the slab is (now) resident."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size < max(1, self.config.min_insert_tokens):
            self.insert_skipped += 1
            return False
        nbytes = slab_bytes(slab)
        if nbytes > self.config.max_bytes:
            self.insert_skipped += 1
            return False
        node = self._descend(prompt)
        if node.entry is not None:
            if id(node.entry) in self._lru:
                self._touch(node.entry)
                return True
            self._drop_host(node.entry, prune=False)   # upgrade host -> device
        entry = _Entry(slab, prompt.size, node)
        node.entry = entry
        self._lru[id(entry)] = entry
        self.total_bytes += entry.bytes
        self.inserted += 1
        self._evict_to_budget(keep=entry)
        return True

    def insert_pages(self, prompt, pages, nbytes: int) -> bool:
        """Paged-pool insert: index refcounted page indices under the prompt
        path. Returns True when the cache TOOK OWNERSHIP of the caller's page
        references; False (too short / over budget / already device-resident)
        means the caller must release them. A host-rung entry at the path is
        upgraded: the spilled slab is dropped and the path becomes page-backed
        again. ``nbytes`` counts whole pages and may double-count physically
        shared pages across entries — the budget is an upper bound on
        distinct bytes, never an undercount."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size < max(1, self.config.min_insert_tokens):
            self.insert_skipped += 1
            return False
        if nbytes > self.config.max_bytes:
            self.insert_skipped += 1
            return False
        node = self._descend(prompt)
        if node.entry is not None:
            if id(node.entry) in self._lru:
                self._touch(node.entry)  # resident: keep its refs, drop yours
                return False
            self._drop_host(node.entry, prune=False)   # upgrade host -> device
        entry = _Entry(None, prompt.size, node, pages=np.asarray(pages),
                       nbytes=nbytes)
        node.entry = entry
        self._lru[id(entry)] = entry
        self.total_bytes += entry.bytes
        self.inserted += 1
        self._evict_to_budget(keep=entry)
        return True

    def _descend(self, tokens: np.ndarray) -> _Node:
        """Walk/extend/split the trie so a node exists exactly at ``tokens``."""
        node, i = self.root, 0
        while i < tokens.size:
            child = node.children.get(int(tokens[i]))
            if child is None:
                new = _Node(tokens[i:].copy(), node, tokens.size)
                node.children[int(tokens[i])] = new
                return new
            m = _common_len(tokens[i:], child.edge)
            if m == child.edge.size:
                node, i = child, i + m
                continue
            # split child's edge at m
            mid = _Node(child.edge[:m].copy(), node,
                        child.depth - (child.edge.size - m))
            node.children[int(tokens[i])] = mid
            child.edge = child.edge[m:]
            child.parent = mid
            mid.children[int(child.edge[0])] = child
            node, i = mid, i + m
        return node

    # ---------------------------------------------------------------- eviction
    def _touch(self, entry: _Entry) -> None:
        if id(entry) in self._lru:
            self._lru.move_to_end(id(entry))
        else:
            self._host.move_to_end(id(entry))

    def _evict_to_budget(self, keep: Optional[_Entry] = None) -> int:
        evicted = 0
        while self.total_bytes > self.config.max_bytes and self._lru:
            victim = next(iter(self._lru.values()))
            if victim is keep:
                break        # never evict the slab being inserted
            self._remove(victim)
            evicted += 1
        return evicted

    def evict_lru(self, predicate=None) -> bool:
        """Evict the least-recently-used device entry matching ``predicate``
        (admission-pressure eviction: on the paged pool, cached prefixes pin
        real pool pages, so when admission runs out of free pages the
        scheduler trades cold cached prefixes for admission capacity). The
        predicate lets the caller skip entries whose eviction would free
        nothing — an entry all of whose pages are still bound by live slots
        is pure loss to drop, since the pages stay allocated either way.
        Returns False when nothing eligible remains."""
        for entry in self._lru.values():
            if predicate is None or predicate(entry):
                self._remove(entry)
                return True
        return False

    def _remove(self, entry: _Entry, spill: bool = True) -> None:
        del self._lru[id(entry)]
        self.total_bytes -= entry.bytes
        self.evicted += 1
        spilled = spill and self._spill(entry)
        if entry.pages is not None and self.page_release is not None:
            # paged eviction IS a refcount drop: pages still bound by live
            # slots survive in the pool until those slots release too (the
            # spill gathered its dense host copy before this drop)
            self.page_release(entry.pages)
        if spilled:
            entry.pages = None
            return                  # node keeps the entry, now host-resident
        node = entry.node
        node.entry = None
        self._prune(node)

    def _spill(self, entry: _Entry) -> bool:
        """Demote a device entry to the host rung: gather its KV as a dense
        host slab (CPU tensors) under the host byte budget. Returns False (plain
        drop) when the tier is off, a paged entry has no gather hook, or the
        slab alone exceeds the host budget."""
        if self.config.host_tier_bytes <= 0:
            return False
        if entry.pages is not None:
            if self.page_gather is None:
                self.spill_skipped += 1
                return False
            slab = self.page_gather(entry.pages, entry.tokens)
        else:
            slab = entry.slab
        host = [{"k": s["k"].to("cpu"), "v": s["v"].to("cpu")} for s in slab]
        nbytes = slab_bytes(host)
        if nbytes > self.config.host_tier_bytes:
            self.spill_skipped += 1
            return False
        while (self.host_bytes + nbytes > self.config.host_tier_bytes
               and self._host):
            self._drop_host(next(iter(self._host.values())), prune=True)
        entry.slab = host
        entry.bytes = nbytes
        self._host[id(entry)] = entry
        self.host_bytes += nbytes
        self.spills += 1
        return True

    def _drop_host(self, entry: _Entry, prune: bool) -> None:
        """Remove a host-rung entry; ``prune=False`` is the upgrade path
        (the caller immediately re-occupies the node with a device entry)."""
        del self._host[id(entry)]
        self.host_bytes -= entry.bytes
        if prune:
            self.host_evicted += 1
            node = entry.node
            node.entry = None
            self._prune(node)

    def _prune(self, node: _Node) -> None:
        # prune entry-less leaf chains so the trie doesn't accrete dead paths
        while (node.parent is not None and node.entry is None
               and not node.children):
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node = parent

    def drop_device(self) -> None:
        """Drop the device rung WITHOUT spilling (``_rebuild_pool``: the pool
        the slabs/pages live in was poisoned by a failed dispatch,
        so gathering from it is not trustworthy). Host-rung entries are
        independent host buffers and survive to serve promote hits against
        the rebuilt pool — the tiered analogue of the slot pool's
        "independent slabs survive rebuilds" property."""
        for entry in list(self._lru.values()):
            self._remove(entry, spill=False)

    def clear(self) -> None:
        """Drop everything, both rungs (models total state loss on replica
        process death). Paged entries decref through ``page_release`` first —
        without it an idle replica's revive would strand every cached
        prefix's refcounts in the still-live pool (see ``__init__``)."""
        if self.page_release is not None:
            for entry in self._lru.values():
                if entry.pages is not None:
                    self.page_release(entry.pages)
        self.root = _Node(np.zeros(0, np.int32), None, 0)
        self._lru.clear()
        self._host.clear()
        self.total_bytes = 0
        self.host_bytes = 0

    # ----------------------------------------------------------------- metrics
    @property
    def entries(self) -> int:
        return len(self._lru)

    @property
    def host_entries(self) -> int:
        return len(self._host)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> Dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "inserted": self.inserted,
            "evicted": self.evicted,
            "insert_skipped": self.insert_skipped,
            "entries": self.entries,
            "cached_bytes": self.total_bytes,
            "max_bytes": self.config.max_bytes,
            "spills": self.spills,
            "spill_skipped": self.spill_skipped,
            "promotions": self.promotions,
            "host_evicted": self.host_evicted,
            "host_entries": self.host_entries,
            "spilled_bytes": self.host_bytes,
            "host_max_bytes": self.config.host_tier_bytes,
        }
