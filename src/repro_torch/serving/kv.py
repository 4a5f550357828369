"""Block-pool KV manager: refcounted fixed-size pages + per-slot page tables.

The serving analogue of the paper's exchange mesh: a slot's KV history is
broken into fixed-size PAGES (the local SRAM tiles) allocated from one
GLOBAL pool, and the per-slot page table is the exchange fabric that makes
any page globally addressable — no slot ever reserves ``max_len`` tokens of
dense KV up front, so resident bytes track the tokens actually cached.

Pages are REFCOUNTED: a physical page may be mapped read-only by several
slots at once and/or held by the radix prefix cache
(:mod:`repro_torch.serving.prefix`), which is exactly the paper's
"promote local data to global visibility" applied to KV — a shared system
prompt's pages are computed once and then served from the pool instead of
being re-fetched (re-prefilled) per request.  A slot only ever WRITES
pages it owns exclusively (refcount 1 via :meth:`ensure`); sharing a
partially filled page goes through copy-on-write at the engine level.
Releasing a slot decrements refcounts and returns only orphaned pages to
the free list, so preempting a request that shares prefix pages can never
free pages still referenced by the trie or a peer request.

When the free list runs dry, :meth:`reserve` first invokes the registered
``reclaim_hook`` (the prefix cache's leaf-first LRU eviction) before the
caller has to preempt live requests.

This module is host-side only: the page table, free list, refcounts
and counters are numpy/python state (cheap, synchronous,
property-testable), while the page POOL arrays themselves (``k_pages``/
``v_pages`` per layer) are device arrays owned by the engine and indexed
by the table this manager maintains.  Physical page 0 is reserved as the
TRASH page: pad-token writes land there and no slot is ever mapped to it,
so masked scatters never corrupt live history.

Pool sizing/accounting knows the per-page byte cost (layers x page_size x
kv_heads x head_dim x dtype, doubled for K+V, plus f32 scale tables when
the pool is int8-quantized) so ``bytes_resident()`` reports the real HBM
footprint of the cached tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Geometry of one paged pool (shared across every slot)."""
    num_slots: int                 # decode pool width (continuous batching)
    max_len: int                   # per-slot token capacity ceiling
    page_size: int = 16            # tokens per page
    num_pages: int | None = None   # total pool pages incl. trash page 0
    n_layers: int = 1              # byte accounting only
    kv_heads: int = 1
    head_dim: int = 1
    kv_bytes: int = 2              # bf16 = 2; int8 pools pass 1
    quantize: bool = False         # adds f32 scale tables to accounting

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_len // self.page_size)

    @property
    def total_pages(self) -> int:
        if self.num_pages is not None:
            return self.num_pages
        # default: full reservation + trash (degenerates to dense capacity)
        return self.num_slots * self.pages_per_slot + 1

    @property
    def page_bytes(self) -> int:
        """HBM bytes one resident page costs (K + V, + scales when int8)."""
        elems = self.n_layers * self.page_size * self.kv_heads
        b = 2 * elems * self.head_dim * self.kv_bytes
        if self.quantize:
            b += 2 * elems * 4          # f32 scale per (token, head)
        return b


class BlockPoolKV:
    """Free-list page allocator with refcounts and per-slot page tables.

    Invariants (property-tested in tests/test_prefix.py):
      * every page with refcount > 0 is absent from the free list and
        every free page has refcount 0;
      * free_pages + referenced pages == total_pages - 1 always;
      * page 0 (trash) is never allocated and never enters the free list;
      * a page's refcount equals the number of slot-table mappings plus
        the number of external (prefix-trie) references;
      * a slot only writes pages it owns exclusively — shared (refcount
        > 1) pages are mapped strictly BEFORE a slot's private tail, and
        the slot's write positions never reach them.
    """

    TRASH = 0

    def __init__(self, cfg: PagedKVConfig):
        self.cfg = cfg
        n = cfg.total_pages
        if n < 2:
            raise ValueError("pool needs at least one page beyond trash")
        # LIFO free list: recently freed pages are re-used first (keeps the
        # hot working set dense in the pool — the fragmentation counter
        # below measures how well that works).
        self._free: list[int] = list(range(n - 1, 0, -1))
        self.refcount = np.zeros((n,), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(cfg.num_slots)]
        # per-slot count of SHARED (read-only, prefix-cache) leading pages
        self._slot_shared: list[int] = [0] * cfg.num_slots
        self.lengths = np.zeros((cfg.num_slots,), np.int64)
        self.page_table = np.zeros((cfg.num_slots, cfg.pages_per_slot),
                                   np.int32)
        # invoked with the page deficit when the free list runs dry; must
        # return the number of pages it actually freed (the prefix cache
        # registers its leaf-first LRU eviction here)
        self.reclaim_hook: Callable[[int], int] | None = None
        # counters
        self.alloc_count = 0
        self.free_count = 0
        self.evict_count = 0
        self.share_count = 0           # shared-page mappings (cache hits)
        self.peak_pages = 0

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.cfg.total_pages - 1) - len(self._free)

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._slot_pages[slot])

    def shared_prefix_pages(self, slot: int) -> int:
        """Leading pages of ``slot`` mapped read-only from the prefix
        cache (the slot never writes positions inside them)."""
        return self._slot_shared[slot]

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)

    def can_alloc(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def reserve(self, n_pages: int) -> bool:
        """Like :meth:`can_alloc`, but allowed to RECLAIM cold cache pages
        through ``reclaim_hook`` (prefix-trie leaf-first LRU eviction)
        before answering — preempting live requests is the caller's last
        resort, not its first."""
        deficit = n_pages - len(self._free)
        if deficit > 0 and self.reclaim_hook is not None:
            self.reclaim_hook(deficit)
        return n_pages <= len(self._free)

    def capacity(self, slot: int) -> int:
        """Token capacity currently mapped for ``slot``."""
        return len(self._slot_pages[slot]) * self.cfg.page_size

    # -- refcounting --------------------------------------------------------

    def retain(self, page: int) -> None:
        """Add one external reference to a LIVE page (prefix-trie insert,
        shared-slot mapping)."""
        if page == self.TRASH:
            raise ValueError("cannot retain the trash page")
        if self.refcount[page] <= 0:
            raise ValueError(f"retain of unreferenced page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was orphaned and
        went back to the free list."""
        if self.refcount[page] <= 0:
            raise ValueError(f"release of unreferenced page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            self.free_count += 1
            return True
        return False

    # -- mutation -----------------------------------------------------------

    def _alloc_page(self) -> int:
        page = self._free.pop()
        self.refcount[page] = 1
        self.alloc_count += 1
        return page

    def adopt_page(self) -> int:
        """Allocate one page held by an EXTERNAL owner (no slot table
        entry) — the landing pad for a KV page migrated in from another
        host, which the importer then hands to the prefix trie.  The
        caller owns the single reference and must ``release`` it (or
        ``retain`` on the trie's behalf, then ``release``) to balance.
        Runs ``reclaim_hook`` first so a warm cache does not starve
        migrations."""
        if not self._free and self.reclaim_hook is not None:
            self.reclaim_hook(1)
        if not self._free:
            raise MemoryError("pool dry: cannot adopt a migrated page")
        page = self._alloc_page()
        self.peak_pages = max(self.peak_pages, self.used_pages)
        return page

    def map_shared(self, slot: int, pages: list[int]) -> None:
        """Map prefix-cache pages read-only at the FRONT of an empty
        slot's table (cache-hit admission).  The slot takes one reference
        per page; it must never write positions inside them."""
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot}: map_shared on non-empty slot")
        for i, page in enumerate(pages):
            self.retain(page)
            self._slot_pages[slot].append(page)
            self.page_table[slot, i] = page
        self._slot_shared[slot] = len(pages)
        self.share_count += len(pages)
        self.peak_pages = max(self.peak_pages, self.used_pages)

    def ensure(self, slot: int, target_len: int) -> int:
        """Map enough PRIVATE pages for ``target_len`` tokens; returns
        pages added.  Tries ``reclaim_hook`` (cold prefix-cache pages)
        before raising ``MemoryError`` — the scheduler turns that into an
        eviction decision."""
        if target_len > self.cfg.max_len:
            raise ValueError(f"target_len {target_len} > max_len "
                             f"{self.cfg.max_len}")
        need = self.pages_for(target_len) - len(self._slot_pages[slot])
        if need <= 0:
            return 0
        if need > len(self._free) and self.reclaim_hook is not None:
            self.reclaim_hook(need - len(self._free))
        if need > len(self._free):
            raise MemoryError(
                f"pool dry: slot {slot} needs {need} pages, "
                f"{len(self._free)} free")
        added = 0
        for _ in range(need):
            page = self._alloc_page()
            idx = len(self._slot_pages[slot])
            self._slot_pages[slot].append(page)
            self.page_table[slot, idx] = page
            added += 1
        self.peak_pages = max(self.peak_pages, self.used_pages)
        return added

    def advance(self, slot: int, n_tokens: int) -> None:
        """Record ``n_tokens`` more tokens resident in ``slot``.

        Capacity must already be mapped (``ensure``)."""
        new_len = int(self.lengths[slot]) + n_tokens
        if new_len > self.capacity(slot):
            raise RuntimeError(
                f"slot {slot}: length {new_len} exceeds mapped capacity "
                f"{self.capacity(slot)} — call ensure() first")
        self.lengths[slot] = new_len

    def set_length(self, slot: int, n_tokens: int) -> None:
        """Set a slot's resident length directly (cache-hit admission:
        the matched prefix is already cached in the mapped shared pages)."""
        if n_tokens > self.capacity(slot):
            raise RuntimeError(
                f"slot {slot}: length {n_tokens} exceeds mapped capacity "
                f"{self.capacity(slot)}")
        self.lengths[slot] = n_tokens

    def free_slot(self, slot: int, *, evicted: bool = False) -> int:
        """Unmap every page of ``slot``, dropping one reference each.
        Only orphaned pages (refcount 0) return to the free list — pages
        still referenced by the prefix trie or a peer slot survive.
        Returns the number of pages actually freed."""
        pages = self._slot_pages[slot]
        released = 0
        for page in reversed(pages):
            if self.release(page):
                released += 1
        pages.clear()
        self._slot_shared[slot] = 0
        self.page_table[slot, :] = self.TRASH
        self.lengths[slot] = 0
        if evicted:
            self.evict_count += 1
        return released

    # -- accounting ---------------------------------------------------------

    def bytes_resident(self) -> int:
        return self.used_pages * self.cfg.page_bytes

    def stats(self) -> dict:
        """Utilization (tokens cached / token capacity mapped) and pool
        fragmentation (mapped-but-unfilled tail tokens / mapped capacity).
        Shared pages count once in pool terms (``pages_used``) but once
        per mapping in slot terms — ``pages_shared`` is the dedup win."""
        cap = sum(len(p) for p in self._slot_pages) * self.cfg.page_size
        toks = int(self.lengths.sum())
        return {
            "pages_total": self.cfg.total_pages - 1,
            "pages_used": self.used_pages,
            "pages_free": self.free_pages,
            "pages_shared": int((self.refcount > 1).sum()),
            "peak_pages": self.peak_pages,
            "tokens_resident": toks,
            "bytes_resident": self.bytes_resident(),
            "peak_bytes": self.peak_pages * self.cfg.page_bytes,
            "utilization": toks / cap if cap else 0.0,
            "fragmentation": (cap - toks) / cap if cap else 0.0,
            "allocs": self.alloc_count,
            "frees": self.free_count,
            "shares": self.share_count,
            "evictions": self.evict_count,
        }

    def check_invariants(self, external_refs: dict[int, int] | None = None
                         ) -> None:
        """Cheap structural audit (used by the property tests).

        ``external_refs`` maps page -> reference count held OUTSIDE slot
        tables (the prefix trie's holdings, from
        ``RadixPrefixCache.page_refs()``).  When given, every page's
        refcount must EQUAL slot mappings + external refs; when omitted
        (callers that cannot see the trie) refcounts must merely cover
        the slot mappings."""
        slot_refs: dict[int, int] = {}
        for slot, pages in enumerate(self._slot_pages):
            for i, p in enumerate(pages):
                assert p != self.TRASH, f"slot {slot} mapped to trash"
                assert self.page_table[slot, i] == p
                slot_refs[p] = slot_refs.get(p, 0) + 1
            shared = self._slot_shared[slot]
            assert shared <= len(pages), f"slot {slot} shared > mapped"
            for p in pages[shared:]:
                # private tail pages are exclusively owned iff nothing
                # external pinned them; sharing happens only via the
                # shared prefix — never checked here because the trie may
                # legitimately hold a finished slot's tail pages
                assert self.refcount[p] >= 1
            assert (self.page_table[slot, len(pages):] == self.TRASH).all()
            assert self.lengths[slot] <= len(pages) * self.cfg.page_size
        free = set(self._free)
        assert len(free) == len(self._free), "free list duplicates"
        assert self.TRASH not in free, "trash page entered the free list"
        referenced = {int(p) for p in np.nonzero(self.refcount > 0)[0]}
        assert not (free & referenced), "page both free and referenced"
        assert free | referenced == set(range(1, self.cfg.total_pages)), \
            "page leaked: neither free nor referenced"
        assert len(free) + len(referenced) == self.cfg.total_pages - 1
        for p in slot_refs:
            assert self.refcount[p] >= slot_refs[p], \
                f"page {p}: refcount {self.refcount[p]} < slot maps"
        if external_refs is not None:
            for p in referenced:
                want = slot_refs.get(p, 0) + external_refs.get(p, 0)
                assert self.refcount[p] == want, \
                    (f"page {p}: refcount {self.refcount[p]} != "
                     f"{slot_refs.get(p, 0)} slot + "
                     f"{external_refs.get(p, 0)} external refs")
            for p, n in external_refs.items():
                assert n == 0 or self.refcount[p] > 0, \
                    f"page {p} externally referenced but unallocated"
