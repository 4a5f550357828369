"""Radix prefix cache: token-keyed trie over the block pool's KV pages.

The paper's FIFO-mesh thesis — promote LOCAL data to GLOBAL visibility so
nobody re-fetches it — applied to KV pages: the tokens of a shared system
prompt or few-shot preamble are prefilled ONCE, and every later request
whose prompt starts with the same tokens maps the already-computed pages
read-only instead of recomputing them.  The trie is the visibility
fabric: each node owns one page of the pool keyed by the page's token
content, a root-to-node path spells a cached prefix, and refcounts on the
underlying :class:`~repro_torch.serving.kv.BlockPoolKV` pages tie the trie's
holdings into the pool's free-list accounting.

Sharing granularity:

  * a FULL page whose tokens exactly match the next ``page_size`` prompt
    tokens is mapped directly into the requesting slot (refcount + 1, the
    slot never writes inside it);
  * a PARTIAL match — the trie page's tokens and the prompt diverge
    mid-page, or the prompt (capped at ``len - 1``; the last token is
    always recomputed so admission has logits to sample from) ends inside
    the page — is served by COPY-ON-WRITE: the engine copies the page's
    KV into a fresh private page and the request prefills from the
    divergence offset.  A shared page is never mutated.

Lifetime: a finishing request INSERTS its computed pages (prompt +
generated tokens) into the trie, which takes one reference per adopted
page; the pages then survive the request until page pressure reclaims
them.  Eviction is LEAF-FIRST by least-recent-use and only touches pages
no live slot maps (refcount 1, held by the trie alone) — it is registered
as the pool's ``reclaim_hook`` so allocation pressure drains the cache
before anyone preempts a live request.

Like the scheduler, this module is host-side control logic: it
plans COW copies (src page, valid tokens) but the ENGINE executes them on
the device arrays.  Invariants are property-tested in
the reference's tests/test_prefix.py; this copy leaves out the fleet's
page-migration and ownership-directory surface.
"""
from __future__ import annotations

import dataclasses
import itertools

from .kv import BlockPoolKV


class _Node:
    """One cached page: ``tokens`` (the page's token content, possibly a
    partial tail) + the physical ``page`` holding their KV.

    ``owner_host`` is only meaningful in the fleet's
    :class:`PageOwnershipDirectory`, where ``page`` is unused (the
    directory tracks WHICH HOST holds a prefix, not which pool page);
    single-host tries leave it at -1."""
    __slots__ = ("tokens", "page", "parent", "children", "last_use",
                 "owner_host")

    def __init__(self, tokens: tuple[int, ...], page: int,
                 parent: "_Node | None", owner_host: int = -1):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.last_use = 0
        self.owner_host = owner_host

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Admission plan for one prompt lookup.

    ``full_pages`` are mapped read-only (shared); ``cow`` = (source page,
    valid tokens) asks the engine to copy that page into the request's
    first private page before prefill.  ``matched`` tokens of KV arrive
    for free; prefill starts there (mid-page when ``cow`` is set)."""
    full_pages: tuple[int, ...] = ()
    matched_full: int = 0              # tokens covered by full_pages
    cow: tuple[int, int] | None = None  # (src page, valid tokens)

    @property
    def matched(self) -> int:
        return self.matched_full + (self.cow[1] if self.cow else 0)

    @property
    def hit(self) -> bool:
        return self.matched > 0


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixPrefixCache:
    """Page-granular radix trie over ``kv``'s pool; registers itself as
    the pool's ``reclaim_hook``."""

    def __init__(self, kv: BlockPoolKV):
        self.kv = kv
        self.page_size = kv.cfg.page_size
        self.root = _Node((), BlockPoolKV.TRASH, None)
        self._clock = itertools.count(1)
        # counters (surfaced by stats(); bench_traffic reports them)
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0
        self.matched_pages = 0          # full shared-page mappings
        self.cow_count = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        kv.reclaim_hook = self.evict

    # -- lookup -------------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` so
        at least one prompt token is always prefilled (admission needs
        fresh last-token logits to sample the first output from)."""
        tokens = [int(t) for t in tokens]
        usable = len(tokens) - 1
        self.lookups += 1
        node, pos, pages = self.root, 0, []
        now = next(self._clock)
        while usable - pos >= self.page_size:
            child = node.children.get(tuple(tokens[pos:pos + self.page_size]))
            if child is None or child.n_tokens < self.page_size:
                break
            child.last_use = now
            pages.append(child.page)
            pos += self.page_size
            node = child
        cow = None
        if pos < usable:
            # best mid-page overlap among this node's children -> COW
            best, best_n = None, 0
            for child in node.children.values():
                n = _common_prefix(child.tokens, tokens[pos:usable])
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                best.last_use = now
                cow = (best.page, best_n)
                self.cow_count += 1
        m = PrefixMatch(full_pages=tuple(pages), matched_full=pos, cow=cow)
        if m.hit:
            self.hits += 1
            self.matched_tokens += m.matched
            self.matched_pages += len(pages)
        return m

    # -- insert -------------------------------------------------------------

    def insert(self, tokens, pages, n_tokens: int) -> int:
        """Adopt a finished request's cached sequence into the trie.

        ``tokens``: the request's full token stream (prompt + generated);
        ``pages``: the slot's page table entries covering it; only the
        first ``n_tokens`` are actually cached (the final sampled token's
        KV was never written).  Pages whose content is already in the trie
        are skipped (they stay slot-owned and free on release); new pages
        are RETAINED by the trie and survive the slot.  Returns the number
        of pages adopted."""
        tokens = [int(t) for t in tokens]
        node, pos, idx, adopted = self.root, 0, 0, 0
        now = next(self._clock)
        while pos < n_tokens:
            n = min(self.page_size, n_tokens - pos)
            seg = tuple(tokens[pos:pos + n])
            child = node.children.get(seg)
            if child is not None:
                child.last_use = now
                node, pos, idx = child, pos + n, idx + 1
                continue
            if n < self.page_size and any(
                    ch.tokens[:n] == seg for ch in node.children.values()):
                break   # a cached page already subsumes this partial tail
            page = int(pages[idx])
            self.kv.retain(page)
            new = _Node(seg, page, node)
            node.children[seg] = new
            new.last_use = now
            node, pos, idx = new, pos + n, idx + 1
            adopted += 1
        self.inserted_pages += adopted
        return adopted

    # -- fleet migration support -------------------------------------------

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` by dropping trie leaves no live slot
        maps (page refcount 1 — held by the trie alone), least-recently
        used first.  Interior nodes become evictable as their subtrees
        drain, so the cache sheds leaf-first along cold paths.  Returns
        the number of pages actually freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            for node in self._leaves():
                if self.kv.refcount[node.page] != 1:
                    continue        # pinned by a live slot
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                break
            self.kv.release(victim.page)
            del victim.parent.children[victim.tokens]
            freed += 1
            self.evicted_pages += 1
        return freed

    def _leaves(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    # -- introspection ------------------------------------------------------

    def page_refs(self) -> dict[int, int]:
        """page -> number of trie references (for invariant audits:
        pool refcount == slot mappings + these)."""
        refs: dict[int, int] = {}
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            refs[node.page] = refs.get(node.page, 0) + 1
            stack.extend(node.children.values())
        return refs

    @property
    def n_pages(self) -> int:
        return len(self.page_refs())

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "matched_tokens": self.matched_tokens,
            "matched_pages": self.matched_pages,
            "cow_count": self.cow_count,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "pages_held": self.n_pages,
        }

    def check_invariants(self) -> None:
        """Structural audit: page-aligned runs, no orphaned references,
        every non-tail node holds a full page."""
        stack = [(self.root, True)]
        while stack:
            node, _ = stack.pop()
            for child in node.children.values():
                assert child.parent is node
                assert 1 <= child.n_tokens <= self.page_size
                if child.children:
                    assert child.n_tokens == self.page_size, \
                        "interior trie node with a partial page"
                assert self.kv.refcount[child.page] >= 1, \
                    f"trie holds unreferenced page {child.page}"
                stack.append((child, False))
        self.kv.check_invariants(external_refs=self.page_refs())
