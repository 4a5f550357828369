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
the reference's tests/test_prefix.py; the fleet's page-migration
surface (``path_nodes``, ``adopt_segment``, ``drop_path``) and its
:class:`PageOwnershipDirectory` are here too.
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

    def path_nodes(self, tokens, n_tokens: int) -> list["_Node"]:
        """The trie nodes spelling the first ``n_tokens`` of ``tokens``
        as FULL pages (migration source: these pages' KV gets exported).
        Stops at the first missing or partial page."""
        tokens = [int(t) for t in tokens]
        node, pos, out = self.root, 0, []
        while pos + self.page_size <= n_tokens:
            child = node.children.get(tuple(tokens[pos:pos + self.page_size]))
            if child is None or child.n_tokens < self.page_size:
                break
            out.append(child)
            node, pos = child, pos + self.page_size
        return out

    def adopt_segment(self, node: "_Node | None", seg: tuple[int, ...],
                      page: int) -> "_Node":
        """Graft one imported full page under ``node`` (None = root).
        The trie takes over the caller's reference to ``page`` (the
        importer allocated it via ``kv.adopt_page`` — no extra retain)."""
        parent = node or self.root
        if seg in parent.children:
            raise ValueError(f"segment {seg[:4]}... already cached")
        new = _Node(seg, page, parent)
        new.last_use = next(self._clock)
        parent.children[seg] = new
        self.inserted_pages += 1
        return new

    def drop_path(self, tokens, n_tokens: int) -> int:
        """Release the full-page path for ``tokens[:n_tokens]`` bottom-up
        (migration source, after a successful transfer: ownership moved,
        so the local copy is dropped).  Only nodes that are leaves with no
        other holder (refcount 1) are dropped — a path still feeding live
        slots or deeper cache entries survives.  Returns pages dropped."""
        dropped = 0
        for node in reversed(self.path_nodes(tokens, n_tokens)):
            if node.children or self.kv.refcount[node.page] != 1:
                break
            self.kv.release(node.page)
            del node.parent.children[node.tokens]
            dropped += 1
            self.evicted_pages += 1
        return dropped

    # -- eviction (the pool's reclaim hook) ---------------------------------

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


@dataclasses.dataclass(frozen=True)
class DirectoryMatch:
    """One directory lookup: the longest run of full prompt pages with a
    LIVE owner, as parallel (token segment, owner host) tuples.  Matching
    stops at the first unpublished or tombstoned page, so ``segments`` is
    always the longest-SURVIVING-ancestor run the recovery path needs."""
    segments: tuple[tuple[int, ...], ...] = ()
    owners: tuple[int, ...] = ()

    @property
    def matched(self) -> int:
        return sum(len(s) for s in self.segments)

    @property
    def hit(self) -> bool:
        return bool(self.segments)


class PageOwnershipDirectory:
    """Router-side map from token prefixes to the host that OWNS their KV
    pages — the fleet analogue of the radix trie, with ``owner_host`` in
    place of a pool page.

    This is the paper's promote-local-to-global story one level up: each
    host's prefix cache is its local SRAM tile, and the directory is the
    mesh fabric that makes a page globally addressable without replicating
    it — a prefix is owned ONCE, and a request landing on another host
    triggers a point-to-point page migration instead of a re-prefill.

    Ownership rules:
      * first live publisher wins (``publish`` never steals from a live
        owner — pages are owned once);
      * a host death TOMBSTONES its entries (``tombstone_host``): the
        nodes stay so the structure under them is preserved, but lookups
        stop at them, which yields recompute-from-longest-surviving-
        ancestor for free;
      * a successful migration calls ``transfer`` to move ownership of
        the migrated path to the destination host;
      * re-publishing over a tombstoned entry revives it under the new
        owner (a survivor recomputed the prefix).
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node((), BlockPoolKV.TRASH, None)
        self.dead: set[int] = set()
        self._clock = itertools.count(1)
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0
        self.published_pages = 0
        self.transferred_pages = 0
        self.tombstoned_pages = 0
        self.revived_pages = 0

    def _walk(self, tokens, limit: int):
        """Yield (node, segment) for each FULL page of ``tokens[:limit]``
        present in the directory, live or dead."""
        tokens = [int(t) for t in tokens]
        node, pos = self.root, 0
        while pos + self.page_size <= limit:
            seg = tuple(tokens[pos:pos + self.page_size])
            child = node.children.get(seg)
            if child is None:
                return
            yield child, seg
            node, pos = child, pos + self.page_size

    def publish(self, tokens, host: int, n_tokens: int | None = None) -> int:
        """Record ``host`` as owner of the full pages of
        ``tokens[:n_tokens]``.  Existing live entries keep their owner;
        tombstoned entries are revived under ``host``.  Returns the
        number of pages newly owned by ``host``."""
        if host in self.dead:
            raise ValueError(f"publish from tombstoned host {host}")
        tokens = [int(t) for t in tokens]
        limit = len(tokens) if n_tokens is None else n_tokens
        node, pos, owned, now = self.root, 0, 0, next(self._clock)
        while pos + self.page_size <= limit:
            seg = tuple(tokens[pos:pos + self.page_size])
            child = node.children.get(seg)
            if child is None:
                child = _Node(seg, BlockPoolKV.TRASH, node, owner_host=host)
                node.children[seg] = child
                self.published_pages += 1
                owned += 1
            elif child.owner_host in self.dead:
                child.owner_host = host
                self.revived_pages += 1
                owned += 1
            child.last_use = now
            node, pos = child, pos + self.page_size
        return owned

    def lookup(self, tokens) -> DirectoryMatch:
        """Longest live-owned full-page prefix of ``tokens``, capped at
        ``len - 1`` (same rule as the local trie: the last prompt token is
        always recomputed so admission has logits)."""
        self.lookups += 1
        segs, owners, now = [], [], next(self._clock)
        for node, seg in self._walk(tokens, len(tokens) - 1):
            if node.owner_host in self.dead:
                break
            node.last_use = now
            segs.append(seg)
            owners.append(node.owner_host)
        m = DirectoryMatch(segments=tuple(segs), owners=tuple(owners))
        if m.hit:
            self.hits += 1
            self.matched_tokens += m.matched
        return m

    def tombstone_host(self, host: int) -> int:
        """Mark every entry owned by ``host`` dead (host loss).  The
        nodes stay in place — children of a tombstoned page published by
        survivors stay reachable once the dead link is re-published."""
        self.dead.add(host)
        n = sum(1 for node in self._nodes() if node.owner_host == host)
        self.tombstoned_pages += n
        return n

    def transfer(self, tokens, n_tokens: int, new_host: int) -> int:
        """Reassign ownership of the full pages of ``tokens[:n_tokens]``
        to ``new_host`` (after a successful migration)."""
        if new_host in self.dead:
            raise ValueError(f"transfer to tombstoned host {new_host}")
        moved = 0
        for node, _ in self._walk(tokens, n_tokens):
            if node.owner_host != new_host:
                node.owner_host = new_host
                moved += 1
        self.transferred_pages += moved
        return moved

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def owners(self) -> dict[int, int]:
        """host -> live directory pages owned (tombstoned hosts excluded)."""
        out: dict[int, int] = {}
        for node in self._nodes():
            if node.owner_host not in self.dead:
                out[node.owner_host] = out.get(node.owner_host, 0) + 1
        return out

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "matched_tokens": self.matched_tokens,
            "published_pages": self.published_pages,
            "transferred_pages": self.transferred_pages,
            "tombstoned_pages": self.tombstoned_pages,
            "revived_pages": self.revived_pages,
            "live_pages": sum(self.owners().values()),
        }
