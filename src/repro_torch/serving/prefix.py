"""Shared-prefix trie over the paged KV pool (host policy, pure Python).

The port keeps its own copy of the JAX package's trie, line for line in
its logic (tests/test_torch_prefix.py drives both with one op sequence).

EC-DNN serving pays K-fold KV bytes per token (every member caches the
same positions), which makes a cached prefix page worth K times what it
is in a single-model server — and KV entries are a pure function of
(token ids, positions), so two requests sharing a prompt prefix can
share the physical pages that hold it, bit-exactly.  This module keeps
the map from token prefixes to those pages:

  - nodes are PAGE-GRANULAR: a full node covers exactly `page_size`
    tokens at depth d (positions [d*page, (d+1)*page)); a partial node
    (a leaf) covers 1..page_size-1 tokens of a page's head — the tail
    entries of a partially matched page are garbage to a sharer, but
    causality masks them (a request admitted at hit h only ever attends
    positions < h) until copy-on-write gives the sharer its own page;
  - `match` walks full children page by page, then picks the child with
    the longest common token prefix as a partial tail — so a hit is
    TOKEN-granular, not page-granular, and the copy-on-write path in
    the allocator is load-bearing whenever hit % page_size != 0;
  - `insert` runs at release (the only time a chain's content is
    final): content-addressed, so identical prefixes dedup onto the
    first chain that cached them and the duplicate pages go back to the
    free list;
  - pages the trie owns but no slot references (allocator refcount 0)
    form the EVICTABLE pool: `reclaim` frees them leaf-first in LRU
    order when the allocator's free list runs dry, and `flush` drops
    the whole trie (hot-swap: a round-t prefix must never serve round
    t+1 — engine.swap_params calls it).

Invariant the accounting leans on: a sharer references a node only by
walking from the root, so a referenced node's ancestors are always
referenced too — unreferenced nodes form downward-closed subtrees, and
EVERY unreferenced owned page is transitively evictable.  That is why
`evictable` is a plain counter and reclaim(n) can always deliver n <=
evictable pages.

The allocator owns refcounts; the trie never mutates them.  The two
meet through three notifications (`page_referenced`,
`page_unreferenced`, `owns`) and `reclaim` — see
kv_cache.PageAllocator.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    """One cached page: `tokens` is the page's token content (length
    page_size for full nodes, shorter for partial leaves), `page` the
    physical id holding its KV."""

    __slots__ = ("tokens", "page", "parent", "children")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Token-trie of cached prefix pages, LRU-evicted under pressure."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {page_size}")
        self.page_size = int(page_size)
        self._root = _Node((), -1, None)
        # page id -> node, in LRU order (most recently touched last)
        self._lru: "OrderedDict[int, _Node]" = OrderedDict()
        # owned pages whose allocator refcount is 0 (the evictable pool)
        self._unref: set = set()
        # telemetry (engine.page_stats / client report)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.deduped_pages = 0
        self.evicted_pages = 0
        self.flushes = 0

    # -- allocator notifications -------------------------------------------

    def owns(self, page: int) -> bool:
        return page in self._lru

    def page_referenced(self, page: int):
        """A slot now references an owned page (refcount 0 -> 1)."""
        self._unref.discard(page)

    def page_unreferenced(self, page: int):
        """The last slot referencing an owned page released it; the page
        keeps its content and becomes evictable."""
        self._unref.add(page)

    @property
    def evictable(self) -> int:
        return len(self._unref)

    @property
    def cached_pages(self) -> int:
        return len(self._lru)

    def owned_pages(self) -> set:
        """Physical ids the trie currently owns (a copy).  The
        allocator's invariant checker partitions the pool with this:
        a ref-0 page must be either free or in here, never both."""
        return set(self._lru)

    # -- lookup -------------------------------------------------------------

    def _walk(self, tokens: Sequence[int], max_hit: int, touch: bool
              ) -> Tuple[int, List[int], Optional[Tuple[int, int]]]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        node = self._root
        full: List[int] = []
        i = 0
        while i + ps <= min(len(toks), max_hit):
            child = node.children.get(tuple(toks[i:i + ps]))
            if child is None:
                break
            node = child
            full.append(node.page)
            if touch:
                self._lru.move_to_end(node.page)
            i += ps
        tail: Optional[Tuple[int, int]] = None
        want = toks[i:min(len(toks), i + ps)]
        cap = max_hit - i
        best = 0
        for key, child in node.children.items():
            r = min(_lcp(key, want), cap, len(child.tokens))
            if r > best:
                best, tail = r, (child.page, r)
                if touch:
                    self._lru.move_to_end(child.page)
        return i + best, full, tail

    def match(self, tokens: Sequence[int], max_hit: int
              ) -> Tuple[int, List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of `tokens`, capped at max_hit tokens.

        -> (hit, full_pages, tail): `full_pages` are the physical pages
        covering tokens [0, len(full_pages)*page_size) — safe to share
        as-is (every entry valid); `tail` is (src_page, r) when r more
        tokens match inside one further page (hit = full + r) — the
        sharer must COPY that page before its first write lands in it
        (kv_cache.PageAllocator.cow), because entries past r are not
        its content.  Matched nodes are LRU-touched.  The caller caps
        max_hit at prompt_len - 1 so at least one token always
        prefills (the first sampled token needs last-token logits).
        """
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        hit, full, tail = self._walk(tokens, max_hit, touch=True)
        if hit > 0:
            self.hits += 1
            self.hit_tokens += hit
        return hit, full, tail

    def peek(self, tokens: Sequence[int], max_hit: int
             ) -> Tuple[int, List[int], Optional[Tuple[int, int]]]:
        """match() without side effects: no LRU touch, no counters.
        The scheduler's admission gate probes with this (admit_cost) so
        a request costed several times before admission doesn't skew
        hit-rate telemetry or eviction order."""
        return self._walk(tokens, max_hit, touch=False)

    # -- insert (at release) ------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Cache a released chain's prefix content; -> pages claimed.

        tokens: the VALID token prefix (every position's KV written);
        pages: the physical pages covering it, in logical order.
        Content-addressed: a node whose token tuple already exists is
        reused (the duplicate page is NOT claimed — the releasing
        slot's unref sends it to the free list).  The final non-full
        page becomes a partial leaf.  Claimed pages stay referenced by
        the releasing slot until its unref, so claiming never races
        eviction.
        """
        ps = self.page_size
        toks = [int(t) for t in tokens]
        node = self._root
        claimed = 0
        for j in range(len(toks) // ps):
            key = tuple(toks[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(pages[j]), node)
                node.children[key] = child
                self._lru[child.page] = child
                claimed += 1
            else:
                self.deduped_pages += 1
            node = child
        rem = tuple(toks[(len(toks) // ps) * ps:])
        if rem:
            if rem in node.children:
                self.deduped_pages += 1
            else:
                child = _Node(rem, int(pages[len(toks) // ps]), node)
                node.children[rem] = child
                self._lru[child.page] = child
                claimed += 1
        self.inserted_pages += claimed
        return claimed

    # -- eviction -----------------------------------------------------------

    def _evict(self, node: _Node):
        del node.parent.children[node.tokens]
        del self._lru[node.page]
        self._unref.discard(node.page)
        self.evicted_pages += 1

    def reclaim(self, n: int) -> List[int]:
        """Evict up to n unreferenced pages, oldest-first and leaf-first
        (an interior node frees once its children have); -> freed ids.
        The downward-closed invariant guarantees n <= evictable pages
        can always be delivered."""
        freed: List[int] = []
        while len(freed) < n:
            victim = None
            for page, node in self._lru.items():
                if page in self._unref and not node.children:
                    victim = node
                    break
            if victim is None:
                break
            self._evict(victim)
            freed.append(victim.page)
        return freed

    def flush(self) -> List[int]:
        """Drop the whole trie (model hot-swap: cached pages hold the
        OLD model's KV).  -> unreferenced pages for the allocator's
        free list.  Pages still referenced by live slots are merely
        disowned — their last unref frees them normally (drain first
        when zero stale pages must survive)."""
        freed = [p for p in self._lru if p in self._unref]
        self._root = _Node((), -1, None)
        self._lru.clear()
        self._unref.clear()
        self.flushes += 1
        return freed

    # -- telemetry ----------------------------------------------------------

    def hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from cache."""
        return self.hit_tokens / max(self.lookup_tokens, 1)

    def stats(self) -> dict:
        return {"cached_pages": self.cached_pages,
                "evictable_pages": self.evictable,
                "prefix_lookups": self.lookups,
                "prefix_hits": self.hits,
                "prefix_hit_rate": self.hit_rate(),
                "inserted_pages": self.inserted_pages,
                "deduped_pages": self.deduped_pages,
                "evicted_pages": self.evicted_pages}
