"""Paged KV-cache bookkeeping: free-list page allocator + prefix cache.

The serving engine's paged mode replaces per-lane contiguous KV rings with
**block tables**: each lane owns a row of page ids into a shared per-layer
page pool, so a lane's KV footprint is ``ceil(tokens / page_size)`` pages
instead of a worst-case ``capacity`` ring — the edge-memory unlock ROADMAP
names (slot count bounded by *actual* usage, not worst-case prompt length).

Two host-side structures manage the pool:

* ``PageAllocator`` — a LIFO free list with per-page **refcounts**.  A page
  with refcount > 1 is shared (prefix reuse); freeing decrements and only
  returns the page to the free list at zero.  Double-free is an error, not
  a silent corruption: every ``decref``/``alloc`` misuse raises.
* ``PrefixCache`` — maps hash-chained **full prompt blocks** (page_size
  tokens each) to the pool page holding their computed KV.  A request whose
  prompt starts with cached blocks joins with those pages mapped read-only
  into its block table (incref'd) and prefills only the uncached suffix;
  the shared system prompt across N requests is prefilled exactly once.
  Divergence is **copy-on-write** at page granularity: writes only ever go
  to pages the lane owns exclusively (``PageAllocator.ensure_writable``
  copies a shared page before the one write that would mutate it — the
  full-prompt-hit last-token recompute).  Eviction is LRU over entries the
  cache is the *sole* holder of (refcount == 1): a block referenced by an
  active lane is never reclaimed.

Neither class locks: both are mutated only under the owning replica's
engine lock (the same discipline as the lane state they index).  The
device-side pools and the gather/scatter paths live in
``repro_torch.models.model`` / ``repro_torch.kernels``; this module is pure
host bookkeeping, a copy of ``repro.serving.paging``, held against the
original by ``tests/test_torch_paging.py``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class PagingError(RuntimeError):
    """An allocator invariant was violated (double free, bad incref, ...)."""


class PageAllocator:
    """Free-list allocator over ``num_pages`` ref-counted pages.

    Pages are plain ints ``0..num_pages-1`` (the row index into every
    attention layer's pool; the pool's extra last row is the engine's
    write dump page and is never allocated).  All-or-nothing ``alloc``:
    a request either gets its whole reservation or leaves the free list
    untouched — partial grants would deadlock two half-admitted prompts
    against each other.
    """

    def __init__(self, num_pages: int):
        if num_pages < 0:
            raise ValueError(f"num_pages={num_pages} < 0")
        self.num_pages = int(num_pages)
        # LIFO free list: recently freed pages are re-used first (their
        # pool rows are hottest in cache, and reuse keeps the table dense)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * self.num_pages

    # ------------------------------------------------------------- queries
    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # ----------------------------------------------------------- lifecycle
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages with refcount 1, or None if the free list
        cannot cover all of them (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        """Add a reference to an allocated page (prefix sharing)."""
        if not (0 <= page < self.num_pages) or self._ref[page] <= 0:
            raise PagingError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> int:
        """Drop one reference; at zero the page returns to the free list.
        Returns the new refcount.  Decref of a free page is a double free
        and raises — the invariant the property suite hammers."""
        if not (0 <= page < self.num_pages) or self._ref[page] <= 0:
            raise PagingError(f"double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
        return self._ref[page]

    def ensure_writable(self, page: int) -> Tuple[int, bool]:
        """Copy-on-write gate before mutating ``page``: exclusively owned
        pages (refcount 1) are returned as-is; a shared page is replaced —
        a fresh page is allocated (refcount 1), the caller's reference on
        the shared page is dropped, and the caller must device-copy the
        pool row ``page -> new``.  Returns ``(writable_page, copied)``;
        raises ``PagingError`` if no page is free for the copy (callers
        reclaim from the prefix cache first)."""
        if self._ref[page] <= 0:
            raise PagingError(f"ensure_writable of free page {page}")
        if self._ref[page] == 1:
            return page, False
        got = self.alloc(1)
        if got is None:
            raise PagingError("no free page for copy-on-write")
        self.decref(page)
        return got[0], True

    # ----------------------------------------------------------- invariants
    def check(self) -> None:
        """Assert the free-list/refcount invariants (test hook):
        free pages and referenced pages partition the pool exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PagingError("duplicate pages in free list")
        for p in range(self.num_pages):
            if self._ref[p] < 0:
                raise PagingError(f"negative refcount on page {p}")
            if (self._ref[p] == 0) != (p in free):
                raise PagingError(
                    f"page {p}: refcount {self._ref[p]} vs free-list "
                    f"membership {p in free}")


def _block_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Chained content hash of one full prompt block: the key commits to
    every token from position 0, so two prompts share a block only when
    their entire prefixes match."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


@dataclass
class _PrefixEntry:
    page: int
    tick: int           # LRU clock at last touch


class PrefixCache:
    """Prompt-block -> pool-page map with LRU reclaim.

    Keys are hash-chained over ``page_size``-token blocks from position 0;
    only **full** blocks are cached (a partial tail block would hold
    positions a different suffix must recompute anyway).  The cache holds
    its own reference on every cached page, so a cached page's refcount is
    ``1 + live sharers`` — ``reclaim`` may evict exactly the entries whose
    refcount is 1 (sole holder: no lane is reading the page).
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = int(page_size)
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._tick = 0
        self.hits = 0            # lookups that matched >= 1 block
        self.lookups = 0

    def __len__(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def cached_pages(self) -> List[int]:
        return [e.page for e in self._entries.values()]

    def match(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt`` in full blocks.  Returns
        ``(matched_tokens, pages)`` with one reference **taken** on every
        returned page (the caller's block table owns them; release through
        the normal lane decref path)."""
        self.lookups += 1
        self._tick += 1
        key = b""
        pages: List[int] = []
        ps = self.page_size
        for start in range(0, len(prompt) - len(prompt) % ps, ps):
            key = _block_hash(key, prompt[start:start + ps])
            e = self._entries.get(key)
            if e is None:
                break
            e.tick = self._tick
            pages.append(e.page)
        for p in pages:
            self.alloc.incref(p)
        if pages:
            self.hits += 1
        return len(pages) * ps, pages

    def register(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Publish the full blocks of a just-prefilled prompt.  ``pages``
        is the lane's block-table row (page i holds block i's KV).  Blocks
        already cached are skipped — including re-registration of the same
        page — so N concurrent identical prompts converge on one entry per
        block.  The cache increfs each newly adopted page (its own hold).
        Returns the number of blocks newly published."""
        self._tick += 1
        key = b""
        added = 0
        ps = self.page_size
        for bi, start in enumerate(
                range(0, len(prompt) - len(prompt) % ps, ps)):
            key = _block_hash(key, prompt[start:start + ps])
            e = self._entries.get(key)
            if e is not None:
                e.tick = self._tick
                continue
            page = int(pages[bi])
            self.alloc.incref(page)
            self._entries[key] = _PrefixEntry(page, self._tick)
            added += 1
        return added

    def reclaim(self, n: int) -> int:
        """Evict least-recently-used entries whose page the cache holds
        the *only* reference to, until ``n`` pages have been freed or no
        evictable entry remains.  Pages still referenced by a live lane
        (refcount > 1) are never touched.  Returns pages freed."""
        freed = 0
        if n <= 0:
            return 0
        for key, e in sorted(self._entries.items(), key=lambda kv: kv[1].tick):
            if freed >= n:
                break
            if self.alloc.refcount(e.page) == 1:
                self.alloc.decref(e.page)      # sole holder: page -> free list
                del self._entries[key]
                freed += 1
        return freed

    def reclaimable(self) -> int:
        """Pages an immediate ``reclaim`` could free (telemetry: the
        admission path advertises ``free + reclaimable`` headroom)."""
        return sum(1 for e in self._entries.values()
                   if self.alloc.refcount(e.page) == 1)

    def drop(self) -> None:
        """Release every cache hold (replica shutdown)."""
        for e in self._entries.values():
            self.alloc.decref(e.page)
        self._entries.clear()
