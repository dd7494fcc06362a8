"""Paged KV cache for the LLM engine: fixed-size heap pages with a hard
budget, plus the prefix cache of full pages.

Port of ``ray_tpu/serve/llm/kv_cache.py`` in its heap mode. The slab-arena
mode (pages as object-plane entries leased from a raylet) belongs to the
object-plane slice of the port, so ``KVPool`` takes no ``use_arena`` and
``arena_backed`` is always False.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np


class KVPage:
    """One fixed-size KV page: ``data`` is a writable float32 array of
    shape (page_tokens, kv_dim)."""

    __slots__ = ("data", "used", "refs", "chain", "cached")

    def __init__(self, data: np.ndarray):
        self.data = data
        self.used = 0             # tokens written
        self.refs = 1             # sequences holding it (+1 while cached)
        self.chain = None         # hex chain hash once full + cached
        self.cached = False

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def full(self) -> bool:
        return self.used >= self.capacity


class KVPool:
    """Page allocator with a hard budget (``max_pages``) — the number the
    scheduler's KV-budget admission checks against."""

    arena_backed = False

    def __init__(self, page_tokens: int, kv_dim: int, max_pages: int):
        self.page_tokens = int(page_tokens)
        self.kv_dim = int(kv_dim)
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._allocated = 0       # live pages (active + cached)
        self._cached = 0

    # -- page lifecycle -------------------------------------------------
    def alloc(self):
        """One page, or None when the budget is exhausted (the scheduler
        turns that into queueing / load shedding, never an error)."""
        with self._lock:
            if self._allocated >= self.max_pages:
                return None
            self._allocated += 1
        return KVPage(np.zeros((self.page_tokens, self.kv_dim),
                               dtype=np.float32))

    def incref(self, page: KVPage):
        with self._lock:
            page.refs += 1

    def decref(self, page: KVPage):
        """Drop one reference; the last one frees the page."""
        with self._lock:
            page.refs -= 1
            if page.refs > 0:
                return
            self._allocated -= 1
            if page.cached:
                self._cached -= 1
                page.cached = False

    def mark_cached(self, page: KVPage, chain: str):
        with self._lock:
            page.chain = chain
            if not page.cached:
                page.cached = True
                self._cached += 1

    def uncache(self, page: KVPage):
        with self._lock:
            if page.cached:
                page.cached = False
                self._cached -= 1

    # -- introspection ---------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            cached = self._cached
            active = self._allocated - cached
            return {"active": active, "cached": cached,
                    "free": self.max_pages - self._allocated}

    def available(self) -> int:
        with self._lock:
            return self.max_pages - self._allocated


class PrefixCache:
    """Full pages retained after sequence end, keyed by their prefix
    chain hash — the radix tree flattened to one dict because chain
    values already commit to their whole prefix. LRU-bounded in pages;
    eviction decrefs (the page truly frees once no running sequence
    shares it)."""

    def __init__(self, pool: KVPool, max_pages: int):
        self.pool = pool
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._pages: "Dict[str, KVPage]" = {}   # chain hex -> page
        self._order: List[str] = []             # LRU, oldest first
        self.hits_tokens = 0
        self.lookup_tokens = 0

    def insert(self, chain: str, page: KVPage):
        """Adopt one full page under its chain hash (takes one ref)."""
        evict: List[KVPage] = []
        with self._lock:
            if chain in self._pages:
                return  # first copy wins; caller still owns its page
            self._pages[chain] = page
            self._order.append(chain)
            while len(self._order) > self.max_pages:
                old = self._order.pop(0)
                evict.append(self._pages.pop(old))
        self.pool.incref(page)
        self.pool.mark_cached(page, chain)
        for p in evict:
            self.pool.uncache(p)
            self.pool.decref(p)

    def match(self, chains: List[str]) -> List[KVPage]:
        """Longest-prefix lookup: pages for every leading chain value
        held, each increffed for the borrowing sequence."""
        out: List[KVPage] = []
        with self._lock:
            for c in chains:
                p = self._pages.get(c)
                if p is None:
                    break
                out.append(p)
                # LRU touch
                self._order.remove(c)
                self._order.append(c)
        for p in out:
            self.pool.incref(p)
        return out

    def chains(self) -> List[str]:
        """Held chain values, LRU order (oldest first) — the replica's
        reported prefix digest caps from the newest end."""
        with self._lock:
            return list(self._order)

    def note_lookup(self, total_tokens: int, hit_tokens: int):
        with self._lock:
            self.lookup_tokens += int(total_tokens)
            self.hits_tokens += int(hit_tokens)

    def hit_rate(self) -> float:
        with self._lock:
            if self.lookup_tokens <= 0:
                return 0.0
            return self.hits_tokens / self.lookup_tokens

    def clear(self):
        with self._lock:
            pages = list(self._pages.values())
            self._pages.clear()
            self._order.clear()
        for p in pages:
            self.pool.uncache(p)
            self.pool.decref(p)
