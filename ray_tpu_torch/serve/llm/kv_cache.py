"""Arena-paged KV cache: fixed-size pages as slab-arena entries.

Port of ``ray_tpu/serve/llm/kv_cache.py``, both modes: arena pages leased
from the port's own raylet inside a cluster, heap pages without one.

A KV page is an ordinary object-plane entry with a different lifetime
policy. The pool owns a dedicated ``SlabWriter`` whose segments it
leases from the local raylet exactly like the worker's put path — but it
NEVER retires a lease while pages in the segment are alive, so every
page the replica holds lives in a segment still leased to this client:

- alloc: bump-reserve an entry range, write a real SEALED header for a
  ``KVPG``-prefixed oid, report it through the worker's batched slab
  report (store-ledger row + creation callsite => memview attribution),
  and pin the oid in this process's memview referenced set. The data
  region is handed back as a writable numpy view straight into the rw
  mapping — appends are memcpys into tmpfs, zero copies anywhere.
- free: one ``free_objects`` notify; the raylet marks the entry dead,
  its bytes join the segment's dead ranges and the PUNCH_HOLE sweep
  returns them to the kernel.
- replica killed (kill -9): the raylet's ``reclaim_client_slabs`` sees
  the ``KVPG`` oid prefix and sends the pages straight to dead ranges
  instead of adopting them — a dead replica's KV cache is cache, not
  data, and adopting it would read as a leak forever
  (object_store.reclaim_client_slabs).
- leaked (freed from engine bookkeeping without ``free``): the page
  stays resident in the store ledger with nobody referencing it — after
  LEAK_MIN_AGE_S the memview merge names it in a leak verdict with the
  allocating callsite, like any other object.

Pages mutate after seal, which the arena's "slab bytes are never
rewritten" rule forbids for shared objects — legal here because KVPG
oids are never published for readers (no shared-index insert, no
ray.get): the owning replica is the only process that ever maps them.

``KVPool`` falls back to plain heap pages when no worker/arena is
attached (unit tests, driver-side use), keeping the engine testable
without a cluster.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import memview, slab_arena

logger = logging.getLogger(__name__)

# oid namespace for KV pages: the store's death-reclaim keys on this
# prefix (cache entries die with their replica; they are never adopted)
KV_PAGE_OID_PREFIX = slab_arena.KV_PAGE_OID_PREFIX


def mint_page_oid() -> bytes:
    return KV_PAGE_OID_PREFIX + os.urandom(
        slab_arena.OID_SIZE - len(KV_PAGE_OID_PREFIX))


class KVPage:
    """One fixed-size KV page: ``data`` is a writable float32 view of
    shape (page_tokens, kv_dim) — in arena mode a zero-copy window into
    the slab segment's rw mapping."""

    __slots__ = ("oid", "seg_id", "off", "data", "used", "refs",
                 "chain", "cached")

    def __init__(self, oid: Optional[bytes], seg_id: Optional[int],
                 off: Optional[int], data: np.ndarray):
        self.oid = oid            # None in heap mode
        self.seg_id = seg_id
        self.off = off
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
    scheduler's KV-budget admission checks against. Arena-backed when the
    calling process has a connected worker with an arena store; heap
    otherwise."""

    def __init__(self, page_tokens: int, kv_dim: int, max_pages: int,
                 use_arena: bool = True):
        self.page_tokens = int(page_tokens)
        self.kv_dim = int(kv_dim)
        self.max_pages = int(max_pages)
        self.page_bytes = self.page_tokens * self.kv_dim * 4  # float32
        self._entry_total = slab_arena.entry_size(0, self.page_bytes)
        self._lock = threading.Lock()
        self._allocated = 0       # live pages (active + cached)
        self._cached = 0
        self._writer: Optional[slab_arena.SlabWriter] = None
        self._worker = None
        if use_arena:
            self._attach_arena()

    # -- arena attachment ----------------------------------------------
    def _attach_arena(self):
        """Adopt the connected worker's store dir + raylet connection.
        Quietly stays in heap mode when there is no cluster: the engine
        (and its unit tests) must not depend on one."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            cw = worker_mod.global_worker.core_worker
            if cw is None or not getattr(cw, "connected", False):
                return
            w = getattr(cw, "_slab_writer", None)
            if w is None:
                return
            self._worker = cw
            self._writer = slab_arena.SlabWriter(w.store_dir)
        except Exception:
            logger.debug("kv pool: arena unavailable, using heap pages",
                         exc_info=True)
            self._writer = None
            self._worker = None

    @property
    def arena_backed(self) -> bool:
        return self._writer is not None

    def _lease(self) -> bool:
        """Lease a fresh segment. NO seal of the previous one: pages in
        it are live, and keeping the lease is what keeps the segment off
        the spill/evict paths and inside ``reclaim_client_slabs``'s sweep
        when this process dies. Freed pages still reclaim through dead
        ranges; the segment itself retires when its last page dies and
        the pool (or its process) goes away."""
        cw, w = self._worker, self._writer
        size = max(self._entry_total * 8, 1 << 20)
        try:
            r = cw.io.run(
                cw.raylet.request("lease_slab", {"bytes": size, "seals": []}),
                timeout=30,
            )
        except Exception:
            return False
        if not r.get("ok"):
            return False
        w.attach(r["seg_id"], r["size"])
        return True

    # -- page lifecycle -------------------------------------------------
    def alloc(self, callsite: Optional[str] = None) -> Optional[KVPage]:
        """One page, or None when the budget is exhausted (the scheduler
        turns that into queueing / load shedding, never an error)."""
        with self._lock:
            if self._allocated >= self.max_pages:
                return None
            self._allocated += 1
        page = None
        try:
            if self._writer is not None:
                page = self._alloc_arena(callsite)
            if page is None:
                page = self._alloc_heap()
            return page
        finally:
            if page is None:
                with self._lock:
                    self._allocated -= 1

    def _alloc_heap(self) -> KVPage:
        return KVPage(None, None, None,
                      np.zeros((self.page_tokens, self.kv_dim),
                               dtype=np.float32))

    def _alloc_arena(self, callsite: Optional[str]) -> Optional[KVPage]:
        w = self._writer
        with w.lock:
            res = w.try_reserve(self._entry_total)
        if res is None:
            if not self._lease():
                # raylet denied (no arena / store full): heap fallback
                # keeps serving; the budget still bounds total bytes
                return None
            with w.lock:
                res = w.try_reserve(self._entry_total)
            if res is None:
                return None
        seg_id, off = res
        oid = mint_page_oid()
        with w.lock:
            mv = w._mv
            # real header first, state word last — same seal discipline
            # as write_entry, minus the payload (the engine appends it)
            hdr = slab_arena._pack_header(oid, 0, self.page_bytes)
            mv[off + 8: off + slab_arena.HDR] = hdr[: slab_arena.HDR - 8]
            mv[off: off + 8] = slab_arena.STATE_SEALED
            data_off = off + slab_arena.HDR
            view = np.frombuffer(mv, dtype=np.float32,
                                 count=self.page_tokens * self.kv_dim,
                                 offset=data_off
                                 ).reshape(self.page_tokens, self.kv_dim)
        view[:] = 0.0
        # batched accounting ride-along: ledger row + callsite for leak
        # attribution, exactly like a put (worker._queue_slab_report)
        ent = {"o": oid, "s": seg_id, "f": off, "n": self._entry_total}
        if callsite is None:
            callsite = memview.callsite_tag(2)
        if callsite:
            ent["c"] = callsite
        try:
            self._worker._queue_slab_report(ent)
        except Exception:
            pass
        # live pages are REFERENCED by this process: memview's merge must
        # not call them leaks while the replica is alive and using them
        memview.pin_external(oid)
        return KVPage(oid, seg_id, off, view)

    def incref(self, page: KVPage):
        with self._lock:
            page.refs += 1

    def decref(self, page: KVPage):
        """Drop one reference; the last one frees the page for real."""
        with self._lock:
            page.refs -= 1
            if page.refs > 0:
                return
            self._allocated -= 1
            if page.cached:
                self._cached -= 1
                page.cached = False
        self._free_storage(page)

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

    def _free_storage(self, page: KVPage):
        if page.oid is None:
            return
        memview.unpin_external(page.oid)
        cw = self._worker
        try:
            # fire-and-forget on the io loop: the raylet marks the entry
            # dead; its bytes join the dead-range/PUNCH_HOLE sweep
            cw.io.call_soon(
                cw.raylet.notify("free_objects", {"object_ids": [page.oid]}))
        except Exception:
            logger.debug("kv page free notify failed", exc_info=True)

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

    def readback(self, page: KVPage) -> np.ndarray:
        """An INDEPENDENT view of the page's data region, via a fresh
        read of the backing store — np.shares_memory(page.data, readback)
        is the zero-copy proof the bench/tests assert (heap mode returns
        the array itself: there is nothing else to share)."""
        if page.oid is None or self._writer is None:
            return page.data
        w = self._writer
        with w.lock:
            if w.seg_id == page.seg_id and w._mv is not None:
                return np.frombuffer(
                    w._mv, dtype=np.float32,
                    count=self.page_tokens * self.kv_dim,
                    offset=page.off + slab_arena.HDR,
                ).reshape(self.page_tokens, self.kv_dim)
        return page.data

    def close(self):
        """Graceful shutdown: retire the current lease so the raylet can
        credit the unused tail (crash shutdown needs nothing — death
        reclaim handles it)."""
        w = self._writer
        if w is None:
            return
        seal = w.take_seal()
        if seal is None:
            return
        cw = self._worker
        try:
            cw.io.call_soon(
                cw.raylet.request("lease_slab", {"bytes": 0, "seals": [seal]}))
        except Exception:
            pass


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
                try:
                    self._order.remove(c)
                    self._order.append(c)
                except ValueError:
                    pass
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
