"""Slab-arena primitives for the shared-memory object plane.

The reference's plasma store (ray: src/ray/object_manager/plasma/store.h)
is a pre-mapped shm *arena*: clients create/seal objects inside shared
segments and readers map nothing per object. This module is that layout
for ray_tpu_torch: a node's store directory holds

  <store_dir>/index.shm           shared-memory object index (hash table)
  <store_dir>/slabs/seg_<id>.slab pre-sized slab segments (sparse tmpfs)
  <store_dir>/<oid>.obj           legacy one-file objects (spill restores,
                                  cross-node interop, fallback writes)

Writers lease a slab from the raylet (one RPC amortized over many puts),
bump-allocate entries into their private rw mapping, and SEAL each entry
by writing its 8-byte state word last — an atomic header flip, so a
reader can never observe a half-written object as sealed and a writer
killed mid-put leaves a torn (state==0) tail that a rescan discards.
Readers resolve oid -> (segment, offset) through the shared index, map
the segment once per process, and return memoryviews straight into the
arena: no per-object open/flock/stat/mmap.

Entry layout (64-byte aligned, 80-byte header):

  [0:8)    state      b"RTPUSLB1" sealed | b"RTPUSLBX" dead | else torn
  [8:36)   object id  (28 bytes)
  [36:44)  meta_len   u64 LE
  [44:52)  data_len   u64 LE
  [52:60)  entry_total u64 LE (aligned size of header+meta+data)
  [60:64)  crc32 of [8:60)  (torn-header detection beyond the state word)
  [64:80)  reserved
  [80:...) metadata, then data

Index layout (64-byte header, 64-byte open-addressed slots):

  header:  [0:8) b"RTPUIDX1"  [8:16) slot_count u64
  slot:    [0:28) oid  [28:32) state u32 (0 empty, 1 sealed, 2 dead)
           [32:40) seg_id u64  [40:48) offset u64  [48:64) reserved

The index is a HINT, not ground truth: inserts from concurrent writer
processes may (rarely) collide on a slot and lose one entry, and slot
writes are not atomic. Readers therefore always validate the in-slab
entry header (state + oid + crc) before trusting a hit; a miss falls
back to the raylet's ledger over RPC. Torn index slots are harmless by
construction.

Safety rules (the documented live-view hazards):
- slab bytes are NEVER rewritten: allocation only bumps forward, delete
  flips the state word (data region untouched), reclamation unlinks the
  whole segment file — existing mappings keep their pages until the last
  view dies, so a live zero-copy view can never see recycled bytes.
- segments are sparse (ftruncate-sized): an 8MB slab with 1MB written
  costs ~1MB of tmpfs, so generous leases are cheap.
"""

from __future__ import annotations

import logging
import mmap
import os
import struct
import threading
import weakref
import zlib
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

logger = logging.getLogger(__name__)

OID_SIZE = 28
ALIGN = 64
HDR = 80
STATE_SEALED = b"RTPUSLB1"
STATE_DEAD = b"RTPUSLBX"

# oid namespace for serving-engine KV pages (serve/llm/kv_cache.py):
# entries in this namespace are CACHE, not data — the store's dead-
# writer reclaim sends them to dead ranges instead of adopting them,
# because no process can ever reference a dead replica's pages again
KV_PAGE_OID_PREFIX = b"KVPG"

IDX_MAGIC = b"RTPUIDX1"
IDX_HDR = 64
IDX_SLOT = 64
IDX_PROBE_LIMIT = 128
SLOT_EMPTY, SLOT_SEALED, SLOT_DEAD = 0, 1, 2

INDEX_FILE = "index.shm"
SLAB_DIR = "slabs"


def align_up(n: int) -> int:
    return (n + ALIGN - 1) & ~(ALIGN - 1)


def entry_size(meta_len: int, data_len: int) -> int:
    return align_up(HDR + meta_len + data_len)


def index_path(store_dir: str) -> str:
    return os.path.join(store_dir, INDEX_FILE)


def segment_path(store_dir: str, seg_id: int) -> str:
    return os.path.join(store_dir, SLAB_DIR, f"seg_{seg_id:08d}.slab")


def segment_id_of(path: str) -> Optional[int]:
    name = os.path.basename(path)
    if not (name.startswith("seg_") and name.endswith(".slab")):
        return None
    try:
        return int(name[4:-5])
    except ValueError:
        return None


def create_segment(store_dir: str, seg_id: int, size: int) -> str:
    """Create a sparse, pre-sized slab segment (owner side)."""
    path = segment_path(store_dir, seg_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        os.ftruncate(fd, size)
    finally:
        os.close(fd)
    return path


# ----------------------------------------------------------------------
# entry read/write
# ----------------------------------------------------------------------

def _pack_header(oid: bytes, meta_len: int, data_len: int) -> bytes:
    body = oid + struct.pack("<QQQ", meta_len, data_len,
                             entry_size(meta_len, data_len))
    return body + struct.pack("<I", zlib.crc32(body)) + b"\0" * (HDR - 64)


# payload buffers at least this big are written with pwrite instead of a
# memoryview copy into the mapping: a file write fills tmpfs page cache
# in the kernel (no per-page minor fault, no pre-zero of fresh pages),
# measurably faster for bulk objects; mmap and pwrite hit the same pages
# on tmpfs, so readers see one coherent image either way
PWRITE_MIN = 256 * 1024


def pwrite_all(fd: int, buf, pos: int):
    """pwrite to completion: a single pwrite caps at ~2GiB on Linux and
    partial writes are legal — the one authoritative loop for every
    slab write path (bulk put payloads, receive-side chunk landings)."""
    if not isinstance(buf, memoryview):
        buf = memoryview(buf)
    if buf.ndim != 1 or buf.format != "B":
        buf = buf.cast("B")
    n = buf.nbytes
    written = 0
    while written < n:
        written += os.pwrite(fd, buf[written:], pos + written)


def write_entry(mv: memoryview, off: int, oid: bytes, metadata: bytes,
                buffers: Iterable, fd: Optional[int] = None) -> int:
    """Write one entry into a writable segment view and SEAL it (state
    word written last). Returns the aligned entry size."""
    meta_len = len(metadata)
    pos = off + HDR
    if meta_len:
        mv[pos : pos + meta_len] = metadata
        pos += meta_len
    data_len = 0
    for buf in buffers:
        if not isinstance(buf, (bytes, bytearray, memoryview)):
            buf = memoryview(buf)
        if isinstance(buf, memoryview) and (buf.ndim != 1 or buf.format != "B"):
            buf = buf.cast("B")
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        if fd is not None and n >= PWRITE_MIN:
            # without the completion loop the entry seals with data_len
            # covering a zero-filled tail
            pwrite_all(fd, buf, pos)
        else:
            mv[pos : pos + n] = buf
        pos += n
        data_len += n
    total = entry_size(meta_len, data_len)
    # real header now that data_len is known; state word LAST = the seal
    hdr = _pack_header(oid, meta_len, data_len)
    mv[off + 8 : off + HDR] = hdr[: HDR - 8]
    mv[off : off + 8] = STATE_SEALED
    return total


def _parse_header(raw: bytes) -> Optional[Tuple[bytes, int, int, int]]:
    """(oid, meta_len, data_len, entry_total) from header bytes [8:64),
    or None if the crc doesn't hold (torn header)."""
    body, crc = raw[:52], struct.unpack_from("<I", raw, 52)[0]
    if zlib.crc32(body) != crc:
        return None
    oid = body[:OID_SIZE]
    meta_len, data_len, total = struct.unpack_from("<QQQ", body, OID_SIZE)
    if total != entry_size(meta_len, data_len):
        return None
    return oid, meta_len, data_len, total


def read_entry_at(mm, off: int, size: int, oid: Optional[bytes] = None,
                  ) -> Optional[Tuple[bytes, memoryview, int]]:
    """Validate + read a sealed entry: (metadata, data_view, entry_total).
    None if the entry is not sealed, torn, out of bounds, or (when given)
    belongs to a different oid."""
    if off < 0 or off + HDR > size:
        return None
    if bytes(mm[off : off + 8]) != STATE_SEALED:
        return None
    parsed = _parse_header(bytes(mm[off + 8 : off + 64]))
    if parsed is None:
        return None
    eoid, meta_len, data_len, total = parsed
    if oid is not None and eoid != oid:
        return None
    if off + total > size:
        return None
    metadata = bytes(mm[off + HDR : off + HDR + meta_len])
    data = memoryview(mm)[off + HDR + meta_len : off + HDR + meta_len + data_len]
    return metadata, data, total


def entry_state_at(mm, off: int, size: int, oid: Optional[bytes] = None) -> Optional[bytes]:
    """STATE_SEALED / STATE_DEAD for a valid entry (of ``oid`` when given),
    None for anything torn/out-of-bounds."""
    if off < 0 or off + HDR > size:
        return None
    state = bytes(mm[off : off + 8])
    if state not in (STATE_SEALED, STATE_DEAD):
        return None
    parsed = _parse_header(bytes(mm[off + 8 : off + 64]))
    if parsed is None:
        return None
    if oid is not None and parsed[0] != oid:
        return None
    return state


def scan_segment(path: str):
    """Yield (oid, off, meta_len, data_len, entry_total, dead) for every
    valid entry of a segment, stopping at the first torn/free entry —
    allocation is strictly bump-forward, so nothing valid can follow a
    torn entry (a writer killed mid-put leaves exactly one torn tail)."""
    try:
        size = os.path.getsize(path)
        if size < HDR:
            return
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, ValueError):
        return
    try:
        off = 0
        while off + HDR <= size:
            state = bytes(mm[off : off + 8])
            if state not in (STATE_SEALED, STATE_DEAD):
                return
            parsed = _parse_header(bytes(mm[off + 8 : off + 64]))
            if parsed is None:
                return
            oid, meta_len, data_len, total = parsed
            if off + total > size:
                return
            yield oid, off, meta_len, data_len, total, state == STATE_DEAD
            off += total
    finally:
        try:
            mm.close()
        except BufferError:
            pass


# ----------------------------------------------------------------------
# hole-punch reclamation (fallocate PUNCH_HOLE|KEEP_SIZE)
# ----------------------------------------------------------------------

PAGE = mmap.PAGESIZE
FALLOC_FL_KEEP_SIZE = 0x01
FALLOC_FL_PUNCH_HOLE = 0x02

_libc = None
_punch_broken = False  # sticky: first EOPNOTSUPP/ENOSYS disables the pass


def punch_span(off: int, length: int, page: int = PAGE
               ) -> Optional[Tuple[int, int]]:
    """The page-aligned interior of a dead range ``[off, off+length)``
    that can be hole-punched while PRESERVING the entry header at
    ``off`` — scans must still traverse the range via its (tombstone)
    header, so the first HDR bytes never go inside the hole. Returns
    ``(start, nbytes)`` or None when no whole page fits."""
    start = (off + HDR + page - 1) // page * page
    end = (off + length) // page * page
    if end <= start:
        return None
    return start, end - start


def punch_range(fd: int, start: int, nbytes: int) -> bool:
    """fallocate(PUNCH_HOLE | KEEP_SIZE) one range: the file size and
    every existing mapping stay intact (readers keep valid views — the
    punched pages read back as zeros), the backing tmpfs pages are
    freed. Returns False (sticky, process-wide) where unsupported."""
    global _libc, _punch_broken
    if _punch_broken or nbytes <= 0:
        return False
    try:
        import ctypes

        if _libc is None:
            lib = ctypes.CDLL(None, use_errno=True)
            lib.fallocate.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_longlong]
            lib.fallocate.restype = ctypes.c_int
            _libc = lib
        if _libc.fallocate(
            fd, FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE, start, nbytes
        ) != 0:
            import errno

            if ctypes.get_errno() in (errno.EOPNOTSUPP, errno.ENOSYS):
                _punch_broken = True
            return False
        return True
    except (OSError, AttributeError, TypeError):
        _punch_broken = True
        return False


def write_dead_tombstone(fd: int, off: int, total: int) -> bool:
    """Overwrite the entry header at ``off`` with a DEAD header whose
    entry_total covers the whole ``total``-byte (coalesced, entry-
    aligned) range, so a scan hops the punched range in ONE step —
    interior entries' headers are about to be zeroed by the punch, and
    without the covering tombstone the scan would stop at the first
    zeroed state word and strand every sealed entry behind it."""
    if total < align_up(HDR):
        return False
    hdr = _pack_header(b"\0" * OID_SIZE, 0, total - HDR)
    try:
        os.pwrite(fd, hdr[: HDR - 8], off + 8)
        os.pwrite(fd, STATE_DEAD, off)
        return True
    except OSError:
        return False


def mark_dead_at(store_dir: str, seg_id: int, off: int) -> bool:
    """Flip one entry's state word to DEAD via pwrite. The data region is
    untouched, so live zero-copy views of the entry stay intact; new
    resolves see DEAD and miss."""
    try:
        fd = os.open(segment_path(store_dir, seg_id), os.O_WRONLY)
    except OSError:
        return False
    try:
        os.pwrite(fd, STATE_DEAD, off)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def wipe_entry_states(path: str):
    """Zero every entry's state word so a recycled segment scans as
    empty (a stale sealed header at exactly the new writer's bump offset
    would otherwise resurrect a dead object on rescan). Only called on
    all-dead segments that no process can map (exclusive-flock proof)."""
    offs = [e[1] for e in scan_segment(path)]
    if not offs:
        return
    fd = os.open(path, os.O_WRONLY)
    try:
        for off in offs:
            os.pwrite(fd, b"\0" * 8, off)
    finally:
        os.close(fd)


# ----------------------------------------------------------------------
# shared-memory index
# ----------------------------------------------------------------------

class SharedIndex:
    """Open-addressed oid -> (seg, off) table in a shared mmap.

    Concurrency model: writers insert without locks (one slot claim can
    rarely be lost to a racing writer); readers validate every hit
    against the in-slab header, so a torn or stale slot degrades to a
    miss, never a wrong object."""

    def __init__(self, path: str, slots: int = 1 << 16, create: bool = False):
        self.path = path
        existing = os.path.exists(path)
        if not existing and not create:
            raise FileNotFoundError(path)
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if os.fstat(fd).st_size < IDX_HDR + IDX_SLOT:
                os.ftruncate(fd, IDX_HDR + slots * IDX_SLOT)
                os.pwrite(fd, IDX_MAGIC + struct.pack("<Q", slots), 0)
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        if bytes(self._mm[:8]) != IDX_MAGIC:
            raise IOError(f"corrupt arena index {path}")
        self.slots = struct.unpack_from("<Q", self._mm, 8)[0]
        if IDX_HDR + self.slots * IDX_SLOT > len(self._mm):
            raise IOError(f"truncated arena index {path}")

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            pass

    def _slot_off(self, i: int) -> int:
        return IDX_HDR + (i % self.slots) * IDX_SLOT

    def _probe(self, oid: bytes):
        # hash ALL the id bytes: sibling objects (one task's returns, a
        # driver's puts) share a 24-byte task-id prefix, so a prefix-only
        # probe start would pile every sibling into one 128-slot window
        # and strand the 129th
        start = zlib.crc32(oid)
        for k in range(min(IDX_PROBE_LIMIT, self.slots)):
            yield self._slot_off(start + k)

    def lookup(self, oid: bytes) -> Optional[Tuple[int, int]]:
        mm = self._mm
        for so in self._probe(oid):
            raw = bytes(mm[so : so + 48])
            state = struct.unpack_from("<I", raw, OID_SIZE)[0]
            if state == SLOT_EMPTY:
                return None
            if state == SLOT_SEALED and raw[:OID_SIZE] == oid:
                seg, off = struct.unpack_from("<QQ", raw, 32)
                return seg, off
        return None

    def insert(self, oid: bytes, seg_id: int, off: int) -> bool:
        mm = self._mm
        tomb = None
        target = None
        for so in self._probe(oid):
            raw = bytes(mm[so : so + 32])
            state = struct.unpack_from("<I", raw, OID_SIZE)[0]
            if raw[:OID_SIZE] == oid and state != SLOT_EMPTY:
                target = so  # re-put / restore of a known oid: update in place
                break
            if state == SLOT_EMPTY:
                target = so
                break
            if state == SLOT_DEAD and tomb is None:
                tomb = so
        if target is None:
            target = tomb
        if target is None:
            return False  # probe window full: reader falls back to RPC
        # fields first, state last (readers validate against the slab
        # anyway, so a torn claim is a miss, not a lie)
        mm[target : target + OID_SIZE] = oid
        struct.pack_into("<QQ", mm, target + 32, seg_id, off)
        struct.pack_into("<I", mm, target + OID_SIZE, SLOT_SEALED)
        return True

    def mark_dead(self, oid: bytes):
        mm = self._mm
        for so in self._probe(oid):
            raw = bytes(mm[so : so + 32])
            state = struct.unpack_from("<I", raw, OID_SIZE)[0]
            if state == SLOT_EMPTY:
                return
            if state == SLOT_SEALED and raw[:OID_SIZE] == oid:
                struct.pack_into("<I", mm, so + OID_SIZE, SLOT_DEAD)
                return


# ----------------------------------------------------------------------
# per-process arena view (reader cache)
# ----------------------------------------------------------------------

class _ArenaView:
    """One process's lens onto a store's arena: the shared index plus a
    bounded cache of read-only segment mappings ('readers pin segments':
    a cached mapping keeps the pages alive even after the owner unlinks
    the segment file)."""

    # a cached mapping (and its reader flock) unused this long is closed
    # on the next cache access: a long-lived driver that once read from
    # a segment must not pin it against hole-punch reclamation forever —
    # live exported views still protect their mapping (BufferError)
    IDLE_CLOSE_S = 15.0

    def __init__(self, store_dir: str, cache_segments: int = 64):
        self.store_dir = store_dir
        self.lock = threading.Lock()
        self.index: Optional[SharedIndex] = None
        # seg_id -> (mm, size, file, [last_used_monotonic])
        self.segs: "OrderedDict[int, tuple]" = OrderedDict()
        self.cache_segments = cache_segments
        self._index_miss_until = 0.0
        self._idle_sweep_at = 0.0

    def _index(self) -> Optional[SharedIndex]:
        if self.index is not None:
            return self.index
        # negative-cache the missing index (legacy stores never grow
        # one): without this, every read in a non-arena store pays a
        # stat + exception on the hot path. Arena stores create the
        # index before any client learns the store_dir, so the TTL only
        # ever delays legacy dirs.
        import time as _time

        now = _time.monotonic()
        if now < self._index_miss_until:
            return None
        try:
            self.index = SharedIndex(index_path(self.store_dir))
        except (OSError, IOError):
            self._index_miss_until = now + 1.0
            return None
        return self.index

    def segment(self, seg_id: int) -> Optional[Tuple[mmap.mmap, int]]:
        import time as _time

        now = _time.monotonic()
        with self.lock:
            if now - self._idle_sweep_at > self.IDLE_CLOSE_S / 3:
                self._idle_sweep_at = now
                self._sweep_idle_locked(now)
            ent = self.segs.get(seg_id)
            if ent is not None:
                ent[3][0] = now
                self.segs.move_to_end(seg_id)
                return ent[0], ent[1]
        path = segment_path(self.store_dir, seg_id)
        try:
            f = open(path, "rb")
        except OSError:
            return None
        try:
            # segment-granularity SHARED flock ("readers pin segments"):
            # held for the cache entry's lifetime, it lets the owner's
            # recycling pool prove no process can see a segment before
            # rewriting it (EXCLUSIVE non-blocking test) — per-object
            # reads stay flock-free
            import fcntl

            fcntl.flock(f.fileno(), fcntl.LOCK_SH)
            size = os.fstat(f.fileno()).st_size
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            f.close()
            return None
        # the flock fd must outlive every exported view of the mapping
        # (a recycled-while-viewed segment would be a torn read)
        weakref.finalize(mm, f.close)
        import time as _time

        ent = (mm, size, f, [_time.monotonic()])
        with self.lock:
            won = self.segs.setdefault(seg_id, ent)
            if won is not ent:
                self._close_entry(ent)
                return won[0], won[1]
            self._sweep_locked()
            while len(self.segs) > self.cache_segments:
                _, old = self.segs.popitem(last=False)
                self._close_entry(old)
        return mm, size

    @staticmethod
    def _close_entry(ent):
        mm, _sz, f = ent[:3]
        try:
            mm.close()
        except BufferError:
            return  # views alive: the finalize closes f when they die
        f.close()

    def _sweep_idle_locked(self, now: float):
        """Close cached mappings unused for IDLE_CLOSE_S whose views are
        all gone — the reader flock goes with the mapping, releasing the
        segment for the owner's hole-punch / recycle passes. Read paths
        retry once on a concurrently-swept mapping (ValueError), so a
        sweep can never turn a live object into a miss."""
        for sid in list(self.segs.keys()):
            ent = self.segs[sid]
            if now - ent[3][0] < self.IDLE_CLOSE_S:
                continue
            try:
                ent[0].close()
            except BufferError:
                continue  # exported views keep it (and its flock) alive
            ent[2].close()
            del self.segs[sid]

    def _sweep_locked(self):
        """Drop cached mappings of segments the owner has unlinked or
        pooled — without this, the reader cache would pin every
        reclaimed segment's pages (and its recycle-blocking flock) until
        LRU churn got around to it. A mapping with live exported views
        refuses to close (BufferError) and is kept: the pages stay valid
        exactly as long as someone can still see them."""
        for sid in list(self.segs.keys()):
            if os.path.exists(segment_path(self.store_dir, sid)):
                continue
            ent = self.segs[sid]
            try:
                ent[0].close()
            except BufferError:
                continue
            ent[2].close()
            del self.segs[sid]

    def sweep(self):
        with self.lock:
            self._sweep_locked()

    def drop_segment(self, seg_id: int) -> bool:
        """Release OUR cached mapping of one segment (and its SHARED
        flock) so the owner's hole-punch pass can prove no process views
        it. Returns False when exported zero-copy views keep the mapping
        alive — the punch pass then skips the segment."""
        with self.lock:
            ent = self.segs.get(seg_id)
            if ent is None:
                return True
            try:
                ent[0].close()
            except BufferError:
                return False  # live exported views: segment stays pinned
            ent[2].close()
            del self.segs[seg_id]
            return True

    def resolve(self, oid: bytes) -> Optional[Tuple[int, int, mmap.mmap, int]]:
        idx = self._index()
        if idx is None:
            return None
        hit = idx.lookup(oid)
        if hit is None:
            return None
        seg_id, off = hit
        ent = self.segment(seg_id)
        if ent is None:
            return None
        mm, size = ent
        return seg_id, off, mm, size


_views: Dict[str, _ArenaView] = {}
_views_lock = threading.Lock()


def view(store_dir: str) -> _ArenaView:
    v = _views.get(store_dir)
    if v is None:
        with _views_lock:
            v = _views.setdefault(store_dir, _ArenaView(store_dir))
    return v


def drop_view(store_dir: str):
    """Release one store's per-process arena state (disconnect/shutdown):
    cached segment mappings, their flock fds, and the index mapping —
    otherwise a long-lived process cycling init()/shutdown() pins every
    dead session's tmpfs pages until exit. Mappings with live exported
    views survive (BufferError) and close when the views die."""
    with _views_lock:
        v = _views.pop(store_dir, None)
    if v is None:
        return
    with v.lock:
        for ent in v.segs.values():
            v._close_entry(ent)
        v.segs.clear()
        if v.index is not None:
            v.index.close()
            v.index = None


def read(store_dir: str, oid: bytes
         ) -> Optional[Tuple[bytes, memoryview, int]]:
    """(metadata, zero-copy data view, seg_id) via the shared index, or
    None. Flock-free: validation is the in-slab sealed header."""
    for _ in range(2):
        r = view(store_dir).resolve(oid)
        if r is None:
            return None
        seg_id, off, mm, size = r
        try:
            got = read_entry_at(mm, off, size, oid=oid)
        except ValueError:
            # cache race: a concurrent sweep (idle-close, LRU) closed
            # this viewless mapping between resolve and the slice —
            # resolve again (it re-opens), never report a live object
            # as a miss off a swept mapping
            continue
        if got is None:
            return None
        metadata, data, _total = got
        return metadata, data, seg_id
    return None


def read_at(store_dir: str, seg_id: int, off: int, oid: bytes
            ) -> Optional[Tuple[bytes, memoryview]]:
    """Ledger-directed read (owner side / RPC-resolved): skip the index."""
    for _ in range(2):
        ent = view(store_dir).segment(seg_id)
        if ent is None:
            return None
        mm, size = ent
        try:
            got = read_entry_at(mm, off, size, oid=oid)
        except ValueError:
            continue  # swept under us: re-open and retry once
        if got is None:
            return None
        return got[0], got[1]
    return None


def exists(store_dir: str, oid: bytes) -> bool:
    for _ in range(2):
        r = view(store_dir).resolve(oid)
        if r is None:
            return False
        seg_id, off, mm, size = r
        try:
            return entry_state_at(mm, off, size, oid=oid) == STATE_SEALED
        except ValueError:
            continue  # swept under us: re-open and retry once
    return False


def state_at(store_dir: str, seg_id: int, off: int, oid: bytes) -> Optional[bytes]:
    for _ in range(2):
        ent = view(store_dir).segment(seg_id)
        if ent is None:
            return None
        mm, size = ent
        try:
            return entry_state_at(mm, off, size, oid=oid)
        except ValueError:
            continue  # swept under us: re-open and retry once
    return None


def discard(store_dir: str, oid: bytes) -> bool:
    """Mark a slab object dead from ANY process (test/chaos surface — the
    arena analog of unlinking an .obj file)."""
    v = view(store_dir)
    r = v.resolve(oid)
    if r is None:
        return False
    seg_id, off, mm, size = r
    try:
        if entry_state_at(mm, off, size, oid=oid) != STATE_SEALED:
            return False
    except ValueError:
        return False  # mapping closed by a concurrent sweep
    if not mark_dead_at(store_dir, seg_id, off):
        return False
    idx = v._index()
    if idx is not None:
        idx.mark_dead(oid)
    return True


# ----------------------------------------------------------------------
# writer side
# ----------------------------------------------------------------------

class SlabWriter:
    """Bump allocator over the current leased slab of one process.

    ``try_put`` is the whole fast path: reserve a range, memcpy the
    buffers, seal with the state-word flip, publish in the shared index.
    It never blocks on the raylet — when the slab is out of room it
    returns None and the caller runs the lease protocol (``attach`` a
    fresh segment granted by the owner, sealing the old one)."""

    def __init__(self, store_dir: str):
        self.store_dir = store_dir
        self.lock = threading.RLock()
        self.seg_id: Optional[int] = None
        self._mm: Optional[mmap.mmap] = None
        self._mv: Optional[memoryview] = None
        self._fd: Optional[int] = None  # bulk payloads go through pwrite
        self._off = 0
        self._size = 0
        self._last_lease = 0

    def attach(self, seg_id: int, size: int):
        """Adopt a freshly leased segment (file already created+sized by
        the owner)."""
        with self.lock:
            self._detach_locked()
            fd = os.open(segment_path(self.store_dir, seg_id), os.O_RDWR)
            try:
                # writers hold the SHARED flock too: the recycling pool's
                # exclusive probe must also see a zombie writer (live
                # process whose raylet connection dropped and whose slab
                # was reclaimed) — without this its rw mapping could
                # bump-write over a re-leased segment
                import fcntl

                fcntl.flock(fd, fcntl.LOCK_SH)
                self._mm = mmap.mmap(fd, size)
            except (OSError, ValueError):
                os.close(fd)
                raise
            self._fd = fd
            self._mv = memoryview(self._mm)
            self.seg_id = seg_id
            self._off = 0
            self._size = size
            self._last_lease = size

    def _detach_locked(self):
        if self._mm is None:
            return
        try:
            self._mv.release()
        except BufferError:
            pass
        try:
            self._mm.close()
        except BufferError:
            pass  # the mapping dies with its last exported view
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        self._mm = None
        self._mv = None
        self.seg_id = None

    def close(self):
        with self.lock:
            self._detach_locked()

    def take_seal(self) -> Optional[dict]:
        """Detach the current slab and return its seal record (rides the
        next lease RPC so the owner can credit the unused tail)."""
        with self.lock:
            if self.seg_id is None:
                return None
            seal = {"seg_id": self.seg_id, "used": self._off}
            self._detach_locked()
            return seal

    def remaining(self) -> int:
        with self.lock:
            return self._size - self._off if self._mm is not None else 0

    def lease_size_for(self, entry_total: int, slab_default: int,
                       slab_min: int) -> int:
        """Adaptive slab sizing: start small, double per lease up to the
        default, always covering the triggering entry. Segments are
        sparse, so the cost of a generous lease is accounting, not
        memory."""
        nxt = min(slab_default, max(slab_min, self._last_lease * 2))
        return max(entry_total, nxt)

    def try_reserve(self, entry_total: int) -> Optional[Tuple[int, int]]:
        """Bump-allocate one entry range WITHOUT writing it: the caller
        (receive-side slab assembly) pwrites chunk payloads straight into
        the segment file at their offsets and seals with the same
        state-word flip ``write_entry`` uses. Until that seal the entry
        reads as torn — a receiver killed mid-transfer leaves exactly
        the tail a crash rescan already discards. Returns
        ``(seg_id, off)`` or None when the current slab can't fit it."""
        with self.lock:
            if self._mm is None or self._off + entry_total > self._size:
                return None
            off = self._off
            self._off += entry_total
            # recycled pooled segments are only state-wiped at their OLD
            # entry offsets: scrub our new entry's state word so a stale
            # sealed magic can never make the in-progress entry scannable
            self._mv[off : off + 8] = b"\0" * 8
            return self.seg_id, off

    def try_put(self, oid: bytes, metadata: bytes, buffers,
                total_data_len: int) -> Optional[dict]:
        """Write+seal+index one object; returns the accounting report
        entry, or None when the current slab can't fit it."""
        total = entry_size(len(metadata), total_data_len)
        with self.lock:
            if self._mm is None or self._off + total > self._size:
                return None
            off = self._off
            self._off += total
            write_entry(self._mv, off, oid, metadata, buffers, fd=self._fd)
            seg_id = self.seg_id
        idx = view(self.store_dir)._index()
        if idx is not None:
            idx.insert(oid, seg_id, off)
        return {"o": oid, "s": seg_id, "f": off, "n": total}
