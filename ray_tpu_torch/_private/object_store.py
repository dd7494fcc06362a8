"""Shared-memory local object store (plasma analog).

The reference's plasma store (ray: src/ray/object_manager/plasma/store.h) is a
shm arena with create/seal/get/release and LRU eviction; workers map segments
read-only for zero-copy reads. The data plane here has two formats:

- **Slab arena** (default; slab_arena.py): workers lease pre-sized slab
  segments from their raylet, bump-allocate objects into the mmap'd
  segment and seal with an atomic header flip; readers resolve
  ``oid -> (segment, offset)`` through a shared-memory index and return
  memoryviews straight into the arena. No per-object file, no flock, no
  per-object syscalls on either side. Accounting is batched: the raylet
  charges capacity at slab granularity and workers self-report sealed
  entries asynchronously.
- **One file per object** (legacy + interop): ``<id>.obj`` files with
  ``[8B magic][8B metadata_len][8B data_len][metadata][data]``. Still the
  format for spill/restore and any process without a lease, so mixed
  clusters and external backends keep working; ``RAY_TPU_TORCH_slab_arena=0``
  makes it the only data path again (including the native C++ writer).

Accounting (capacity, pinning, eviction/spill) is done by the raylet
process that owns the store directory; readers in other processes only
mmap. Lifetime is segment-granular in the arena: delete flips the entry
state word (live views keep their pages), and a segment file is unlinked
only when nothing live remains in it.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from ray_tpu_torch._private import memview, slab_arena
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import ObjectID

_MAGIC = b"RTPUOBJ1"
_HEADER = 24

# negative-cache bound for external-backend probes (see _probe_missed)
_PROBE_MISSED_MAX = 100_000

# --- runtime metrics (metrics_core.py) ---------------------------------
# Built lazily; read_object/write_object run in every process (workers
# write returns directly, raylets serve pulls), so each process's
# registry sees its own share and the cluster scrape merges them.
_MX = None


class _StoreMetrics:
    __slots__ = ("put_lat", "put_bytes", "get_lat", "get_bytes",
                 "ext_hits", "ext_misses", "spills", "restores",
                 "slab_puts", "file_puts", "overshoot", "overshoot_cause",
                 "rx_assemblies", "punches", "punched_bytes")

    def __init__(self):
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        self.put_lat = reg.histogram(
            "object_store_put_latency_seconds",
            "Object create+seal latency", scale=mc.LATENCY).default
        self.put_bytes = reg.histogram(
            "object_store_put_bytes", "Object sizes written",
            scale=mc.SIZE).default
        self.get_lat = reg.histogram(
            "object_store_get_latency_seconds",
            "Object open+mmap latency", scale=mc.LATENCY).default
        self.get_bytes = reg.histogram(
            "object_store_get_bytes", "Object sizes mapped",
            scale=mc.SIZE).default
        self.ext_hits = reg.counter(
            "object_store_external_probe_hits_total",
            "External spill-backend existence probes that hit").default
        self.ext_misses = reg.counter(
            "object_store_external_probe_misses_total",
            "External spill-backend existence probes that missed").default
        self.spills = reg.counter(
            "object_store_spills_total", "Objects spilled out of shm").default
        self.restores = reg.counter(
            "object_store_restores_total",
            "Objects restored from the spill backend").default
        self.slab_puts = reg.counter(
            "object_store_slab_puts_total",
            "Objects sealed into leased slab segments").default
        self.file_puts = reg.counter(
            "object_store_file_puts_total",
            "Objects written as one-file .obj (fallback/interop)").default
        self.overshoot = reg.counter(
            "object_store_overshoot_bytes_total",
            "Bytes admitted past capacity (already-written externals "
            "and untracked restores)").default
        # cause-labeled twin of the total above: pressure verdicts name
        # register_external (fallback writes) vs untracked_restore
        # instead of pointing at a raw counter
        self.overshoot_cause = reg.counter(
            "object_store_overshoot_attributed_bytes_total",
            "Bytes admitted past capacity, by cause")
        # arena-to-arena transfer plane: cross-node receives assembled
        # straight into reserved slab entries (vs heap chunk buffers),
        # and hole-punch reclamation of dead ranges in live segments
        self.rx_assemblies = reg.counter(
            "object_store_slab_rx_assemblies_total",
            "Cross-node receives assembled directly into slab "
            "entries").default
        self.punches = reg.counter(
            "slab_punches_total",
            "Hole-punched dead ranges in live slab segments").default
        self.punched_bytes = reg.counter(
            "slab_punched_bytes_total",
            "Bytes hole-punched (physical pages returned) from dead "
            "ranges in live slab segments").default


def _mx() -> "_StoreMetrics":
    global _MX
    if _MX is None:
        _MX = _StoreMetrics()
    return _MX


class ObjectStoreFullError(Exception):
    pass


@dataclass
class ObjectBuffer:
    """A sealed object mapped into this process (zero-copy views).

    File-backed buffers own their mapping (+flock fd); slab-backed
    buffers alias the process's shared segment mapping and own nothing —
    ``release`` is then a no-op and ``seg_id`` names the segment."""

    object_id: ObjectID
    metadata: bytes
    data: memoryview
    _mmap: mmap.mmap = None
    _file: object = None
    seg_id: Optional[int] = None

    def release(self):
        if self._mmap is not None:
            try:
                self.data.release()
            except BufferError:
                pass
            try:
                self._mmap.close()
            except BufferError:
                # zero-copy slices of the data are still exported (e.g. a
                # chunk view queued on an rpc frame): the mapping closes
                # when the last view dies, and the weakref.finalize
                # attached at read time closes the flock fd with it
                self._mmap = None
                return
            if self._file is not None:
                self._file.close()  # finalize's second close is a no-op
            self._mmap = None


class SlabReservation:
    """One in-flight slab entry a cross-node transfer assembles into
    (receive-side slab assembly). The FULL entry header (real oid and
    lengths, known up front) is written at reserve time with state
    DEAD, so segment scans traverse an in-flight — or crashed —
    assembly like any dead entry and every entry sealed BEHIND it stays
    rescan-adoptable; chunks then pwrite straight into the segment file
    at their offsets (out-of-order safe, no heap staging), and
    ``seal()`` is a single atomic state-word flip DEAD→SEALED once
    every byte has arrived. An abandoned reservation simply stays DEAD
    (accounted as reclaimable dead bytes for the punch pass)."""

    __slots__ = ("_store", "object_id", "seg_id", "off", "meta_len",
                 "total_data_len", "entry_total", "_fd", "_done")

    def __init__(self, store, object_id: ObjectID, seg_id: int, off: int,
                 meta_len: int, total_data_len: int):
        self._store = store
        self.object_id = object_id
        self.seg_id = seg_id
        self.off = off
        self.meta_len = meta_len
        self.total_data_len = total_data_len
        self.entry_total = slab_arena.entry_size(meta_len, total_data_len)
        self._fd: Optional[int] = None
        self._done = False

    def write(self, data_off: int, buf) -> int:
        """Land one chunk at its data offset. Returns bytes written."""
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        if data_off < 0 or data_off + n > self.total_data_len:
            raise ValueError(
                f"chunk [{data_off}, {data_off + n}) outside reserved "
                f"data region of {self.total_data_len} bytes"
            )
        slab_arena.pwrite_all(
            self._fd, buf,
            self.off + slab_arena.HDR + self.meta_len + data_off)
        return n

    def seal(self) -> bool:
        """All bytes arrived: flip the state word DEAD→SEALED (the
        header body was written at reserve time), then ledger adoption
        + shared-index publish."""
        if self._done or self._fd is None:
            return False
        self._done = True
        try:
            os.pwrite(self._fd, slab_arena.STATE_SEALED, self.off)
        except OSError:
            self._done = False
            self.abandon()
            return False
        ok = self._store._commit_reservation(self)
        self._close()
        return ok

    def abandon(self):
        """Transfer failed/expired: the entry header already reads DEAD
        (written at reserve time) — account the range as reclaimable
        dead bytes. Idempotent."""
        if self._done:
            return
        self._done = True
        self._store._abandon_reservation(self)
        self._close()

    def _close(self):
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


def _obj_path(store_dir: str, object_id: ObjectID) -> str:
    return os.path.join(store_dir, object_id.hex() + ".obj")


def read_object(store_dir: str, object_id: ObjectID) -> Optional[ObjectBuffer]:
    """Resolve + map a sealed object. Returns None if absent. Any process.

    Arena first: a shared-index hit validates the in-slab sealed header
    and returns views into the process's cached segment mapping —
    flock-free, no per-object syscalls. Legacy ``.obj`` files (spill
    restores, fallback writes, native-store output) keep the original
    open+flock path: readers hold a SHARED flock for the buffer's
    lifetime because the native free path's page-recycling pool takes a
    non-blocking EXCLUSIVE flock before rewriting pages; slab segments
    are never rewritten, which is why the arena path needs no lock."""
    t0 = time.perf_counter()
    hit = slab_arena.read(store_dir, object_id.binary())
    if hit is not None:
        metadata, data, seg_id = hit
        mx = _mx()
        mx.get_lat.record(time.perf_counter() - t0)
        mx.get_bytes.record(data.nbytes)
        return ObjectBuffer(object_id, metadata, data, seg_id=seg_id)
    return _read_object_file(store_dir, object_id, t0)


def _read_object_file(store_dir: str, object_id: ObjectID,
                      t0: float) -> Optional[ObjectBuffer]:
    import fcntl

    path = _obj_path(store_dir, object_id)
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return None
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_SH)
        if os.fstat(f.fileno()).st_ino != os.stat(path).st_ino:
            f.close()  # pooled/recycled between open and lock: gone
            return None
    except OSError:
        f.close()
        return None
    m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    # the flock fd must outlive every exported view of the mapping, even
    # when release() can't close the mmap (BufferError): tie the fd's
    # close to the mapping's own collection
    weakref.finalize(m, f.close)
    if m[:8] != _MAGIC:
        m.close()
        f.close()
        raise IOError(f"corrupt object {object_id}")
    meta_len = int.from_bytes(m[8:16], "little")
    data_len = int.from_bytes(m[16:24], "little")
    metadata = bytes(m[_HEADER : _HEADER + meta_len])
    data = memoryview(m)[_HEADER + meta_len : _HEADER + meta_len + data_len]
    mx = _mx()
    mx.get_lat.record(time.perf_counter() - t0)
    mx.get_bytes.record(data_len)
    return ObjectBuffer(object_id, metadata, data, _mmap=m, _file=f)


def object_exists(store_dir: str, object_id: ObjectID) -> bool:
    return slab_arena.exists(store_dir, object_id.binary()) \
        or os.path.exists(_obj_path(store_dir, object_id))


def discard_local(store_dir: str, object_id: ObjectID) -> bool:
    """Drop the local copy whatever its backing: mark a slab entry dead
    (live views keep their pages) or unlink the ``.obj`` file. The
    test/chaos surface for simulating object loss."""
    dropped = slab_arena.discard(store_dir, object_id.binary())
    try:
        os.unlink(_obj_path(store_dir, object_id))
        dropped = True
    except FileNotFoundError:
        pass
    return dropped


def _write_object_file(store_dir: str, object_id: ObjectID, metadata: bytes,
                       buffers: Iterable, total_data_len: int) -> int:
    """One-file `.obj` write (no metrics; spill staging + fallback)."""
    final = _obj_path(store_dir, object_id)
    if os.path.exists(final):
        return 0
    from ray_tpu_torch._private import native_store

    if native_store.available():
        return native_store.write_object(
            store_dir, object_id.hex(), metadata, buffers, total_data_len
        )
    tmp = final + f".building.{os.getpid()}"
    size = _HEADER + len(metadata) + total_data_len
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(metadata).to_bytes(8, "little"))
        f.write(total_data_len.to_bytes(8, "little"))
        f.write(metadata)
        for buf in buffers:
            f.write(buf)
    os.rename(tmp, final)
    return size


def write_object(
    store_dir: str,
    object_id: ObjectID,
    metadata: bytes,
    buffers: Iterable,
    total_data_len: int,
) -> int:
    """Create + seal a one-file object from buffers. Returns bytes written.

    Safe from any process; accounting is reconciled by the owning store's
    directory scan. Writing an already-sealed id is a no-op (objects are
    immutable, so double-writes are benign)."""
    t0 = time.perf_counter()
    written = _write_object_file(
        store_dir, object_id, metadata, buffers, total_data_len
    )
    if written:
        mx = _mx()
        mx.put_lat.record(time.perf_counter() - t0)
        mx.put_bytes.record(total_data_len)
        mx.file_puts.inc()
    return written


def make_local_store(store_dir: str, capacity_bytes: int,
                     spill_dir: Optional[str] = None):
    """Owner-side store factory. With the slab arena enabled (default)
    the Python store owns the node's data plane — the arena layout is
    python-first, and the native C++ writer stays gated behind
    ``RAY_TPU_TORCH_slab_arena=0`` until it learns the slab format (the
    parity gate: both paths serve the same public store surface and the
    same test suite). Legacy mode picks the native store
    (``native_store``'s build of ``_private/csrc/``) when loadable. ``spill_dir`` is a path OR a
    storage URI (ray: local_object_manager.h:40 + external_storage.py):
    file:///bare paths spill to disk; other schemes (s3://,
    test-registered) route through the pluggable driver."""
    if cfg.slab_arena:
        return LocalObjectStore(store_dir, capacity_bytes, spill_dir)
    from ray_tpu_torch._private import native_store
    from ray_tpu_torch._private.external_storage import is_local_spill_uri

    if native_store.available() and is_local_spill_uri(spill_dir):
        from urllib.parse import urlparse

        local = urlparse(spill_dir).path if (
            spill_dir and spill_dir.startswith("file://")
        ) else spill_dir
        return native_store.NativeLocalObjectStore(
            store_dir, capacity_bytes, local
        )
    return LocalObjectStore(store_dir, capacity_bytes, spill_dir,
                            arena=False)


class _Segment:
    """Owner-side record of one slab segment."""

    __slots__ = ("seg_id", "size", "leased_to", "last_access", "live",
                 "writer", "live_bytes", "dead", "reserved", "punched")

    def __init__(self, seg_id: int, size: int, leased_to: Optional[str]):
        self.seg_id = seg_id
        self.size = size  # accounted bytes (full lease, trimmed at seal)
        self.leased_to = leased_to  # client_id, "_local", or None=sealed
        self.last_access = time.monotonic()
        self.live: set = set()  # ObjectIDs resident in this segment
        # memory observatory (memview.py): the writing client survives
        # the seal (leased_to goes None) so per-client slab charge and
        # object ownership stay attributable, and deleted entries leave
        # their byte ranges behind — the input the hole-punch pass
        # (punch_holes) reclaims
        self.writer = leased_to
        self.live_bytes = 0
        self.dead: Dict[int, int] = {}  # entry offset -> entry bytes
        # in-flight receive-side assemblies (SlabReservation): an
        # unsealed entry a cross-node transfer is pwriting into — the
        # segment must not be unlinked or punched under it
        self.reserved = 0
        # hole-punched (tombstoned) ranges: range offset -> range bytes.
        # Retired from `dead` and the dead tallies at punch time; kept
        # so reconcile's rescan never re-counts a punched tombstone
        self.punched: Dict[int, int] = {}


class LocalObjectStore:
    """Owner-side store accounting: capacity, pinning, eviction, slabs.

    Runs inside the raylet (one per node). Mirrors the reference's
    ObjectLifecycleManager + EvictionPolicy
    (ray: src/ray/object_manager/plasma/object_lifecycle_manager.h:101,
    eviction_policy.h:160), with plasma's arena semantics: capacity is
    charged at slab-lease granularity, workers self-report sealed
    entries in batches, and reclamation is whole-segment.
    """

    def __init__(self, store_dir: str, capacity_bytes: int,
                 spill_dir: Optional[str] = None,
                 arena: Optional[bool] = None):
        self.store_dir = store_dir
        os.makedirs(store_dir, exist_ok=True)
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        # URI-pluggable spill backend (ray parity: external_storage.py);
        # a bare path / file:// is the classic spill-to-disk
        from ray_tpu_torch._private.external_storage import make_external_storage

        self._external = make_external_storage(spill_dir)
        self._spill_staging_root = self._resolve_spill_staging_root()
        self._sweep_stale_spill_staging()
        self._lock = threading.Lock()
        self._sizes: Dict[ObjectID, int] = {}  # file-backed objects
        self._lru: "OrderedDict[ObjectID, float]" = OrderedDict()
        self._pinned: Dict[ObjectID, int] = {}
        self._used = 0
        self._spilled: Dict[ObjectID, int] = {}  # oid -> size on disk
        # when each object left shm (memview: leak verdicts age-gate
        # against in-flight reports, so every lifecycle state needs an
        # age — arena rows carry their created ts in _slab_objs)
        self._spilled_at: Dict[ObjectID, float] = {}
        # restored-from-external objects whose backend copy still exists
        # (cleaned at delete); and oids whose one restart-recovery probe
        # already missed (never probe the backend again for them) —
        # bounded FIFO so an overflow evicts the oldest entries instead
        # of nuking the whole negative cache
        self._ever_spilled: set = set()
        self._probe_missed: "OrderedDict[ObjectID, None]" = OrderedDict()
        self.spilled_bytes_total = 0
        self.restored_bytes_total = 0
        self.overshoot_bytes_total = 0
        # overshoot attributed to its admission path (memview pressure
        # verdicts name the cause): register_external | untracked_restore
        self.overshoot_by_cause: Dict[str, int] = {}
        # --- slab arena (owner side) ----------------------------------
        self.arena_enabled = cfg.slab_arena if arena is None else arena
        self._segments: Dict[int, _Segment] = {}
        # oid -> (seg, off, len, created_monotonic)
        self._slab_objs: Dict[ObjectID, tuple] = {}
        # rolling arena occupancy (memview gauges: fragmentation ratio =
        # dead / (live + dead)); maintained at adopt/forget/unlink so a
        # metrics scrape never walks the ledger
        self._slab_live_bytes = 0
        self._slab_dead_bytes = 0
        # rolling hole-punch tallies (punch_holes): logical dead bytes
        # retired from the tallies above + physical bytes punched
        self._slab_punched_bytes = 0
        self._slab_punched_physical = 0
        self._punch_probe: Optional[bool] = None  # lazy support probe
        # deletes racing in-flight accounting reports (bounded FIFO —
        # frees of inline objects the store never saw land here too, and
        # must not pin memory or evict the cap into uselessness)
        self._pending_deletes: "OrderedDict[ObjectID, None]" = OrderedDict()
        self._next_seg = 0
        # segment recycling pool: all-dead segments parked (renamed) for
        # lease reuse — a steady put/free cadence writes into warm tmpfs
        # pages instead of faulting fresh zero pages per slab. Reuse is
        # gated on an EXCLUSIVE non-blocking flock (readers hold a SHARED
        # flock per cached segment mapping), so a segment some process
        # can still see is never rewritten. path -> (file_size, charged);
        # the charge stays on _used until the entry drains or is reused.
        self._pool: "OrderedDict[str, tuple]" = OrderedDict()
        self._pool_seq = 0
        self._pool_pinned_cache: tuple = (0.0, [])  # (ts, last probe)
        self._index = None
        self._local_writer = None
        if self.arena_enabled:
            os.makedirs(os.path.join(store_dir, slab_arena.SLAB_DIR),
                        exist_ok=True)
            self._index = slab_arena.SharedIndex(
                slab_arena.index_path(store_dir),
                slots=cfg.slab_index_slots, create=True,
            )
            self._local_writer = slab_arena.SlabWriter(store_dir)
            # serializes the put slow path (seal/lease/attach): two
            # concurrent refills would detach each other's fresh
            # "_local" segment, stranding its capacity charge
            self._local_put_lock = threading.Lock()
            with self._lock:
                self._rescan_segments_locked()

    # -- restart rescan ------------------------------------------------------
    def _rescan_segments_locked(self):
        """Adopt whatever a predecessor left in the slab dir: sealed
        entries become live objects again, torn tails (writer killed
        mid-put) are discarded by construction (scan stops at the first
        unsealed entry), and empty segments are unlinked."""
        slab_dir = os.path.join(self.store_dir, slab_arena.SLAB_DIR)
        try:
            names = os.listdir(slab_dir)
        except OSError:
            return
        for name in sorted(names):
            path = os.path.join(slab_dir, name)
            seg_id = slab_arena.segment_id_of(path)
            if seg_id is None:
                if name.startswith("pool_"):  # predecessor's recycle pool
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                continue
            self._next_seg = max(self._next_seg, seg_id + 1)
            seg = _Segment(seg_id, 0, leased_to=None)
            end = self._reconcile_segment_locked(seg)
            if not seg.live:
                # retire the dead-range tally with the file: this
                # segment never enters _segments, so its scan-counted
                # dead bytes would otherwise pin the gauge forever
                self._slab_dead_bytes -= sum(seg.dead.values())
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            seg.size = slab_arena.align_up(end)
            self._segments[seg_id] = seg
            self._used += seg.size

    # -- slab lease protocol (raylet-facing) ---------------------------------
    def lease_slab(self, client_id: str, nbytes: int,
                   seals=None) -> dict:
        """Grant one pre-sized slab segment to a writer (one RPC
        amortized over many puts). ``seals`` retires the caller's
        previous slab(s) in the same round trip."""
        if not self.arena_enabled:
            return {"ok": False}
        if isinstance(seals, dict):
            seals = [seals]
        nbytes = slab_arena.align_up(max(1, nbytes))
        with self._lock:
            for seal in seals or ():
                self._seal_segment_locked(
                    int(seal["seg_id"]), int(seal["used"]), client_id
                )
            try:
                self._ensure_space_locked(nbytes)
            except ObjectStoreFullError:
                return {"ok": False}
            seg_id, actual = self._create_segment_locked(client_id, nbytes)
        return {"ok": True, "seg_id": seg_id, "size": actual}

    _POOL_MIN_BYTES = 1 << 20  # pooling tiny segments isn't worth the rename

    def _create_segment_locked(self, client_id: str, size: int) -> tuple:
        """Create (or recycle) one segment; returns (seg_id, actual_size)
        — a reused pooled file may be larger than asked."""
        seg_id = self._next_seg
        self._next_seg += 1
        reused = self._reuse_pooled_locked(seg_id, size)
        if reused is None:
            slab_arena.create_segment(self.store_dir, seg_id, size)
            self._used += size
        else:
            size = reused
        self._segments[seg_id] = _Segment(seg_id, size, leased_to=client_id)
        return seg_id, size

    def _reuse_pooled_locked(self, seg_id: int, size: int) -> Optional[int]:
        """Adopt a pooled segment for a new lease when provably unmapped
        (exclusive flock) and big enough. Returns its file size, or
        None."""
        if not self._pool:
            return None
        import fcntl

        # our own reader cache may hold the SHARED flock of a pooled
        # (path-vanished) segment: release those first
        slab_arena.view(self.store_dir).sweep()
        for path, (fsize, charged) in list(self._pool.items()):
            if fsize < size:
                continue
            if self._used + (fsize - charged) > self.capacity:
                # adopting would re-charge the file's full length past
                # capacity — the lease's space check only approved
                # ``size``; an oversized pooled file must not sneak
                # unaccounted bytes in
                continue
            try:
                fd = os.open(path, os.O_RDWR)
            except OSError:
                self._pool.pop(path, None)
                continue
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                continue  # a reader still maps it: leave it pooled
            try:
                os.rename(path, slab_arena.segment_path(self.store_dir,
                                                        seg_id))
            except OSError:
                os.close(fd)
                self._pool.pop(path, None)
                continue
            os.close(fd)  # releases the probe flock
            self._pool.pop(path, None)
            self._used += fsize - charged  # re-charge at full file size
            return fsize

    def _seal_segment_locked(self, seg_id: int, used: int, client_id: str):
        seg = self._segments.get(seg_id)
        if seg is None or seg.leased_to != client_id:
            return
        # reconcile BEFORE trimming: sealed entries the writer never got
        # to report (lost notify, kill -9) are recovered from the slab
        # itself — the accounting protocol is advisory, the arena is
        # ground truth
        end = self._reconcile_segment_locked(seg)
        used = slab_arena.align_up(max(used, end))
        credit = seg.size - used
        if credit > 0:
            self._used -= credit
            seg.size = used
        seg.leased_to = None
        if not seg.live and not seg.reserved:
            self._unlink_segment_locked(seg)

    def _mark_dead_range_locked(self, seg: _Segment, off: int, total: int):
        """Account one dead entry range (idempotent: reconcile re-scans
        segments, and a range must count once — a punched range's
        covering tombstone scans as one big dead entry and must never
        re-enter the tallies it already left)."""
        if off in seg.dead or off in seg.punched:
            return
        seg.dead[off] = total
        self._slab_dead_bytes += total

    def _reconcile_segment_locked(self, seg: _Segment) -> int:
        """Scan a segment's sealed prefix into the ledger; returns the
        scan end offset. Idempotent with worker reports."""
        end = 0
        path = slab_arena.segment_path(self.store_dir, seg.seg_id)
        for oid_b, off, _ml, _dl, total, dead in slab_arena.scan_segment(path):
            end = off + total
            if dead:
                self._mark_dead_range_locked(seg, off, total)
                continue
            oid = ObjectID(oid_b)
            if oid in self._slab_objs:
                continue
            if oid in self._pending_deletes:
                # the free won the race against the writer's report (or
                # death): complete the delete — merely skipping would
                # leave the entry sealed and index-visible forever
                self._pending_deletes.pop(oid, None)
                slab_arena.mark_dead_at(self.store_dir, seg.seg_id, off)
                self._index.mark_dead(oid_b)
                self._mark_dead_range_locked(seg, off, total)
                continue
            seg.live.add(oid)
            seg.live_bytes += total
            self._slab_live_bytes += total
            self._slab_objs[oid] = (seg.seg_id, off, total, time.monotonic())
            self._index.insert(oid_b, seg.seg_id, off)
        return end

    def record_slab_objects(self, entries: Iterable[dict]) -> List[bytes]:
        """Batched accounting from writers: adopt reported entries into
        the ledger. Returns the oids that are NEW to this store (the
        caller registers their locations with the GCS in one batch)."""
        new: List[bytes] = []
        deletes: List[ObjectID] = []
        with self._lock:
            for e in entries:
                oid = ObjectID(bytes(e["o"]))
                seg = self._segments.get(int(e["s"]))
                if seg is None:
                    # segment already reclaimed (straggler report after a
                    # seal+unlink): the bytes are gone, nothing to adopt
                    continue
                if oid in self._slab_objs:
                    continue
                off, total = int(e["f"]), int(e["n"])
                if oid in self._pending_deletes:
                    # the free won the race: adopt the entry so the
                    # delete below can mark it dead, never resurrect it
                    self._pending_deletes.pop(oid, None)
                    seg.live.add(oid)
                    seg.live_bytes += total
                    self._slab_live_bytes += total
                    self._slab_objs[oid] = (seg.seg_id, off, total,
                                            time.monotonic(), e.get("c"))
                    deletes.append(oid)
                    continue
                seg.live.add(oid)
                seg.live_bytes += total
                self._slab_live_bytes += total
                seg.last_access = time.monotonic()
                # "c" = the owner's creation callsite riding the report:
                # persisted in the store ledger so a DEAD owner's leak
                # verdict still names the line that made the object
                self._slab_objs[oid] = (seg.seg_id, off, total,
                                        time.monotonic(), e.get("c"))
                self._probe_missed.pop(oid, None)
                new.append(oid.binary())
        for oid in deletes:
            self.delete(oid)
        return new

    def reclaim_client_slabs(self, client_id: str) -> List[bytes]:
        """A writer died: adopt the sealed prefix of every slab it still
        leased (unreported entries included; the torn mid-put tail, if
        any, is discarded by the scan) and make the segments evictable.
        Returns newly adopted oids for location registration.

        KV pages (``KVPG`` oid prefix, serve/llm/kv_cache.py) are the
        exception: a dead replica's KV cache is cache, not data — no
        process can ever reference those oids again, so adopting them
        would park them in the ledger until they aged into leak
        verdicts. They go straight to dead ranges (and the PUNCH_HOLE
        sweep) instead."""
        new: List[bytes] = []
        if not self.arena_enabled:
            return new
        kv_prefix = slab_arena.KV_PAGE_OID_PREFIX
        with self._lock:
            for seg in list(self._segments.values()):
                if seg.leased_to != client_id:
                    continue
                before = set(seg.live)
                end = self._reconcile_segment_locked(seg)
                for oid in [o for o in seg.live
                            if o.binary().startswith(kv_prefix)]:
                    self._delete_locked(oid)
                new.extend(o.binary() for o in seg.live - before)
                used = slab_arena.align_up(end)
                if seg.size > used:
                    self._used -= seg.size - used
                    seg.size = used
                seg.leased_to = None
                if not seg.live and not seg.reserved:
                    self._unlink_segment_locked(seg)
        return new

    def _unlink_segment_locked(self, seg: _Segment):
        """Retire an all-dead segment: park big ones in the recycling
        pool (warm pages for the next lease), unlink the rest."""
        path = slab_arena.segment_path(self.store_dir, seg.seg_id)
        self._segments.pop(seg.seg_id, None)
        # its dead ranges leave the arena with it (pooled files are
        # state-wiped; unlinked files are gone)
        self._slab_dead_bytes -= sum(seg.dead.values())
        self._slab_live_bytes -= seg.live_bytes
        seg.dead = {}
        seg.punched = {}
        seg.live_bytes = 0
        pool_cap = max(cfg.slab_size_bytes * 2, self.capacity // 4)
        pooled_bytes = sum(c for _f, c in self._pool.values())
        if seg.size >= self._POOL_MIN_BYTES \
                and pooled_bytes + seg.size <= pool_cap:
            try:
                fsize = os.path.getsize(path)  # full length, not the
                # seal-trimmed accounting size — reuse fits against this
                slab_arena.wipe_entry_states(path)
                self._pool_seq += 1
                pooled = os.path.join(
                    self.store_dir, slab_arena.SLAB_DIR,
                    f"pool_{self._pool_seq:08d}.slab",
                )
                os.rename(path, pooled)
                self._pool[pooled] = (fsize, seg.size)  # charge stays
                return
            except OSError:
                pass
        try:
            os.unlink(path)
        except OSError:
            pass
        self._used -= seg.size

    def _forget_slab_obj_locked(self, object_id: ObjectID,
                                mark_dead: bool = True):
        ent = self._slab_objs.pop(object_id, None)
        if ent is None:
            return
        seg_id, off, total = ent[:3]
        if mark_dead:
            slab_arena.mark_dead_at(self.store_dir, seg_id, off)
            self._index.mark_dead(object_id.binary())
        seg = self._segments.get(seg_id)
        if seg is not None:
            seg.live.discard(object_id)
            seg.live_bytes -= total
            self._slab_live_bytes -= total
            # discarded-behind-the-ledger entries (mark_dead=False) are
            # dead bytes in the segment all the same
            self._mark_dead_range_locked(seg, off, total)
            if not seg.live and seg.leased_to is None and not seg.reserved:
                self._unlink_segment_locked(seg)

    # -- write path ----------------------------------------------------------
    def _local_slab_alloc(self, entry_total: int, attempt):
        """Run one allocation ``attempt`` (a closure over the raylet's
        self-leased writer) through the seal/lease/attach slow path.
        ``attempt()`` returns its result or None when the current slab
        can't fit the entry; capacity exhaustion raises through
        ``_ensure_space_locked``. Shared by owner-local puts AND
        receive-side assembly reservations — the slab-writer plumbing
        the transfer plane rides."""
        ent = attempt()
        if ent is not None:
            return ent
        # a freshly attached segment can be consumed by the LOCK-FREE
        # fast path of a concurrent put before our retry lands, so loop;
        # true capacity exhaustion terminates via _ensure_space_locked's
        # raise
        with self._local_put_lock:
            for _ in range(8):
                ent = attempt()
                if ent is not None:
                    return ent
                with self._lock:
                    seal = self._local_writer.take_seal()
                    if seal:
                        self._seal_segment_locked(
                            seal["seg_id"], seal["used"], "_local"
                        )
                    size = max(entry_total,
                               min(cfg.slab_size_bytes,
                                   max(slab_arena.ALIGN,
                                       self.capacity // 8)))
                    self._ensure_space_locked(size)
                    seg_id, size = self._create_segment_locked(
                        "_local", size)
                self._local_writer.attach(seg_id, size)
            # the loop's last act was an attach: give the fresh segment
            # one final try before declaring failure
            return attempt()

    def put(self, object_id: ObjectID, metadata: bytes, buffers,
            total_data_len: int):
        """Owner-local put (pull/push receives, broadcasts): bump into the
        raylet's own slab — the raylet leases from itself, no RPC."""
        if not self.arena_enabled:
            return self._put_file(object_id, metadata, buffers,
                                  total_data_len)
        with self._lock:
            if object_id in self._slab_objs or object_id in self._sizes:
                return  # immutable: double-writes are benign
        t0 = time.perf_counter()
        entry_total = slab_arena.entry_size(len(metadata), total_data_len)
        ent = self._local_slab_alloc(
            entry_total,
            lambda: self._local_writer.try_put(
                object_id.binary(), metadata, buffers, total_data_len
            ),
        )
        if ent is None:
            raise ObjectStoreFullError(
                f"local slab put of {object_id.hex()} ({entry_total} bytes) "
                "kept losing freshly attached segments to concurrent puts"
            )
        self.record_slab_objects([ent])
        mx = _mx()
        mx.put_lat.record(time.perf_counter() - t0)
        mx.put_bytes.record(total_data_len)
        mx.slab_puts.inc()

    # -- receive-side slab assembly (arena-to-arena transfer plane) ----------
    def reserve(self, object_id: ObjectID, metadata: bytes,
                total_data_len: int) -> Optional["SlabReservation"]:
        """Reserve one in-flight slab entry for a cross-node transfer
        to assemble into: the real header goes down immediately with
        state DEAD (scans traverse it — entries sealed behind a crashed
        assembly stay rescan-adoptable), chunks pwrite straight into
        the segment file at their offsets (out-of-order safe), and
        ``seal()`` flips the state word DEAD→SEALED only when every
        byte has arrived — the same atomic-seal contract as a local
        put. Returns None when the transfer should fall back to heap
        assembly (arena off, store full, duplicate object)."""
        if not self.arena_enabled:
            return None
        with self._lock:
            if object_id in self._slab_objs or object_id in self._sizes:
                return None  # already resident: nothing to assemble
        entry_total = slab_arena.entry_size(len(metadata), total_data_len)

        def attempt():
            got = self._local_writer.try_reserve(entry_total)
            if got is None:
                return None
            seg_id, off = got
            # claim the range in the ledger ATOMICALLY with the bump: a
            # concurrent put's seal of this very segment must see
            # reserved>0 and keep the file alive under our pwrites; if
            # the seal already retired the segment (the take_seal beat
            # our try_reserve to the writer lock is impossible — the
            # writer detaches first — but a reserve that lost the store
            # lock to the seal is), treat it as slab-full and loop
            with self._lock:
                seg = self._segments.get(seg_id)
                if seg is None:
                    return None
                seg.reserved += 1
            return got

        try:
            got = self._local_slab_alloc(entry_total, attempt)
        except ObjectStoreFullError:
            return None  # transfer degrades to heap assembly + store.put
        if got is None:
            return None
        seg_id, off = got
        res = SlabReservation(self, object_id, seg_id, off,
                              len(metadata), total_data_len)
        try:
            fd = os.open(slab_arena.segment_path(self.store_dir, seg_id),
                         os.O_RDWR)
        except OSError:
            # no fd, no header written: the range stays a zero-state
            # (scan-stopping) torn entry — rare (open of a leased
            # segment's path), and the accounting still goes dead
            res.abandon()
            return None
        res._fd = fd
        try:
            # the REAL header goes down now, with state DEAD: oid and
            # lengths are known up front (the first chunk carries the
            # metadata), so a scan can traverse this in-flight entry —
            # a receiver crash strands nothing sealed behind it. Body
            # first, state word second: a crash between leaves a torn
            # entry, the old (scan-stopping) posture, in a microsecond
            # window instead of the whole transfer.
            hdr = slab_arena._pack_header(object_id.binary(),
                                          len(metadata), total_data_len)
            os.pwrite(fd, hdr[: slab_arena.HDR - 8], off + 8)
            os.pwrite(fd, slab_arena.STATE_DEAD, off)
            if metadata:
                slab_arena.pwrite_all(fd, metadata, off + slab_arena.HDR)
        except OSError:
            res.abandon()
            return None
        return res

    def _commit_reservation(self, res: "SlabReservation") -> bool:
        """All bytes arrived: seal (state-word flip), publish in the
        shared index, and adopt into the ledger — the receive-side twin
        of a worker's sealed-entry report."""
        ent = {"o": res.object_id.binary(), "s": res.seg_id,
               "f": res.off, "n": res.entry_total}
        # adopt FIRST, decrement the reservation count AFTER: while the
        # count still covers us, no racing abandon/evict can unlink (or
        # pool-recycle) the segment between the adoption and our check —
        # dropping the count first opened a window where a completed
        # transfer's segment vanished and the received bytes were lost
        self.record_slab_objects([ent])
        with self._lock:
            seg = self._segments.get(res.seg_id)
            if seg is not None:
                seg.reserved = max(0, seg.reserved - 1)
            cur = self._slab_objs.get(res.object_id)
            ours = (cur is not None and cur[0] == res.seg_id
                    and cur[1] == res.off)
            if not ours:
                # a racing session/put sealed this object first (or the
                # free raced the adoption): OUR sealed entry is
                # unreachable by the ledger — tombstone it dead so its
                # bytes are reclaimable instead of leaking until the
                # segment dies
                if seg is not None and res._fd is not None:
                    try:
                        os.pwrite(res._fd, slab_arena.STATE_DEAD, res.off)
                    except OSError:
                        pass
                    self._mark_dead_range_locked(seg, res.off,
                                                 res.entry_total)
                if seg is not None and not seg.live \
                        and seg.leased_to is None and not seg.reserved:
                    self._unlink_segment_locked(seg)
                return False
            if seg is not None:
                # a slab-seal reconcile may have scanned our in-flight
                # (DEAD-state) entry into the dead tallies: it is live
                # now — un-count it or the range reads punchable forever
                stale = seg.dead.pop(res.off, None)
                if stale:
                    self._slab_dead_bytes -= stale
        self._index.insert(res.object_id.binary(), res.seg_id, res.off)
        mx = _mx()
        mx.put_bytes.record(res.total_data_len)
        mx.slab_puts.inc()
        mx.rx_assemblies.inc()
        return True

    def _abandon_reservation(self, res: "SlabReservation"):
        """The transfer died (sender gone, session expired, chunk
        failure): the entry header already reads DEAD (written at
        reserve time, so scans hop it either way) — account the range
        as dead bytes for the punch pass like any other dead entry."""
        with self._lock:
            seg = self._segments.get(res.seg_id)
            if seg is None:
                return
            seg.reserved = max(0, seg.reserved - 1)
            self._mark_dead_range_locked(seg, res.off, res.entry_total)
            if not seg.live and seg.leased_to is None and not seg.reserved:
                self._unlink_segment_locked(seg)

    def _put_file(self, object_id: ObjectID, metadata: bytes, buffers,
                  total_data_len: int):
        size = _HEADER + len(metadata) + total_data_len
        self._ensure_space(size)
        written = write_object(self.store_dir, object_id, metadata, buffers,
                               total_data_len)
        if written:
            with self._lock:
                self._sizes[object_id] = written
                self._used += written
                self._lru[object_id] = time.monotonic()
                # the id exists now: a previously-cached miss must not
                # mask a later spill-restore of this object
                self._probe_missed.pop(object_id, None)

    def register_external(self, object_id: ObjectID):
        """Account for a one-file object written directly by another
        process (lease-less fallback writes, restores) — capacity is
        enforced here too (spilling older objects to make room; the new
        object is already on shm, so the budget is made around it)."""
        path = _obj_path(self.store_dir, object_id)
        try:
            size = os.path.getsize(path)
        except FileNotFoundError:
            return
        with self._lock:
            if object_id in self._pending_deletes:
                # the owner already freed this object while its
                # registration was in flight: complete the delete
                self._pending_deletes.pop(object_id, None)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                return
            self._probe_missed.pop(object_id, None)
            if object_id not in self._sizes:
                try:
                    self._ensure_space_locked(size)
                except ObjectStoreFullError:
                    # already written: track the overshoot honestly
                    self._count_overshoot_locked(size, "register_external")
                self._sizes[object_id] = size
                self._used += size
                self._lru[object_id] = time.monotonic()

    def _count_overshoot_locked(self, size: int, cause: str):
        over = min(size, max(0, self._used + size - self.capacity))
        if over > 0:
            self.overshoot_bytes_total += over
            self.overshoot_by_cause[cause] = \
                self.overshoot_by_cause.get(cause, 0) + over
            mx = _mx()
            mx.overshoot.inc(over)
            mx.overshoot_cause.labels(cause=cause).inc(over)

    # -- read path -----------------------------------------------------------
    def _slab_read(self, object_id: ObjectID) -> Optional[ObjectBuffer]:
        t0 = time.perf_counter()
        with self._lock:
            ent = self._slab_objs.get(object_id)
        if ent is not None:
            seg_id, off = ent[0], ent[1]
            got = slab_arena.read_at(self.store_dir, seg_id, off,
                                     object_id.binary())
            if got is not None:
                metadata, data = got
                with self._lock:
                    seg = self._segments.get(seg_id)
                    if seg is not None:
                        seg.last_access = time.monotonic()
                # index repair: a lost insert (slot race) must not force
                # every reader onto the RPC fallback forever
                if self._index.lookup(object_id.binary()) is None:
                    self._index.insert(object_id.binary(), seg_id, off)
                return self._record_get(
                    ObjectBuffer(object_id, metadata, data, seg_id=seg_id),
                    t0,
                )
            # discarded/torn behind the ledger: drop the record
            with self._lock:
                self._forget_slab_obj_locked(object_id, mark_dead=False)
            return None
        # not in the ledger yet (report in flight): the shared index is
        # the writer's synchronous publication — trust it
        hit = slab_arena.read(self.store_dir, object_id.binary())
        if hit is not None:
            metadata, data, seg_id = hit
            return self._record_get(
                ObjectBuffer(object_id, metadata, data, seg_id=seg_id), t0
            )
        return None

    @staticmethod
    def _record_get(buf: ObjectBuffer, t0: float) -> ObjectBuffer:
        # raylets serve pulls from here: slab reads must show in the
        # get histograms just like the file path's do
        mx = _mx()
        mx.get_lat.record(time.perf_counter() - t0)
        mx.get_bytes.record(buf.data.nbytes)
        return buf

    def get(self, object_id: ObjectID) -> Optional[ObjectBuffer]:
        if self.arena_enabled:
            buf = self._slab_read(object_id)
            if buf is not None:
                return buf
        buf = _read_object_file(self.store_dir, object_id,
                                time.perf_counter())
        if buf is None and (object_id in self._spilled
                            or self._external is not None):
            # second disjunct = restart recovery: a fresh raylet's ledger
            # doesn't know what its predecessor spilled externally
            if self.restore_if_spilled(object_id):
                buf = _read_object_file(self.store_dir, object_id,
                                        time.perf_counter())
        if buf is not None:
            with self._lock:
                if object_id in self._lru:
                    self._lru.move_to_end(object_id)
        return buf

    def contains(self, object_id: ObjectID) -> bool:
        if self.arena_enabled:
            with self._lock:
                ent = self._slab_objs.get(object_id)
            if ent is not None:
                state = slab_arena.state_at(self.store_dir, ent[0], ent[1],
                                            object_id.binary())
                if state == slab_arena.STATE_SEALED:
                    return True
                with self._lock:
                    self._forget_slab_obj_locked(object_id, mark_dead=False)
            elif slab_arena.exists(self.store_dir, object_id.binary()):
                return True  # unreported writer object via the shared index
        if os.path.exists(_obj_path(self.store_dir, object_id)) \
                or object_id in self._spilled:
            return True
        if self._external is None or object_id in self._probe_missed:
            return False
        try:
            found = self._external.exists(self._spill_key(object_id))
        except Exception:
            found = False
        (_mx().ext_hits if found else _mx().ext_misses).inc()
        if not found:
            # at most ONE external round trip per unseen id (the restore
            # path's contract): a routine containment check for an object
            # living on another node must not pay a backend probe forever.
            # Cleared when the object actually lands here (put /
            # register_external).
            with self._lock:
                self._probe_missed_add_locked(object_id)
        return found

    def _probe_missed_add_locked(self, object_id: ObjectID):
        self._probe_missed[object_id] = None
        self._probe_missed.move_to_end(object_id)
        while len(self._probe_missed) > _PROBE_MISSED_MAX:
            self._probe_missed.popitem(last=False)  # bounded FIFO eviction

    # -- spilling (ray: local_object_manager.h SpillObjects/restore) ---------
    @staticmethod
    def _spill_key(object_id: ObjectID) -> str:
        # deterministic, node-independent: a restarted raylet (new node
        # id) can restore a predecessor's externally-spilled objects
        return object_id.hex() + ".obj"

    def _resolve_spill_staging_root(self) -> str:
        """Parent dir for mid-spill ``.obj`` staging. Spilling runs
        exactly when shm is over capacity, and on many hosts /tmp is
        itself tmpfs — staging there would double RAM-backed usage per
        object while memory is the resource being reclaimed. Prefer the
        spill destination's own filesystem when it is local;
        ``spill_staging_dir`` overrides, system temp is the last resort
        (non-local backends with no override)."""
        import tempfile

        from ray_tpu_torch._private.external_storage import FileSystemStorage

        if cfg.spill_staging_dir:
            return cfg.spill_staging_dir
        if isinstance(self._external, FileSystemStorage):
            return self._external.root
        return tempfile.gettempdir()

    def _staging_dir_name(self) -> str:
        # host-qualified: a file:// spill root may be a shared NFS/GCS
        # mount, and pid liveness is only checkable on the owning host
        return f"rtpu_torch_spill_stage_{os.uname().nodename}_{os.getpid()}"

    def _sweep_stale_spill_staging(self):
        """Remove rtpu_torch_spill_stage_<host>_<pid> dirs stranded by a
        raylet that died mid-spill. Only THIS host's dirs are judged —
        on a shared spill mount another node's pid space is opaque, and
        sweeping its live staging would fail its in-flight spills."""
        import shutil

        try:
            names = os.listdir(self._spill_staging_root)
        except OSError:
            return
        host = os.uname().nodename
        for name in names:
            if not name.startswith("rtpu_torch_spill_stage_"):
                continue
            owner, _, pid_s = name[len("rtpu_torch_spill_stage_"):].rpartition("_")
            try:
                pid = int(pid_s)
            except ValueError:
                continue  # not our naming scheme: leave it
            if owner != host:
                continue
            if pid != os.getpid():
                try:
                    os.kill(pid, 0)
                    continue  # owner still alive — not ours to sweep
                except ProcessLookupError:
                    pass
                except OSError:
                    continue  # exists under another uid: leave it
            shutil.rmtree(
                os.path.join(self._spill_staging_root, name),
                ignore_errors=True,
            )

    def _spill_locked(self, object_id: ObjectID) -> bool:
        """Move one file-backed object from shm to the external backend;
        the object stays addressable and is restored on access. Pin
        counts survive: a spilled primary copy is still the primary."""
        src = _obj_path(self.store_dir, object_id)
        size = self._sizes.get(object_id, 0)
        t0 = time.perf_counter()
        try:
            self._external.spill(self._spill_key(object_id), src)
            os.unlink(src)
        except Exception:
            return False  # backend errors (boto, plugin) degrade to no-spill
        self._sizes.pop(object_id, None)
        self._lru.pop(object_id, None)
        self._used -= size
        self._spilled[object_id] = size
        self._spilled_at[object_id] = time.monotonic()
        self.spilled_bytes_total += size
        _mx().spills.inc()
        memview.record_flow("spill", size, time.perf_counter() - t0,
                            "file", object_id.hex())
        return True

    def _spill_slab_object_locked(self, object_id: ObjectID) -> bool:
        """Stage one slab entry out as a `.obj` file (the spill/interop
        format) and hand it to the backend; the slab entry is then marked
        dead. Restore brings it back file-backed."""
        ent = self._slab_objs.get(object_id)
        if ent is None:
            return False
        seg_id, off = ent[0], ent[1]
        t0 = time.perf_counter()
        got = slab_arena.read_at(self.store_dir, seg_id, off,
                                 object_id.binary())
        if got is None:  # discarded behind the ledger
            self._forget_slab_obj_locked(object_id, mark_dead=False)
            return False
        metadata, data = got
        # stage outside the shm store_dir, on the spill destination's
        # filesystem when local (see _resolve_spill_staging_root):
        # backends only read local_path, so any filesystem works, but a
        # tmpfs staging copy would consume the memory being reclaimed
        staging = os.path.join(self._spill_staging_root,
                               self._staging_dir_name())
        os.makedirs(staging, exist_ok=True)
        src = _obj_path(staging, object_id)
        try:
            size = _write_object_file(staging, object_id, metadata,
                                      [data], data.nbytes) \
                or os.path.getsize(src)
            # same-filesystem backends adopt the staged file by rename
            # (one disk write per object, not two); others copy
            mover = getattr(self._external, "spill_move", None)
            if mover is None or not mover(self._spill_key(object_id), src):
                self._external.spill(self._spill_key(object_id), src)
        except Exception:
            self._drop_staged_locked(staging, src)
            return False
        finally:
            data.release()
        self._drop_staged_locked(staging, src)
        self._forget_slab_obj_locked(object_id)
        self._spilled[object_id] = size
        self._spilled_at[object_id] = time.monotonic()
        self.spilled_bytes_total += size
        _mx().spills.inc()
        # arena path: bytes left straight from the slab mapping (the
        # one disk write is the staged interop file)
        memview.record_flow("spill", size, time.perf_counter() - t0,
                            "arena", object_id.hex())
        return True

    @staticmethod
    def _drop_staged_locked(staging: str, src: str):
        """Remove a staged spill copy and its per-pid dir (when empty) —
        a FileSystemStorage backend shares its root with the staging
        parent, and lingering dirs read as stranded spill state."""
        try:
            os.unlink(src)
        except OSError:
            pass
        try:
            os.rmdir(staging)
        except OSError:
            pass  # another spill in flight, or already gone

    def _spill_segment_locked(self, seg: _Segment) -> bool:
        progressed = False
        for oid in list(seg.live):
            progressed |= self._spill_slab_object_locked(oid)
        return progressed

    def restore_if_spilled(self, object_id: ObjectID) -> bool:
        """Bring a spilled object back into shm (ray:
        spilled_object_reader.h — we restore whole objects, file-backed).

        The EXTERNAL copy is deliberately left in place: objects are
        immutable, so with a shared backend (s3) another raylet may
        restore the same key concurrently — deleting on restore would
        destroy a peer's only spilled copy and strand its ledger. The
        external copy is cleaned when the OBJECT is deleted (refcount
        zero), tracked via _ever_spilled."""
        with self._lock:
            size = self._spilled.get(object_id)
            untracked = size is None
            if untracked:
                if self._external is None:
                    return False
                # restart-recovery probe: at most ONE external lookup per
                # unseen oid — a routine miss for an object living on
                # another node must not pay a backend round trip forever
                if object_id in self._probe_missed:
                    return False
            else:
                try:
                    self._ensure_space_locked(size)
                except ObjectStoreFullError:
                    return False
            dst = _obj_path(self.store_dir, object_id)
            t0 = time.perf_counter()
            try:
                ok = self._external.restore(
                    self._spill_key(object_id), dst
                )
            except Exception:
                ok = False  # backend errors (boto, plugin) degrade to miss
            if not ok:
                if untracked:
                    self._probe_missed_add_locked(object_id)
                return False
            if untracked:
                # a predecessor raylet spilled this object; its size
                # wasn't in our (fresh) ledger — the file is already on
                # shm, so a full store tracks the overshoot honestly
                try:
                    size = os.path.getsize(dst)
                except OSError:
                    size = 0
                try:
                    self._ensure_space_locked(size)
                except ObjectStoreFullError:
                    self._count_overshoot_locked(size, "untracked_restore")
            self._spilled.pop(object_id, None)
            self._spilled_at.pop(object_id, None)
            self._ever_spilled.add(object_id)
            self._sizes[object_id] = size
            self._used += size
            self._lru[object_id] = time.monotonic()
            self.restored_bytes_total += size
            _mx().restores.inc()
            memview.record_flow("restore", size,
                                time.perf_counter() - t0, "file",
                                object_id.hex())
            return True

    # -- lifecycle -----------------------------------------------------------
    def pin(self, object_id: ObjectID):
        with self._lock:
            self._pinned[object_id] = self._pinned.get(object_id, 0) + 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            n = self._pinned.get(object_id, 0) - 1
            if n <= 0:
                self._pinned.pop(object_id, None)
            else:
                self._pinned[object_id] = n

    def delete(self, object_id: ObjectID):
        with self._lock:
            self._delete_locked(object_id)

    def delete_many(self, object_ids: Iterable[ObjectID]):
        """Batched delete: one lock acquisition per free burst (owners
        tick-batch frees; a 10k-object teardown should not pay 10k lock
        round trips on the raylet loop)."""
        with self._lock:
            for oid in object_ids:
                self._delete_locked(oid)

    def forget(self, object_id: ObjectID):
        """Drop a LOST object's records WITHOUT the pending-delete
        tombstone. A loss report is not a free: lineage reconstruction
        will re-put this very oid, and a tombstone would kill the fresh
        copy the moment its accounting report lands."""
        with self._lock:
            self._delete_locked(object_id, tombstone=False)

    def _delete_locked(self, object_id: ObjectID, tombstone: bool = True):
        # This is the raylet's hottest non-data path: owners free EVERY
        # owned object through it, including inline values the store
        # never saw — the unknown-oid case must stay a few dict misses.
        size = self._sizes.pop(object_id, 0)
        known_file = size > 0
        if self.arena_enabled:
            if object_id in self._slab_objs:
                self._forget_slab_obj_locked(object_id)
            elif tombstone and not known_file \
                    and object_id not in self._spilled:
                # a free can race the writer's in-flight accounting
                # report: remember it so record_slab_objects completes
                # the delete instead of resurrecting the object. No
                # index probe here — frees of inline objects vastly
                # outnumber real races, and a per-free probe is raylet
                # CPU stolen from the data path on teardown bursts.
                self._pending_deletes[object_id] = None
                while len(self._pending_deletes) > 10_000:
                    self._pending_deletes.popitem(last=False)
        # No filesystem touch for oids the ledger doesn't know (the
        # common case: freed inline/slab objects have no .obj file, and
        # a stat costs microseconds under a virtualized kernel). The one
        # race — a fallback .obj write whose register_put is still in
        # flight — is closed in register_external via _pending_deletes.
        if known_file or not self.arena_enabled:
            try:
                os.unlink(_obj_path(self.store_dir, object_id))
            except FileNotFoundError:
                pass
        was_spilled = self._spilled.pop(object_id, None) is not None
        self._spilled_at.pop(object_id, None)
        if (was_spilled or object_id in self._ever_spilled) \
                and self._external is not None:
            self._ever_spilled.discard(object_id)
            try:
                self._external.delete(self._spill_key(object_id))
            except Exception:
                pass  # backend errors must not block the delete
        self._used -= size
        self._lru.pop(object_id, None)
        self._pinned.pop(object_id, None)

    def _ensure_space(self, size: int):
        with self._lock:
            self._ensure_space_locked(size)

    def _fits_locked(self, size: int) -> bool:
        return self._used + size <= self.capacity

    def _ensure_space_locked(self, size: int):
        if self._fits_locked(size):
            return
        # recycling pool first: pooled segments are instantly reclaimable
        self._drain_pool_locked(size)
        if self._fits_locked(size):
            return
        # SPILL-first when a spill target exists: nothing in this runtime
        # pins primary copies, and deleting the sole copy of a ray.put
        # object is unrecoverable data loss (puts have no lineage) — a
        # spilled object stays addressable and restores on access
        # (ray: local_object_manager.h:40).
        if self.spill_dir:
            for oid in list(self._lru.keys()):
                if self._fits_locked(size):
                    break
                self._spill_locked(oid)
            # then whole segments, coldest first; leased slabs are off
            # limits (their writers are mid-put in them)
            for seg in self._sealed_segments_lru_locked():
                if self._fits_locked(size):
                    break
                self._spill_segment_locked(seg)
        # No spill target (or spilling failed): LRU-evict unpinned.
        for oid in list(self._lru.keys()):
            if self._fits_locked(size):
                break
            if oid in self._pinned:
                continue
            self._delete_locked(oid)
        for seg in self._sealed_segments_lru_locked():
            if self._fits_locked(size):
                break
            if any(oid in self._pinned for oid in seg.live):
                continue
            for oid in list(seg.live):
                self._delete_locked(oid)
        # segments spilled/evicted above re-park in the pool with their
        # charge intact — drain again before declaring the store full
        self._drain_pool_locked(size)
        if not self._fits_locked(size):
            raise ObjectStoreFullError(
                f"object of size {size} does not fit: used={self._used} "
                f"capacity={self.capacity} (remaining objects pinned or "
                f"in leased slabs)"
            )

    def _drain_pool_locked(self, size: int):
        """Unlink pooled (all-dead, renamed) segments oldest-first until
        ``size`` fits; their retained charge comes off _used."""
        while self._pool and not self._fits_locked(size):
            path, (_fsize, charged) = self._pool.popitem(last=False)
            try:
                os.unlink(path)
            except OSError:
                pass
            self._used -= charged

    def _sealed_segments_lru_locked(self) -> List[_Segment]:
        return sorted(
            (s for s in self._segments.values() if s.leased_to is None),
            key=lambda s: s.last_access,
        )

    def used_bytes(self) -> int:
        return self._used

    def spilled_stats(self):
        with self._lock:
            return self._spilled_stats_locked()

    def _spilled_stats_locked(self):
        return {
            "spilled_objects": len(self._spilled),
            "spilled_bytes_total": self.spilled_bytes_total,
            "restored_bytes_total": self.restored_bytes_total,
            "overshoot_bytes_total": self.overshoot_bytes_total,
            "overshoot_by_cause": dict(self.overshoot_by_cause),
            "slab_segments": len(self._segments),
            "slab_objects": len(self._slab_objs),
        }

    def object_ids(self):
        with self._lock:
            return list(self._sizes.keys()) + list(self._slab_objs.keys()) \
                + list(self._spilled.keys())

    # -- hole-punch reclamation (arena-to-arena transfer plane) --------------
    def punch_supported(self) -> bool:
        """One-shot probe: can this store_dir's filesystem hole-punch?
        (tmpfs can since Linux 3.5; virtualized kernels may not)."""
        if self._punch_probe is None:
            probe = os.path.join(self.store_dir,
                                 f".punch_probe.{os.getpid()}")
            try:
                fd = os.open(probe, os.O_RDWR | os.O_CREAT, 0o600)
                try:
                    os.ftruncate(fd, slab_arena.PAGE * 2)
                    self._punch_probe = slab_arena.punch_range(
                        fd, 0, slab_arena.PAGE)
                finally:
                    os.close(fd)
                    os.unlink(probe)
            except OSError:
                self._punch_probe = False
        return bool(self._punch_probe)

    def punch_holes(self, min_fragmentation: Optional[float] = None,
                    min_bytes: Optional[int] = None) -> dict:
        """Reclaim physical pages from dead entry ranges inside LIVE
        segments via ``fallocate(PUNCH_HOLE | KEEP_SIZE)`` — memory
        comes back without waiting for whole-segment emptiness.

        Per candidate segment (sealed, fragmentation >= threshold, no
        in-flight reservations): drop our own cached read mapping, take
        a non-blocking EXCLUSIVE flock (readers hold SHARED flocks per
        cached mapping — a pinned segment is SKIPPED, because a reader's
        live view may alias entries deleted after the view was taken),
        write one covering DEAD tombstone per coalesced range (so scans
        hop the zeroed interior), punch the page-aligned interior
        (KEEP_SIZE: the file size and every future mapping stay intact),
        and retire the range from the dead-byte tallies. Runs on an
        executor thread off the raylet loop."""
        import fcntl

        out = {"punched_ranges": 0, "punched_bytes": 0,
               "dead_bytes_retired": 0, "skipped_pinned": 0,
               "segments": 0}
        if not self.arena_enabled or not self.punch_supported():
            return out
        min_frag = (cfg.slab_punch_min_fragmentation
                    if min_fragmentation is None else min_fragmentation)
        min_b = cfg.slab_punch_min_bytes if min_bytes is None else min_bytes
        with self._lock:
            candidates = []
            for seg in self._segments.values():
                if seg.leased_to is not None or seg.reserved:
                    continue  # a writer/assembly is mid-flight in it
                dead = sum(seg.dead.values())
                denom = seg.live_bytes + dead
                if dead >= min_b and denom and dead / denom >= min_frag:
                    candidates.append(seg.seg_id)
        t0 = time.perf_counter()
        broken = False
        for seg_id in candidates:
            if broken:
                break
            # our own reader cache holds a SHARED flock per cached
            # mapping: release ours first (outside the store lock; view
            # has its own) so the probe reports FOREIGN readers only. A
            # refusal means our own exported zero-copy views pin it.
            if not slab_arena.view(self.store_dir).drop_segment(seg_id):
                out["skipped_pinned"] += 1
                continue
            with self._lock:
                seg = self._segments.get(seg_id)
                if seg is None or seg.leased_to is not None or seg.reserved:
                    continue
                path = slab_arena.segment_path(self.store_dir, seg_id)
                try:
                    fd = os.open(path, os.O_RDWR)
                except OSError:
                    continue
                try:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    except OSError:
                        out["skipped_pinned"] += 1
                        continue
                    progressed = False
                    # coalesce over dead AND already-punched ranges: a
                    # sub-page range adjacent to a punched neighbor can
                    # only reclaim by merging across it (re-punching the
                    # neighbor's pages is a cheap no-op); ranges already
                    # punched in full are skipped outright
                    for off, length in memview.coalesce_ranges(
                            list(seg.dead.items())
                            + list(seg.punched.items())):
                        if seg.punched.get(off) == length:
                            continue  # fully punched already
                        span = slab_arena.punch_span(off, length)
                        if span is None:
                            continue  # sub-page: wait for a neighbor
                        if not slab_arena.write_dead_tombstone(
                                fd, off, length):
                            continue
                        if not slab_arena.punch_range(fd, *span):
                            broken = True  # unsupported/failed: stop pass
                            break
                        freed = 0
                        for o in [o for o in seg.dead
                                  if off <= o < off + length]:
                            freed += seg.dead.pop(o)
                        # merged-in previously-punched subranges: their
                        # pages are already holes — count only the NEW
                        # physical yield or repeated adjacent frees next
                        # to a big punched range inflate the counters
                        prev_phys = 0
                        for o in [o for o in seg.punched
                                  if off <= o < off + length]:
                            ps = slab_arena.punch_span(o,
                                                       seg.punched.pop(o))
                            if ps:
                                prev_phys += ps[1]
                        new_phys = max(0, span[1] - prev_phys)
                        self._slab_dead_bytes -= freed
                        self._slab_punched_bytes += freed
                        self._slab_punched_physical += new_phys
                        seg.punched[off] = length
                        out["punched_ranges"] += 1
                        out["punched_bytes"] += new_phys
                        out["dead_bytes_retired"] += freed
                        progressed = True
                    if progressed:
                        out["segments"] += 1
                finally:
                    os.close(fd)  # releases the probe flock
        if out["punched_ranges"]:
            mx = _mx()
            mx.punches.inc(out["punched_ranges"])
            mx.punched_bytes.inc(out["punched_bytes"])
            memview.record_flow("punch", out["dead_bytes_retired"],
                                time.perf_counter() - t0, "arena")
        return out

    # -- memory observatory (memview.py) -------------------------------------
    def arena_dead_bytes(self) -> int:
        return self._slab_dead_bytes

    def arena_live_bytes(self) -> int:
        return self._slab_live_bytes

    def arena_punched_bytes(self) -> int:
        """Cumulative dead bytes retired by the hole-punch pass."""
        return self._slab_punched_bytes

    def arena_fragmentation(self) -> float:
        """dead / (live + dead) resident slab bytes — the share a
        hole-punch pass could reclaim from live segments."""
        total = self._slab_dead_bytes + self._slab_live_bytes
        return self._slab_dead_bytes / total if total else 0.0

    def pool_pinned(self, max_age_s: float = 0.0) -> List[dict]:
        """Recycling-pool segments a reader's SHARED flock keeps alive
        (an EXCLUSIVE non-blocking probe fails): previously invisible —
        a stuck zero-copy view pinned pages forever with nothing to
        blame. Reports the pinning pid(s) from /proc/locks.

        The probe runs UNDER the store lock so it serializes with
        ``_reuse_pooled_locked``'s identical EX probe — two transient
        exclusive locks racing would make the recycler skip a reusable
        segment and this report name the raylet's own pid as a phantom
        pinner. ``max_age_s`` serves a recent cached result instead of
        re-probing (the per-scrape gauge path; introspection and tests
        pass 0 for ground truth)."""
        import fcntl

        if max_age_s > 0.0:
            ts, cached = self._pool_pinned_cache
            if time.monotonic() - ts < max_age_s:
                return cached
        # our own reader cache legitimately holds SHARED flocks of
        # pooled (path-vanished) segments: release those first so the
        # probe reports FOREIGN pins, not our own cache. Outside the
        # store lock (the view has its own; lock order store->view is
        # the established one — see _reuse_pooled_locked).
        slab_arena.view(self.store_dir).sweep()
        out: List[dict] = []
        with self._lock:
            for path, (fsize, charged) in list(self._pool.items()):
                try:
                    fd = os.open(path, os.O_RDWR)
                except OSError:
                    continue  # drained/reused concurrently
                try:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        fcntl.flock(fd, fcntl.LOCK_UN)
                    except OSError:
                        out.append({
                            "file": os.path.basename(path),
                            "file_size": fsize,
                            "charged": charged,
                            "holder_pids": memview.flock_holders(path),
                        })
                finally:
                    os.close(fd)
        self._pool_pinned_cache = (time.monotonic(), out)
        return out

    def arena_introspect(self) -> dict:
        """Owner-side arena summary: per-segment occupancy with live vs
        dead entry counts and coalesced **dead byte ranges** (the input
        a ``fallocate(PUNCH_HOLE)`` reclamation pass would punch),
        recycling-pool and leased-vs-sealed stats, per-client slab
        charge, and the spill/overshoot tallies — the ``arena`` block of
        this node's memview snapshot."""
        now = time.monotonic()
        with self._lock:
            segs = []
            per_client: Dict[str, int] = {}
            for seg in sorted(self._segments.values(),
                              key=lambda s: s.seg_id):
                dead_bytes = sum(seg.dead.values())
                denom = seg.live_bytes + dead_bytes
                segs.append({
                    "seg_id": seg.seg_id,
                    "size": seg.size,
                    "leased_to": seg.leased_to,
                    "writer": seg.writer,
                    "live_entries": len(seg.live),
                    "dead_entries": len(seg.dead),
                    "live_bytes": seg.live_bytes,
                    "dead_bytes": dead_bytes,
                    "dead_ranges": memview.coalesce_ranges(
                        seg.dead.items()),
                    "fragmentation": dead_bytes / denom if denom else 0.0,
                    "idle_s": round(now - seg.last_access, 3),
                    "reserved": seg.reserved,
                    "punched_bytes": sum(seg.punched.values()),
                })
                charge_to = seg.leased_to or seg.writer or "_unknown"
                per_client[charge_to] = \
                    per_client.get(charge_to, 0) + seg.size
            pool = [{"file": os.path.basename(p), "file_size": f,
                     "charged": c} for p, (f, c) in self._pool.items()]
            out = {
                "capacity": self.capacity,
                "used": self._used,
                "live_bytes": self._slab_live_bytes,
                "dead_bytes": self._slab_dead_bytes,
                "punched_bytes": self._slab_punched_bytes,
                "punched_physical_bytes": self._slab_punched_physical,
                "fragmentation": self.arena_fragmentation(),
                "segments": segs,
                "leased_segments": sum(
                    1 for s in self._segments.values() if s.leased_to),
                "sealed_segments": sum(
                    1 for s in self._segments.values() if not s.leased_to),
                "pool": pool,
                "pool_bytes": sum(c for _f, c in self._pool.values()),
                "per_client_bytes": per_client,
                "file_objects": len(self._sizes),
                "file_bytes": sum(self._sizes.values()),
                "pinned_objects": len(self._pinned),
                "spilled": self._spilled_stats_locked(),
            }
        out["pool_pinned"] = self.pool_pinned()  # probes flocks: no lock
        return out

    def memview_objects(self, limit: int = 10_000) -> List[dict]:
        """Per-object lifecycle rows from this store's ledger: state
        (arena / external one-file / spilled), size, backing segment,
        pin count, owner (the segment's writing client), and age."""
        from itertools import islice

        now = time.monotonic()
        rows: List[dict] = []
        with self._lock:
            for oid, ent in islice(self._slab_objs.items(), limit):
                seg_id, off, total = ent[:3]
                ts = ent[3] if len(ent) > 3 else None
                seg = self._segments.get(seg_id)
                row = {
                    "object_id": oid.hex(),
                    "state": "arena",
                    "size": total,
                    "seg": seg_id,
                    "off": off,
                    "pins": self._pinned.get(oid, 0),
                    "owner": seg.writer if seg is not None else None,
                    "age_s": round(now - ts, 3) if ts is not None else None,
                }
                # ledger-persisted creation callsite (rode the owner's
                # slab report): survives the owner's death, so a leak
                # verdict still names the line that made the object
                if len(ent) > 4 and ent[4]:
                    row["callsite"] = ent[4]
                rows.append(row)
            room = max(0, limit - len(rows))
            for oid, size in islice(self._sizes.items(), room):
                ts = self._lru.get(oid)
                rows.append({
                    "object_id": oid.hex(),
                    "state": "external",
                    "size": size,
                    "pins": self._pinned.get(oid, 0),
                    # time-since-last-touch is a FLOOR on age: enough
                    # for the leak verdicts' in-flight-report gate (a
                    # just-registered object reads young)
                    "age_s": round(now - ts, 3) if ts is not None
                    else None,
                    "idle_s": round(now - ts, 3) if ts is not None
                    else None,
                })
            room = max(0, limit - len(rows))
            for oid, size in islice(self._spilled.items(), room):
                ts = self._spilled_at.get(oid)
                rows.append({
                    "object_id": oid.hex(),
                    "state": "spilled",
                    "size": size,
                    "pins": self._pinned.get(oid, 0),
                    "age_s": round(now - ts, 3) if ts is not None
                    else None,
                })
        return rows
