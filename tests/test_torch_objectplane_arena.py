"""The port's counterpart of ``tests/test_objectplane_arena.py`` (18 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name. The port's spill staging dirs are
``rtpu_torch_spill_stage_<host>_<pid>`` where the reference's are
``rtpu_spill_stage_<host>_<pid>``: a difference on purpose, so that two
packages' stores on one host and one spill mount never sweep each other's
staging (``test_port_store_leaves_the_references_spill_staging``);
``test_stale_spill_staging_swept_on_startup`` checks the port's prefix.

The reference's description:

Slab-arena object plane: concurrency, crash safety, zero-copy, and the
accounting satellites.

The arena (slab_arena.py + object_store.py) replaces one-file-per-object
with leased write slabs + a shared-memory index. These tests pin its
contracts: seal atomicity under kill -9 (torn tails discarded by rescan,
sealed entries survive), flock-free zero-copy reads that alias the arena
mapping, N writers x M readers x evictor consistency across processes,
and the bounded-negative-cache / overshoot-metric / fd-leak satellites.
"""

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import object_store, slab_arena
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore

from tests.torch_fixtures import port_regular, port_regular_fn  # noqa: F401

pytestmark = pytest.mark.objectplane


def _payload_for(oid: ObjectID, size: int) -> bytes:
    # content derivable from the id: any torn/mixed read is detectable
    rep = (size + 27) // 28
    return (oid.binary() * rep)[:size]


# ----------------------------------------------------------------------
# zero-copy invariant (acceptance criterion)
# ----------------------------------------------------------------------

def test_slab_get_returns_view_aliasing_arena(port_regular):
    """A slab-backed get must hand back memory that IS the arena mapping
    (no intermediate bytes copy), the way test_rpcio_framing asserts the
    v2 frame path: np.shares_memory against the segment mmap."""
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    assert cw.arena_enabled, "slab arena must be the default data path"
    arr = np.arange(1 << 20, dtype=np.uint8)
    ref = ray_tpu_torch.put(arr)
    got = ray_tpu_torch.get(ref, timeout=60)
    np.testing.assert_array_equal(got, arr)
    buf = cw._pinned_buffers.get(ref.binary())
    assert buf is not None and buf.seg_id is not None, \
        "1MB put must be slab-backed, not a fallback file"
    mm, _size = slab_arena.view(cw.store_dir).segment(buf.seg_id)
    base = np.frombuffer(memoryview(mm), dtype=np.uint8)
    assert np.shares_memory(base, got), \
        "get() result must alias the arena segment mapping (zero-copy)"
    del got, base, buf


def test_many_sibling_puts_all_resolvable(port_regular):
    """One driver's puts share a 24-byte task-id prefix; the shared
    index must hash ALL id bytes or sibling #129+ saturates one probe
    window and becomes unreachable (reported lost -> data loss)."""
    refs = [ray_tpu_torch.put(np.full(120_000, i % 251, dtype=np.uint8))
            for i in range(140)]
    for i, r in enumerate(refs):
        v = ray_tpu_torch.get(r, timeout=60)
        assert int(v[0]) == i % 251, i


def test_index_sibling_prefix_no_probe_saturation(tmp_path):
    idx = slab_arena.SharedIndex(str(tmp_path / "idx.shm"),
                                 slots=1 << 12, create=True)
    prefix = b"T" * 24  # same producing task
    oids = [prefix + i.to_bytes(4, "little") for i in range(300)]
    for i, oid in enumerate(oids):
        assert idx.insert(oid, 0, i * 64), f"insert {i} failed"
    for i, oid in enumerate(oids):
        assert idx.lookup(oid) == (0, i * 64), f"lookup {i} failed"


def test_small_values_stay_inline(port_regular):
    # the arena only serves > inline-threshold objects; tiny puts must
    # keep the memory-store fast path (no slab, no file)
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    ref = ray_tpu_torch.put(b"tiny")
    assert ref.binary() in cw._memory_store
    assert ray_tpu_torch.get(ref, timeout=30) == b"tiny"


# ----------------------------------------------------------------------
# crash safety: kill -9 mid-put -> rescan stays consistent
# ----------------------------------------------------------------------

def _writer_then_die(store_dir, seg_id, size, oids, torn_oid):
    """Child: seal len(oids) objects, start one more put, die mid-write."""
    w = slab_arena.SlabWriter(store_dir)
    w.attach(seg_id, size)
    for oid_b in oids:
        oid = ObjectID(oid_b)
        p = _payload_for(oid, 32 * 1024)
        assert w.try_put(oid_b, b"meta", [p], len(p)) is not None
    # torn entry: header + partial payload, NO seal (state word unwritten)
    off = w._off
    mv = w._mv
    oid = ObjectID(torn_oid)
    p = _payload_for(oid, 32 * 1024)
    hdr = slab_arena._pack_header(torn_oid, 4, len(p))
    mv[off + 8 : off + slab_arena.HDR] = hdr[: slab_arena.HDR - 8]
    mv[off + slab_arena.HDR : off + slab_arena.HDR + len(p) // 2] = \
        p[: len(p) // 2]
    os.kill(os.getpid(), signal.SIGKILL)


def test_kill9_midput_rescan_discards_torn_entry(tmp_path):
    store_dir = str(tmp_path / "store")
    os.makedirs(store_dir)
    idx = slab_arena.SharedIndex(slab_arena.index_path(store_dir),
                                 slots=4096, create=True)
    idx.close()
    slab_arena.create_segment(store_dir, 0, 4 * 1024 * 1024)
    oids = [ObjectID.from_random().binary() for _ in range(3)]
    torn = ObjectID.from_random().binary()
    ctx = multiprocessing.get_context("fork")
    proc = ctx.Process(target=_writer_then_die,
                       args=(store_dir, 0, 4 * 1024 * 1024, oids, torn))
    proc.start()
    proc.join(30)
    assert proc.exitcode == -signal.SIGKILL

    # restart rescan: sealed entries adopted, torn tail discarded
    store = LocalObjectStore(store_dir, 64 * 1024 * 1024)
    for oid_b in oids:
        oid = ObjectID(oid_b)
        assert store.contains(oid)
        buf = store.get(oid)
        assert buf is not None
        assert bytes(buf.data) == _payload_for(oid, 32 * 1024)
        buf.release()
    assert not store.contains(ObjectID(torn))
    assert store.get(ObjectID(torn)) is None
    # the store is not wedged: new puts and deletes work
    extra = ObjectID.from_random()
    store.put(extra, b"", [b"after-crash"], 11)
    assert bytes(store.get(extra).data) == b"after-crash"
    for oid_b in oids:
        store.delete(ObjectID(oid_b))
    assert not store.contains(ObjectID(oids[0]))


@pytest.mark.chaos
def test_kill9_actor_midstream_objects_survive(port_regular_fn):
    """Cluster chaos lane: SIGKILL a worker that sealed objects into its
    leased slab — the raylet reclaims the slab (scan adopts sealed
    entries, torn tail dropped) and the objects stay readable."""

    @ray_tpu_torch.remote(max_restarts=1)
    class Producer:
        def make(self, n):
            return [ray_tpu_torch.put(np.full(150_000, i, dtype=np.uint8))
                    for i in range(n)]

        def pid(self):
            return os.getpid()

    a = Producer.remote()
    refs = ray_tpu_torch.get(a.make.remote(4), timeout=120)
    pid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
    # sealed before the kill: readable now...
    first = ray_tpu_torch.get(refs[0], timeout=60)
    assert int(first[0]) == 0
    os.kill(pid, signal.SIGKILL)
    time.sleep(2.0)  # raylet notices the death and reclaims the slabs
    # ...and still readable after the writer is gone (reclaimed slab)
    for i, r in enumerate(refs):
        v = ray_tpu_torch.get(r, timeout=120)
        assert v.shape == (150_000,) and int(v[0]) == i


# ----------------------------------------------------------------------
# concurrent arena use: N writers x M readers x evictor
# ----------------------------------------------------------------------

def _stress_writer(store_dir, seg_id, size, oid_list, obj_size, done_q):
    w = slab_arena.SlabWriter(store_dir)
    w.attach(seg_id, size)
    for oid_b in oid_list:
        p = _payload_for(ObjectID(oid_b), obj_size)
        ent = w.try_put(oid_b, b"m", [p], len(p))
        assert ent is not None
        done_q.put(oid_b)
    done_q.put(None)


def _stress_reader(store_dir, all_oids, obj_size, stop_ev, err_q):
    import random

    rnd = random.Random(os.getpid())
    checks = 0
    while not stop_ev.is_set() or checks == 0:
        oid_b = rnd.choice(all_oids)
        buf = object_store.read_object(store_dir, ObjectID(oid_b))
        if buf is not None:
            data = bytes(buf.data)
            expect = _payload_for(ObjectID(oid_b), obj_size)
            if data != expect:
                err_q.put(f"corrupt read for {oid_b.hex()[:12]}")
                return
            buf.release()
        checks += 1
    err_q.put(None)


def test_concurrent_writers_readers_evictor(tmp_path):
    """3 writer processes bump-allocating into their own leased slabs,
    2 reader processes resolving through the shared index, and an
    evictor discarding random sealed entries — every read must be
    either a miss or the exact payload (the seal flip + oid/crc
    validation make torn or recycled reads impossible)."""
    store_dir = str(tmp_path / "store")
    os.makedirs(store_dir)
    idx = slab_arena.SharedIndex(slab_arena.index_path(store_dir),
                                 slots=1 << 12, create=True)
    idx.close()
    obj_size = 24 * 1024
    per_writer = 30
    ctx = multiprocessing.get_context("fork")
    writers = []
    all_oids = []
    done_q = ctx.Queue()
    for wi in range(3):
        oids = [ObjectID.from_random().binary() for _ in range(per_writer)]
        all_oids.extend(oids)
        seg_size = slab_arena.entry_size(1, obj_size) * (per_writer + 2)
        slab_arena.create_segment(store_dir, wi, seg_size)
        writers.append(ctx.Process(
            target=_stress_writer,
            args=(store_dir, wi, seg_size, oids, obj_size, done_q),
        ))
    stop_ev = ctx.Event()
    err_q = ctx.Queue()
    readers = [
        ctx.Process(target=_stress_reader,
                    args=(store_dir, all_oids, obj_size, stop_ev, err_q))
        for _ in range(2)
    ]
    for p in writers + readers:
        p.start()
    # evictor: discard sealed objects as they appear (forward progress
    # guaranteed by draining the done queue)
    sealed, done_writers = [], 0
    import random

    rnd = random.Random(7)
    while done_writers < len(writers):
        item = done_q.get(timeout=60)
        if item is None:
            done_writers += 1
            continue
        sealed.append(item)
        if len(sealed) % 5 == 0:
            victim = rnd.choice(sealed)
            object_store.discard_local(store_dir, ObjectID(victim))
    for p in writers:
        p.join(60)
        assert p.exitcode == 0
    stop_ev.set()
    for p in readers:
        p.join(60)
    errs = [err_q.get(timeout=10) for _ in readers]
    assert all(e is None for e in errs), errs
    # rescan adopts the survivors without corruption
    store = LocalObjectStore(store_dir, 1 << 30)
    alive = sum(bool(store.contains(ObjectID(o))) for o in all_oids)
    assert alive >= 1
    for oid_b in all_oids:
        buf = store.get(ObjectID(oid_b))
        if buf is not None:
            assert bytes(buf.data) == _payload_for(ObjectID(oid_b), obj_size)
            buf.release()


# ----------------------------------------------------------------------
# satellites: bounded negative cache, overshoot metric, fd-leak finalize
# ----------------------------------------------------------------------

def test_probe_missed_bounded_fifo_eviction(tmp_path, monkeypatch):
    """Overflowing the external-probe negative cache evicts the OLDEST
    entries instead of clearing the whole cache (which re-enabled
    unbounded backend probes for every known-miss id)."""
    monkeypatch.setattr(object_store, "_PROBE_MISSED_MAX", 8)
    store = LocalObjectStore(str(tmp_path / "shm"), 1 << 20,
                             f"{tmp_path}/spill")

    class _Backend:
        calls = 0

        def exists(self, key):
            self.calls += 1
            return False

        def spill(self, key, path):
            pass

        def restore(self, key, path):
            return False

        def delete(self, key):
            pass

    store._external = _Backend()
    oids = [ObjectID(bytes([i]) * 28) for i in range(12)]
    for oid in oids:
        store.contains(oid)
    assert len(store._probe_missed) == 8
    # newest survive, oldest evicted (FIFO), never a wholesale clear
    assert oids[-1] in store._probe_missed
    assert oids[0] not in store._probe_missed
    calls_before = store._external.calls
    store.contains(oids[-1])  # cached miss: no new probe
    assert store._external.calls == calls_before


def test_register_external_overshoot_metric(tmp_path):
    """Capacity overshoot from already-written external objects is
    counted (object_store_overshoot_bytes_total) and surfaced in
    spilled_stats instead of silently swallowed."""
    store = LocalObjectStore(str(tmp_path / "shm"), capacity_bytes=4096)
    payload = b"z" * 8192
    oid = ObjectID.from_random()
    # a worker wrote directly (no lease): file exceeds capacity
    object_store.write_object(str(tmp_path / "shm"), oid, b"", [payload],
                              len(payload))
    store.register_external(oid)
    stats = store.spilled_stats()
    assert stats["overshoot_bytes_total"] > 0
    assert store.contains(oid)  # still tracked honestly


def test_release_fd_closed_when_last_view_dies(tmp_path):
    """ObjectBuffer.release with live exported views must not leak the
    flock fd forever: the finalize on the mapping closes the file when
    the last view dies."""
    import gc

    store_dir = str(tmp_path / "shm")
    os.makedirs(store_dir)
    oid = ObjectID.from_random()
    object_store.write_object(store_dir, oid, b"", [b"q" * 4096], 4096)
    buf = object_store.read_object(store_dir, oid)
    assert buf._file is not None  # file-backed (no index here)
    f = buf._file
    view = buf.data[:16]  # exported slice keeps the mapping alive
    buf.release()  # BufferError path: mmap stays, fd must not leak
    assert not f.closed
    del buf, view
    gc.collect()
    assert f.closed, "finalize must close the flock fd with the mapping"


def test_lease_denied_when_capacity_exhausted(tmp_path):
    store = LocalObjectStore(str(tmp_path / "shm"), capacity_bytes=64 * 1024)
    r = store.lease_slab("w1", 32 * 1024)
    assert r["ok"]
    # everything else is leased out: an oversized lease is denied, the
    # writer falls back to the one-file path (overshoot-accounted)
    r2 = store.lease_slab("w2", 1 << 20)
    assert not r2["ok"]


def test_eviction_repooled_segments_still_free_space(tmp_path):
    """Segments evicted during _ensure_space re-park in the recycling
    pool with their charge intact — the final capacity check must drain
    the pool again instead of raising with reclaimable bytes in hand."""
    store = LocalObjectStore(str(tmp_path / "s"), capacity_bytes=8 << 20)
    for _ in range(2):
        oid = ObjectID.from_random()
        store.put(oid, b"", [b"a" * (2 << 20)], 2 << 20)
    big = ObjectID.from_random()
    store.put(big, b"", [b"z" * (5 << 20)], 5 << 20)  # must not raise
    assert store.contains(big)
    assert store.used_bytes() <= 8 << 20


def test_batched_accounting_and_pending_delete(tmp_path):
    """A free racing the writer's in-flight accounting report must win:
    the late report completes the delete instead of resurrecting the
    object."""
    store_dir = str(tmp_path / "shm")
    store = LocalObjectStore(store_dir, 1 << 22)
    r = store.lease_slab("w1", 1 << 20)
    w = slab_arena.SlabWriter(store_dir)
    w.attach(r["seg_id"], r["size"])
    oid = ObjectID.from_random()
    p = _payload_for(oid, 4096)
    ent = w.try_put(oid.binary(), b"", [p], len(p))
    # the free arrives BEFORE the accounting report
    store.delete(oid)
    store.record_slab_objects([ent])
    assert not store.contains(oid)
    assert store.get(oid) is None


def test_worker_death_reclaims_unreported_objects(tmp_path):
    """reclaim_client_slabs adopts sealed-but-unreported entries (lost
    notify / dead worker) and returns them for location registration."""
    store_dir = str(tmp_path / "shm")
    store = LocalObjectStore(store_dir, 1 << 22)
    r = store.lease_slab("w1", 1 << 20)
    w = slab_arena.SlabWriter(store_dir)
    w.attach(r["seg_id"], r["size"])
    oid = ObjectID.from_random()
    p = _payload_for(oid, 8192)
    assert w.try_put(oid.binary(), b"", [p], len(p)) is not None
    # no report ever sent; the client dies
    new = store.reclaim_client_slabs("w1")
    assert oid.binary() in new
    assert store.contains(oid)
    buf = store.get(oid)
    assert bytes(buf.data) == p


# ----------------------------------------------------------------------
# partial pwrite, serialized local refill, spill staging
# ----------------------------------------------------------------------

def test_write_entry_partial_pwrite_loops_to_completion(tmp_path, monkeypatch):
    """Linux caps one pwrite at ~2GiB and partial writes are legal in
    general; write_entry must loop to completion, or a bulk put seals
    with data_len covering a zero-filled tail (header CRC does not
    cover data)."""
    real_pwrite = os.pwrite
    calls = []

    def short_pwrite(fd, buf, pos):
        mv = memoryview(buf)[: 64 * 1024]  # kernel-style short write
        calls.append(mv.nbytes)
        return real_pwrite(fd, mv, pos)

    monkeypatch.setattr(os, "pwrite", short_pwrite)
    store_dir = str(tmp_path / "shm")
    store = LocalObjectStore(store_dir, 1 << 22)
    r = store.lease_slab("w1", 1 << 21)
    w = slab_arena.SlabWriter(store_dir)
    w.attach(r["seg_id"], r["size"])
    oid = ObjectID.from_random()
    payload = _payload_for(oid, slab_arena.PWRITE_MIN + 12_345)
    ent = w.try_put(oid.binary(), b"", [payload], len(payload))
    assert ent is not None
    assert len(calls) > 1, "short pwrite was not retried"
    store.record_slab_objects([ent])
    buf = store.get(oid)
    assert bytes(buf.data) == payload, "tail lost to a short pwrite"
    buf.release()
    w.close()


def test_local_put_failed_retry_raises_not_typeerror(tmp_path, monkeypatch):
    """If the post-attach retry of the raylet-local put still cannot
    place the entry, put must raise ObjectStoreFullError explicitly —
    not hand None to record_slab_objects (TypeError)."""
    store = LocalObjectStore(str(tmp_path / "shm"), 1 << 22)
    monkeypatch.setattr(store._local_writer, "try_put",
                        lambda *a, **k: None)
    with pytest.raises(object_store.ObjectStoreFullError):
        store.put(ObjectID.from_random(), b"", [b"x" * 4096], 4096)


def test_spill_staging_root_prefers_spill_filesystem(tmp_path):
    """Over-capacity spilling must not stage the .obj copy on tmpfs
    (/tmp is tmpfs on many hosts — doubling RAM use while reclaiming
    RAM): with a local spill backend the staging root is the spill
    destination's own filesystem."""
    spill = str(tmp_path / "spill")
    store = LocalObjectStore(str(tmp_path / "shm"), 4 << 20, spill)
    assert store._spill_staging_root == spill
    # force slab objects out: capacity pressure spills to the backend
    oids = [ObjectID.from_random() for _ in range(4)]
    for oid in oids:
        store.put(oid, b"", [_payload_for(oid, 1 << 20)], 1 << 20)
    big = ObjectID.from_random()
    store.put(big, b"", [_payload_for(big, 3 << 20)], 3 << 20)
    stats = store.spilled_stats()
    assert stats["spilled_objects"] >= 1
    # staged copies are cleaned up after the backend takes them
    stage = os.path.join(spill, store._staging_dir_name())
    assert not os.path.exists(stage) or not os.listdir(stage)


def test_stale_spill_staging_swept_on_startup(tmp_path):
    """rtpu_torch_spill_stage_* dirs stranded by a raylet killed mid-spill are
    removed when the next store starts on the same staging root."""
    spill = str(tmp_path / "spill")
    os.makedirs(spill)
    child = multiprocessing.Process(target=lambda: None)
    child.start()
    child.join()
    host = os.uname().nodename
    stale = os.path.join(spill, f"rtpu_torch_spill_stage_{host}_{child.pid}")
    os.makedirs(stale)
    with open(os.path.join(stale, "orphan.obj"), "wb") as f:
        f.write(b"x" * 128)
    # another HOST's staging on a shared spill mount: pid space is
    # opaque there, so it must never be swept from here
    foreign = os.path.join(spill,
                           f"rtpu_torch_spill_stage_otherhost_{child.pid}")
    os.makedirs(foreign)
    LocalObjectStore(str(tmp_path / "shm"), 1 << 20, spill)
    assert not os.path.exists(stale)
    assert os.path.exists(foreign)


def test_port_store_leaves_the_references_spill_staging(tmp_path):
    """The two packages' stores may share a host and a spill mount: each
    sweeps only its own staging prefix, so a stale reference staging dir
    (``rtpu_spill_stage_``) outlives the port's store, and the port's
    (``rtpu_torch_spill_stage_``) outlives the reference's."""
    from ray_tpu._private.object_store import LocalObjectStore as RefStore

    spill = str(tmp_path / "spill")
    os.makedirs(spill)
    child = multiprocessing.Process(target=lambda: None)
    child.start()
    child.join()
    host = os.uname().nodename
    theirs = os.path.join(spill, f"rtpu_spill_stage_{host}_{child.pid}")
    mine = os.path.join(spill, f"rtpu_torch_spill_stage_{host}_{child.pid}")
    os.makedirs(theirs)
    LocalObjectStore(str(tmp_path / "shm"), 1 << 20, spill)
    assert os.path.exists(theirs)
    os.makedirs(mine)
    RefStore(str(tmp_path / "shm_ref"), 1 << 20, spill)
    assert os.path.exists(mine) and not os.path.exists(theirs)
