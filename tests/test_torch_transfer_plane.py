"""The port's counterpart of ``tests/test_transfer_plane.py`` (15 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name; a call site names this file.

The reference's description:

Arena-to-arena transfer plane: receive-side slab assembly, pipelined
fetch, and hole-punch reclamation.

Cross-node object movement lands directly in arena memory: the raylet
reserves an UNSEALED slab entry when a transfer's size is known, chunks
pwrite straight into the segment at their offsets (out-of-order safe),
and the atomic state-word seal fires only when every byte has arrived —
a receiver killed mid-transfer leaves exactly the torn tail the crash
rescan already discards. A periodic pass hole-punches the page-aligned
interior of dead entry ranges (fallocate PUNCH_HOLE|KEEP_SIZE) so
long-lived, partially-dead segments return memory without waiting for
whole-segment emptiness — live zero-copy readers keep their views
because KEEP_SIZE preserves the mapping, and flock-pinned segments are
skipped entirely.
"""

import multiprocessing
import os
import shutil
import signal
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import memview, object_store, slab_arena
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore

pytestmark = pytest.mark.objectplane


# ----------------------------------------------------------------------
# punch page-alignment math (pure)
# ----------------------------------------------------------------------

def test_punch_span_preserves_header_and_page_aligns():
    page = slab_arena.PAGE
    # a multi-page range starting at 0: the header's page survives
    span = slab_arena.punch_span(0, page * 3, page=page)
    assert span == (page, page * 2)
    # header bytes never inside the hole: start >= off + HDR, page-aligned
    for off in (0, 64, page - 64, page, page * 2 + 192):
        for length in (page, page * 2, page * 4 + 128, 64, 128):
            span = slab_arena.punch_span(off, length, page=page)
            if span is None:
                continue
            start, nbytes = span
            assert start % page == 0 and nbytes % page == 0
            assert start >= off + slab_arena.HDR
            assert start + nbytes <= off + length
    # sub-page ranges punch nothing
    assert slab_arena.punch_span(100, 200) is None
    assert slab_arena.punch_span(0, slab_arena.PAGE) is None or \
        slab_arena.punch_span(0, slab_arena.PAGE)[1] == 0


def test_dead_tombstone_covers_whole_range(tmp_path):
    """The covering DEAD tombstone written before a punch makes the scan
    hop the zeroed interior in ONE step — sealed entries BEHIND a
    punched range must stay reachable."""
    store_dir = str(tmp_path)
    seg_path = slab_arena.create_segment(store_dir, 0, 1 << 20)
    fd = os.open(seg_path, os.O_RDWR)
    try:
        import mmap as _mmap

        with open(seg_path, "r+b") as f:
            mm = _mmap.mmap(f.fileno(), 0)
            mv = memoryview(mm)
            oid_a, oid_b = os.urandom(28), os.urandom(28)
            total_a = slab_arena.write_entry(mv, 0, oid_a, b"", [b"x" * 300])
            total_b = slab_arena.write_entry(mv, total_a, oid_b, b"",
                                             [b"y" * 300])
            mv.release()
            mm.close()
        # tombstone entry A's range as one covering DEAD header, then
        # zero its interior the way a punch would
        assert slab_arena.write_dead_tombstone(fd, 0, total_a)
        entries = list(slab_arena.scan_segment(seg_path))
        assert [(e[0], e[5]) for e in entries] == [
            (b"\0" * 28, True), (oid_b, False)
        ], "scan must hop the tombstone and still reach the live entry"
    finally:
        os.close(fd)


# ----------------------------------------------------------------------
# receive-side slab reservations (store level)
# ----------------------------------------------------------------------

@pytest.fixture
def store(tmp_path):
    st = LocalObjectStore(str(tmp_path / "store"), 128 << 20)
    yield st


def test_reservation_out_of_order_writes_then_seal(store):
    """The fetch pipeline lands chunks out of order at their offsets;
    the entry must read back exact after the seal and be INVISIBLE
    before it (the seal is the only publication)."""
    oid = ObjectID(os.urandom(28))
    payload = np.arange(3 << 20, dtype=np.uint8).tobytes()
    res = store.reserve(oid, b"meta!", len(payload))
    assert res is not None
    chunk = 1 << 20
    for off in (2 << 20, 0, 1 << 20):  # out of order
        res.write(off, payload[off:off + chunk])
    assert not store.contains(oid), "unsealed entry must be invisible"
    assert res.seal()
    assert store.contains(oid)
    buf = store.get(oid)
    assert buf.metadata == b"meta!" and bytes(buf.data) == payload
    assert buf.seg_id is not None, "assembled object must be slab-backed"
    buf.release()


def test_reservation_write_bounds_checked(store):
    res = store.reserve(ObjectID(os.urandom(28)), b"", 1024)
    assert res is not None
    with pytest.raises(ValueError):
        res.write(1000, b"x" * 100)  # would overflow the reserved region
    res.abandon()


def test_reservation_abandon_goes_dead_and_scan_hops_it(store):
    """An abandoned session's reservation is tombstoned DEAD (satellite:
    no leaked unsealed entries eroding capacity) and later sealed
    entries in the same segment stay reachable across a rescan."""
    dead0 = store.arena_dead_bytes()
    oid = ObjectID(os.urandom(28))
    res = store.reserve(oid, b"m", 1 << 20)
    res.write(0, b"z" * 1000)  # partial
    res.abandon()
    assert store.arena_dead_bytes() >= dead0 + (1 << 20)
    assert not store.contains(oid)
    # a later put in the same segment...
    oid2 = ObjectID(os.urandom(28))
    store.put(oid2, b"", [b"q" * 500_000], 500_000)
    assert store._slab_objs[oid2][0] == res.seg_id, \
        "put should land in the same (still leased) segment"
    # ...survives a restart rescan (the tombstone is traversable)
    st2 = LocalObjectStore(store.store_dir, 128 << 20)
    buf = st2.get(oid2)
    assert buf is not None and bytes(buf.data[:3]) == b"qqq"


def test_duplicate_seal_loser_goes_dead(store):
    """Two concurrent sessions assembling the SAME object (e.g. two
    senders pushing it): the first seal wins the ledger; the loser's
    sealed bytes must flip DEAD (reclaimable), not leak as an
    unreachable sealed entry until the segment dies."""
    oid = ObjectID(os.urandom(28))
    payload = b"r" * 500_000
    res_a = store.reserve(oid, b"", len(payload))
    res_b = store.reserve(oid, b"", len(payload))
    assert res_a is not None and res_b is not None
    res_a.write(0, payload)
    res_b.write(0, payload)
    assert res_a.seal()
    dead0 = store.arena_dead_bytes()
    assert not res_b.seal(), "second seal must not claim the ledger"
    assert store.arena_dead_bytes() >= dead0 + len(payload)
    assert store._slab_objs[oid][:2] == (res_a.seg_id, res_a.off)
    buf = store.get(oid)
    assert buf is not None and bytes(buf.data) == payload


def test_reservation_keeps_segment_alive(store):
    """A segment holding only an in-flight reservation must not be
    unlinked by the seal path — the assembly is pwriting into it."""
    big = 7 << 20  # most of an 8MB (capacity//8... cap'd) local slab
    oid = ObjectID(os.urandom(28))
    res = store.reserve(oid, b"", big)
    # force a seal/lease cycle: a put too big for the current slab
    oid2 = ObjectID(os.urandom(28))
    store.put(oid2, b"", [b"w" * (2 << 20)], 2 << 20)
    seg = store._segments.get(res.seg_id)
    assert seg is not None and seg.reserved == 1, \
        "reserved segment must survive the seal with its file intact"
    assert os.path.exists(
        slab_arena.segment_path(store.store_dir, res.seg_id))
    res.write(0, np.full(big, 3, np.uint8))
    assert res.seal()
    buf = store.get(oid)
    assert buf is not None and buf.data.nbytes == big
    assert store._segments[res.seg_id].reserved == 0


# ----------------------------------------------------------------------
# hole-punch reclamation (store level)
# ----------------------------------------------------------------------

def _fill_segments(store, n=40, size=1 << 20):
    oids = [ObjectID(os.urandom(28)) for _ in range(n)]
    for o in oids:
        store.put(o, b"", [np.full(size, 9, np.uint8)], size)
    by_seg = {}
    for o in oids:
        by_seg.setdefault(store._slab_objs[o][0], []).append(o)
    return by_seg


def _punch_supported() -> bool:
    """Whether this filesystem can punch holes, probed by a store in a
    directory of its own (the reference's tests probe
    /tmp/_punch_probe_dir, maybe at the same time), removed after."""
    d = tempfile.mkdtemp(prefix="torch_punch_probe_")
    try:
        return LocalObjectStore(d, 1 << 20).punch_supported()
    finally:
        shutil.rmtree(d, ignore_errors=True)


_PUNCH_SUPPORTED = _punch_supported()


@pytest.mark.skipif(not _PUNCH_SUPPORTED, reason="filesystem cannot PUNCH_HOLE")
def test_punch_reduces_dead_bytes_while_live_view_stays_valid(store):
    """Acceptance criterion: the punch pass drives slab_arena_dead_bytes
    down while a live reader's zero-copy view (np.shares_memory against
    the segment mapping) stays valid and correct — its flock-pinned
    segment is skipped, fragmented unpinned segments are punched."""
    by_seg = _fill_segments(store)
    sealed = [s for s, seg in
              ((sid, store._segments[sid]) for sid in by_seg)
              if seg.leased_to is None]
    assert len(sealed) >= 2, by_seg.keys()
    keepers = {s: objs[0] for s, objs in by_seg.items()}
    pinned_seg = sealed[0]
    kb = store.get(keepers[pinned_seg])
    view = np.frombuffer(kb.data, dtype=np.uint8)
    mm, _sz = slab_arena.view(store.store_dir).segment(pinned_seg)
    assert np.shares_memory(
        np.frombuffer(memoryview(mm), dtype=np.uint8), view)
    for o in [o for objs in by_seg.values() for o in objs
              if o not in keepers.values()]:
        store.delete(o)
    dead_before = store.arena_dead_bytes()
    out = store.punch_holes(min_fragmentation=0.1, min_bytes=1)
    assert out["dead_bytes_retired"] > 0, out
    assert out["skipped_pinned"] >= 1, \
        "the live reader's segment must be SKIPPED, not punched"
    assert store.arena_dead_bytes() < dead_before
    assert store.arena_punched_bytes() == out["dead_bytes_retired"]
    # the live view is byte-for-byte intact (KEEP_SIZE + skip)
    assert int(view[0]) == 9 and int(view[-1]) == 9
    assert np.all(view[:: max(1, view.nbytes // 64)] == 9)
    # every keeper (including ones in punched segments) still reads
    for s, o in keepers.items():
        b = store.get(o)
        assert b is not None and bytes(b.data[:2]) == b"\x09\x09", s
    # introspection reports the punched ranges
    intro = store.arena_introspect()
    assert intro["punched_bytes"] == out["dead_bytes_retired"]
    assert any(s["punched_bytes"] for s in intro["segments"])


@pytest.mark.skipif(not _PUNCH_SUPPORTED, reason="filesystem cannot PUNCH_HOLE")
def test_punch_skips_leased_reserved_and_pooled_segments(store):
    """Leased slabs (writer mid-put), segments with in-flight
    reservations, and recycling-pool files are off limits to the punch
    pass — only sealed, unpinned, fragmented segments are touched."""
    by_seg = _fill_segments(store, n=24)
    leased = [sid for sid, s in store._segments.items() if s.leased_to]
    assert leased, "the active local slab must be leased"
    # park a reservation in one sealed segment
    sealed = [sid for sid in by_seg if store._segments[sid].leased_to
              is None]
    res = None
    for o in [o for objs in by_seg.values() for o in objs]:
        store.delete(o)  # everything dead -> max fragmentation
    # reserve AFTER the deletes so the reservation segment survives
    res = store.reserve(ObjectID(os.urandom(28)), b"", 1 << 20)
    out = store.punch_holes(min_fragmentation=0.0, min_bytes=1)
    touched = {sid for sid, s in store._segments.items() if s.punched}
    assert res.seg_id not in touched, "reserved segment must be skipped"
    assert not (touched & set(leased)), "leased segments must be skipped"
    # pooled files (whole-segment reclamation got there first) are
    # untouched by construction: they are not in _segments at all
    for pooled in store._pool:
        assert os.path.exists(pooled)
    res.abandon()


@pytest.mark.skipif(not _PUNCH_SUPPORTED, reason="filesystem cannot PUNCH_HOLE")
def test_punch_merges_across_previously_punched_neighbors(store):
    """A dead range freed NEXT to an already-punched range must merge
    with it on the next pass (coalesce over dead + punched) instead of
    being stranded sub-page forever; the merged covering tombstone
    keeps later sealed entries reachable."""
    by_seg = _fill_segments(store, n=40)
    sealed = [s for s in by_seg if store._segments[s].leased_to is None]
    target = sealed[0]
    objs = by_seg[target]
    # free the MIDDLE objects, punch, then free the first one (adjacent
    # to the punched range) and punch again
    for o in objs[1:-1]:
        store.delete(o)
    out1 = store.punch_holes(min_fragmentation=0.0, min_bytes=1)
    assert out1["dead_bytes_retired"] > 0
    seg = store._segments[target]
    assert seg.punched, "first pass must leave a punched range"
    store.delete(objs[0])
    out2 = store.punch_holes(min_fragmentation=0.0, min_bytes=1)
    assert out2["dead_bytes_retired"] > 0, \
        "the newly dead neighbor must merge with the punched range"
    assert len(seg.punched) == 1, seg.punched
    # the survivor (last object, behind the merged punched range) reads
    b = store.get(objs[-1])
    assert b is not None and bytes(b.data[:2]) == b"\x09\x09"
    # and survives a restart rescan across the merged tombstone
    st2 = LocalObjectStore(store.store_dir, 128 << 20)
    b2 = st2.get(objs[-1])
    assert b2 is not None and bytes(b2.data[:2]) == b"\x09\x09"


def test_punch_disabled_when_unsupported(store, monkeypatch):
    monkeypatch.setattr(store, "_punch_probe", False)
    by_seg = _fill_segments(store, n=10)
    for o in [o for objs in by_seg.values() for o in objs]:
        store.delete(o)
    out = store.punch_holes(min_fragmentation=0.0, min_bytes=1)
    assert out == {"punched_ranges": 0, "punched_bytes": 0,
                   "dead_bytes_retired": 0, "skipped_pinned": 0,
                   "segments": 0}


# ----------------------------------------------------------------------
# kill -9 of the receiver mid-transfer (chaos): rescan discards the
# unsealed entry, a sender retry lands the object
# ----------------------------------------------------------------------

def _receiver_then_die(store_dir, oid_b, payload_len):
    """Child 'receiver raylet': seal one good object, start assembling
    another (reserve + partial chunks, NO seal), seal a SECOND good
    object BEHIND the in-flight assembly, die mid-transfer."""
    st = LocalObjectStore(store_dir, 128 << 20)
    good = ObjectID(b"G" * 28)
    st.put(good, b"", [b"g" * 100_000], 100_000)
    res = st.reserve(ObjectID(oid_b), b"meta", payload_len)
    assert res is not None
    res.write(0, b"p" * (payload_len // 3))          # partial,
    res.write(payload_len // 2, b"q" * 1000)          # out of order
    # a local put sealing AFTER the reservation (same segment, higher
    # offset): the reserve-time DEAD header lets the crash rescan hop
    # the in-flight assembly and still adopt this one
    after = ObjectID(b"A" * 28)
    st.put(after, b"", [b"a" * 100_000], 100_000)
    assert st._slab_objs[after][0] == res.seg_id, \
        "test setup: the later put must share the reservation's segment"
    os.kill(os.getpid(), signal.SIGKILL)


@pytest.mark.chaos
def test_kill9_receiver_midtransfer_rescan_discards_and_retry_lands(
        tmp_path):
    store_dir = str(tmp_path / "store")
    oid_b = os.urandom(28)
    payload_len = 2 << 20
    ctx = multiprocessing.get_context("fork")
    p = ctx.Process(target=_receiver_then_die,
                    args=(store_dir, oid_b, payload_len))
    p.start()
    p.join(30)
    assert p.exitcode == -signal.SIGKILL
    # the 'restarted raylet' rescans: BOTH sealed objects survive —
    # including the one sealed BEHIND the in-flight assembly (its
    # reserve-time DEAD header keeps the scan walking) — while the
    # unsealed assembly itself is discarded (reads as dead)
    st = LocalObjectStore(store_dir, 128 << 20)
    assert st.contains(ObjectID(b"G" * 28))
    assert st.contains(ObjectID(b"A" * 28)), \
        "entries sealed after a crashed assembly must stay adoptable"
    oid = ObjectID(oid_b)
    assert not st.contains(oid), "unsealed assembly must be discarded"
    # sender retry: the SAME oid assembles again and lands
    payload = np.arange(payload_len, dtype=np.uint8).tobytes()
    res = st.reserve(oid, b"meta", payload_len)
    assert res is not None
    half = payload_len // 2
    res.write(half, payload[half:])
    res.write(0, payload[:half])
    assert res.seal()
    buf = st.get(oid)
    assert buf is not None and bytes(buf.data) == payload


# ----------------------------------------------------------------------
# cluster-level: abandoned push sessions + ledger callsites + pipeline
# ----------------------------------------------------------------------

RAY_REUSE_CLUSTER = False


def test_expired_push_session_discards_reservation(monkeypatch):
    """Satellite: _expire_push_rx must discard the partially-written
    slab reservation of an abandoned inbound push — the bytes flip to
    dead (reclaimable) instead of leaking an unsealed entry that erodes
    capacity until restart."""
    monkeypatch.setenv("RAY_TPU_TORCH_push_rx_expiry_s", "1.0")
    ray_tpu_torch.init(num_cpus=2)
    try:
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.util import state

        cw = global_worker.core_worker
        total = 4 << 20

        def dead_bytes():
            arenas = state.arena_summary()
            return sum(a.get("dead_bytes") or 0 for a in arenas)

        d0 = dead_bytes()
        # half a push session straight at our raylet: metadata chunk
        # arrives, reservation is made, the rest never comes
        reply = cw.io.run(cw.raylet.request("push_chunks", {
            "object_id": os.urandom(28), "offset": 0, "total": total,
            "data": b"x" * (1 << 20), "metadata": b"m",
            "push_id": "test:abandoned",
        }))
        assert reply.get("ok") and not reply.get("assembled")
        # the heartbeat loop sweeps expired sessions (~0.5s cadence)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if dead_bytes() >= d0 + total:
                break
            time.sleep(0.5)
        assert dead_bytes() >= d0 + total, \
            "abandoned session's reservation must be tombstoned dead"
    finally:
        ray_tpu_torch.shutdown()


def test_put_callsite_persisted_in_store_ledger():
    """Satellite (a known gap of the memory observatory): the creation
    callsite rides the slab report into the STORE-side ledger row, so a
    dead owner's leak verdict still names the line that made the
    object."""
    ray_tpu_torch.init(num_cpus=2)
    try:
        from ray_tpu_torch._private.worker import global_worker

        cw = global_worker.core_worker
        ref = ray_tpu_torch.put(np.zeros(300_000, np.uint8))  # CALLSITE LINE
        deadline = time.monotonic() + 15
        row = None
        while time.monotonic() < deadline:
            out = cw.io.run(cw.raylet.request("memview_node", {}))
            for proc in out["processes"]:
                for r in (proc.get("store") or {}).get("objects", ()):
                    if r["object_id"] == ref.hex():
                        row = r
            if row is not None and row.get("callsite"):
                break
            time.sleep(0.2)
        assert row is not None, "ledger row must exist"
        assert "test_torch_transfer_plane.py" in (row.get("callsite") or ""), row
    finally:
        ray_tpu_torch.shutdown()


def test_pipelined_fetch_out_of_order_chunks_land_exact(monkeypatch):
    """Fetch pipeline e2e: a small chunk size forces many concurrent
    in-flight chunks whose responses land out of order at their offsets
    in the reserved entry — the assembled object must be byte-exact and
    the flow row must report path="arena"."""
    monkeypatch.setenv("RAY_TPU_TORCH_object_transfer_chunk_bytes", "65536")
    monkeypatch.setenv("RAY_TPU_TORCH_fetch_head_chunk_bytes", "65536")
    monkeypatch.setenv("RAY_TPU_TORCH_fetch_pipeline_depth", "6")
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    try:
        from ray_tpu_torch.util import state

        me = ray_tpu_torch.get_runtime_context().get_node_id()
        peer = next(n["node_id"] for n in ray_tpu_torch.nodes()
                    if n["alive"] and n["node_id"] != me)

        @ray_tpu_torch.remote
        def digest(r):
            import zlib

            return r.nbytes, zlib.crc32(bytes(r))

        arr = np.frombuffer(np.random.default_rng(7).bytes(3 << 20),
                            dtype=np.uint8)  # 48 chunks at 64KB
        import zlib

        want = (arr.nbytes, zlib.crc32(arr.tobytes()))
        ref = ray_tpu_torch.put(arr)
        got = ray_tpu_torch.get(digest.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(peer)
        ).remote(ref), timeout=60)
        assert tuple(got) == want, "out-of-order assembly must be exact"
        time.sleep(1.0)
        flows = state.object_summary().get("flows") or []
        fetches = [f for f in flows if f.get("kind") == "fetch"]
        assert fetches and all(f["path"] == "arena" for f in fetches), \
            fetches
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
