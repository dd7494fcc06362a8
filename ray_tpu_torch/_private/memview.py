"""Memory observatory: object-plane lifecycle, arena introspection, and
leak attribution.

The five observability planes (chaos/profiling/metrics/logs/steptrace)
watch the control plane and the training loop; this one lights up the
OBJECT plane — the repo's strongest perf axis since the slab arena —
answering "what objects exist, who owns them, where do their bytes
live, and why is the store full". Per process it keeps

- a **creation table**: every ``put()`` stamps the creating user-code
  callsite (one bounded frame walk), size, kind, and timestamp, so a
  driver-side leak groups by the line that made it;
- a **flow ring**: bounded spill/restore/push/fetch events with bytes,
  latency, and the transfer path — ``arena`` (bytes never left slab
  memory) vs ``heap`` (chunk assembly through heap buffers, the copy
  the ROADMAP's receive-side slab assembly exists to remove) vs
  ``file`` (one-file ``.obj`` interop).

Metrics-core discipline applies: ``record_*`` is a flag load + a dict/
list store, and the whole plane is gated by ``RAY_TPU_TORCH_MEMVIEW_ENABLED=0``
/ cfg ``memview_enabled`` so it costs nothing when off. The bench lane
(BENCH_MEMVIEW_OVERHEAD=1) gates the tracking share of the put/get hot
path <2% and asserts zero records when disabled.

The owner-side store ledger (object_store.LocalObjectStore) is the
ground truth for resident bytes: ``arena_introspect()`` reports
per-segment occupancy, live/dead entry counts, and **dead byte ranges**
— the literal input to future ``fallocate(PUNCH_HOLE)`` reclamation —
plus recycling-pool and per-client slab charges. The fan-out rides the
proven worker→raylet→GCS snapshot pattern (``memview_snapshot`` /
``memview_node`` / ``memview_cluster``) and ``merge_cluster`` joins
store rows with every process's reference tables into lifecycle rows
and **verdicts**: objects resident yet referenced by nobody (leaks,
grouped by creation callsite), pool segments pinned only by a reader's
SHARED flock (with the pinning pids from /proc/locks), and capacity
overshoot attributed to its cause (register_external fallback writes vs
untracked restores) instead of a raw counter.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "set_enabled", "is_enabled", "record_calls", "reset",
    "callsite_tag", "record_put", "forget_put", "put_info", "puts_table",
    "record_flow", "flow_snapshot", "process_snapshot",
    "coalesce_ranges", "segment_stats", "flock_holders",
    "merge_cluster", "group_objects", "leak_verdicts", "pressure_verdicts",
]

_enabled = os.environ.get("RAY_TPU_TORCH_MEMVIEW_ENABLED", "1").lower() not in (
    "0", "false", "no")
_explicit = False  # set_enabled() was called: runtime override wins
# instrumentation event count (the bench lane's calibrated-cost x count
# estimator multiplies this, same discipline as steptrace._events)
_events = 0

_TRACK_DEFAULT = 8192
_FLOW_DEFAULT = 2048

_lock = threading.Lock()
# oid bytes -> (callsite, wall ts, nbytes, kind); bounded FIFO — the
# owner table, not the store ledger: it exists for callsite/age/refcount
# attribution, and an evicted entry degrades a row to "callsite unknown"
_puts: "OrderedDict[bytes, tuple]" = OrderedDict()
_puts_max = 0

_flow_ring: List[Any] = []
_flow_size = 0
_flow_idx = 0  # monotonic per-process flow index (slot = idx % size)


def _fold_cfg():
    """Fold cfg ``memview_enabled`` (itself env-overridable as
    ``RAY_TPU_TORCH_memview_enabled``) into the flag — the documented kill
    switch must gate the record paths, not just the surfaces. An
    explicit set_enabled() always wins."""
    global _enabled
    if _explicit:
        return
    try:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.memview_enabled:
            _enabled = False
    except Exception:
        pass


_fold_cfg()


def set_enabled(flag: bool):
    global _enabled, _explicit
    _explicit = True
    _enabled = bool(flag)


def is_enabled() -> bool:
    _fold_cfg()
    return _enabled


def record_calls() -> int:
    """Total record_* calls in this process since import (the overhead
    lane's event count)."""
    return _events


def reset():
    """Drop all records and counters (tests / bench phases)."""
    global _flow_ring, _flow_size, _flow_idx, _puts_max, _events
    with _lock:
        _puts.clear()
        _puts_max = 0
        _ext_pins.clear()
    _flow_ring = []
    _flow_size = 0
    _flow_idx = 0
    _events = 0


# ---------------------------------------------------------------------------
# external pins: store-resident bytes a process holds OUTSIDE the
# ObjectRef world (e.g. a serving replica's arena-backed KV pages).
# Pinned oids join the process's ``referenced`` snapshot set, so the
# cluster merge sees the holder — an unpinned-yet-undeleted page then
# ages into a leak verdict exactly like an unreferenced object.
# ---------------------------------------------------------------------------

_ext_pins: set = set()


def pin_external(oid: bytes):
    with _lock:
        _ext_pins.add(bytes(oid))


def unpin_external(oid: bytes):
    with _lock:
        _ext_pins.discard(bytes(oid))


def external_pins() -> list:
    with _lock:
        return list(_ext_pins)


def _limits():
    global _puts_max, _flow_ring, _flow_size
    if _puts_max == 0:
        _fold_cfg()  # late system_config overrides land before any write
        track, flow = _TRACK_DEFAULT, _FLOW_DEFAULT
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            track = int(GLOBAL_CONFIG.memview_track_max)
            flow = int(GLOBAL_CONFIG.memview_flow_ring_size)
        except Exception:
            pass
        _puts_max = max(16, track)
        _flow_ring = [None] * max(16, flow)
        _flow_size = len(_flow_ring)


# ---------------------------------------------------------------------------
# creation-site table (worker-side; stamped at put())
# ---------------------------------------------------------------------------

def callsite_tag(skip: int = 2) -> Optional[str]:
    """First stack frame OUTSIDE ray_tpu_torch internals, as
    ``dir/file.py:line in fn`` — the user line that created the object.
    Bounded walk (puts are ~100µs+; this is ~1µs for typical depths)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return None
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        if "ray_tpu_torch" not in fn:
            parts = fn.replace("\\", "/").rsplit("/", 2)
            short = "/".join(parts[-2:]) if len(parts) > 1 else fn
            return f"{short}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
        depth += 1
    return None


def record_put(oid: bytes, nbytes: int, kind: str = "put",
               callsite: Optional[str] = None):
    """Stamp an object's creation: callsite + wall time + size. Hot path
    of every ``put()`` — flag load, frame walk, one dict store."""
    global _events
    if not _enabled:
        return
    _limits()
    if not _enabled:  # late config override folded in by _limits
        return
    _events += 1
    # start at our caller: the ray_tpu_torch-frame skip inside callsite_tag
    # walks the rest of the way out of runtime internals
    site = callsite_tag(2) if callsite is None else callsite
    with _lock:
        _puts[oid] = (site, time.time(), int(nbytes), kind)
        while len(_puts) > _puts_max:
            _puts.popitem(last=False)  # bounded FIFO


def forget_put(oid: bytes):
    """The owner freed the object: drop its creation record (an entry
    surviving its object would read as a leak candidate forever)."""
    if not _puts:
        return
    with _lock:
        _puts.pop(oid, None)


def put_info(oid: bytes) -> Optional[tuple]:
    """(callsite, ts, nbytes, kind) or None."""
    return _puts.get(oid)


def puts_table() -> Dict[bytes, tuple]:
    with _lock:
        return dict(_puts)


# ---------------------------------------------------------------------------
# flow ring (spill/restore/push/fetch events)
# ---------------------------------------------------------------------------

def record_flow(kind: str, nbytes: int, dur_s: float, path: str,
                oid_hex: Optional[str] = None):
    """One object-plane transfer event. ``kind`` is spill/restore/
    fetch/push/push_rx/punch; ``path`` is where the bytes travelled:
    "arena" (bytes never left slab memory — zero-copy sends, receive-
    side slab assembly, hole punches), "heap" (chunk assembly through
    heap buffers: the legacy/native-fallback receive path), "file"
    (one-file .obj interop)."""
    global _events, _flow_idx
    if not _enabled:
        return
    _limits()
    if not _enabled:
        return
    _events += 1
    _flow_ring[_flow_idx % _flow_size] = (
        kind, _flow_idx, time.time(), int(nbytes), float(dur_s), path,
        oid_hex)
    _flow_idx += 1


def flow_snapshot() -> List[dict]:
    """Ring contents as dicts, oldest first."""
    if _flow_idx == 0:
        return []
    ring, size, idx = _flow_ring, _flow_size, _flow_idx
    raw = ring[:idx] if idx <= size else \
        ring[idx % size:] + ring[: idx % size]
    out = []
    for rec in raw:
        if rec is None:  # torn slot mid-wrap: skip, never corrupt
            continue
        out.append({"kind": rec[0], "idx": rec[1], "ts": rec[2],
                    "bytes": rec[3], "dur_s": rec[4], "path": rec[5],
                    "object_id": rec[6]})
    return out


def process_snapshot(extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The ``memview_snapshot`` RPC payload skeleton: flow ring + event
    count + identity. Callers (worker/raylet) add their ``owned`` /
    ``referenced`` / ``store`` tables via ``extra``."""
    out: Dict[str, Any] = {
        "pid": os.getpid(),
        "flows": flow_snapshot(),
        "flow_dropped": max(0, _flow_idx - _flow_size) if _flow_size else 0,
        "record_calls": _events,
    }
    if extra:
        out.update(extra)
    return out


# ---------------------------------------------------------------------------
# pure helpers: dead-range math, scan-based segment stats, flock holders
# ---------------------------------------------------------------------------

def coalesce_ranges(ranges: Iterable[Tuple[int, int]]
                    ) -> List[Tuple[int, int]]:
    """Merge (offset, length) ranges into sorted, maximal runs — the
    shape the hole-punch pass (``object_store.punch_holes``) punches.
    Adjacent and overlapping ranges fuse; order of the input doesn't
    matter."""
    out: List[List[int]] = []
    for off, length in sorted(ranges):
        if length <= 0:
            continue
        if out and off <= out[-1][0] + out[-1][1]:
            out[-1][1] = max(out[-1][1], off + length - out[-1][0])
        else:
            out.append([off, length])
    return [(o, n) for o, n in out]


def segment_stats(path: str) -> Dict[str, Any]:
    """Scan-based ground truth for one slab segment file (the arena is
    authoritative over any ledger): live/dead entry counts and bytes,
    coalesced dead ranges, and the bump-allocation end offset."""
    from ray_tpu_torch._private import slab_arena

    live = dead = live_bytes = dead_bytes = end = 0
    dead_ranges: List[Tuple[int, int]] = []
    for _oid, off, _ml, _dl, total, is_dead in slab_arena.scan_segment(path):
        end = off + total
        if is_dead:
            dead += 1
            dead_bytes += total
            dead_ranges.append((off, total))
        else:
            live += 1
            live_bytes += total
    return {
        "live_entries": live, "dead_entries": dead,
        "live_bytes": live_bytes, "dead_bytes": dead_bytes,
        "dead_ranges": coalesce_ranges(dead_ranges), "end": end,
        "fragmentation": dead_bytes / (live_bytes + dead_bytes)
        if (live_bytes + dead_bytes) else 0.0,
    }


def flock_holders(path: str) -> List[int]:
    """Pids holding a flock on ``path``, from /proc/locks (Linux; best
    effort elsewhere). This is how a recycling-pool segment stuck behind
    a reader's SHARED flock names its pinner."""
    try:
        st = os.stat(path)
    except OSError:
        return []
    want = f"{os.major(st.st_dev):02x}:{os.minor(st.st_dev):02x}:" \
           f"{st.st_ino}"
    pids: List[int] = []
    try:
        with open("/proc/locks") as f:
            for line in f:
                # "1: FLOCK ADVISORY WRITE 4242 08:01:123456 0 EOF"
                parts = line.split()
                if len(parts) >= 6 and parts[1] == "FLOCK" \
                        and parts[5] == want:
                    try:
                        pids.append(int(parts[4]))
                    except ValueError:
                        continue
    except OSError:
        return []
    return sorted(set(pids))


# ---------------------------------------------------------------------------
# cluster merge + verdicts (GCS-side; pure functions, unit-testable)
# ---------------------------------------------------------------------------

# a store-resident object younger than this is never called a leak: its
# owner's reference may simply not have reached the scrape yet (put
# report in flight, snapshot raced)
LEAK_MIN_AGE_S = 30.0


def merge_cluster(processes: Sequence[dict],
                  locations: Optional[Dict[str, list]] = None,
                  flow_limit: int = 500) -> Dict[str, Any]:
    """Fold per-process memview snapshots into one cluster view.

    Store rows (from each raylet's ledger) are joined with every
    process's owner tables: an object row gains its owner's refcount,
    pins, creation callsite, and age; objects living only inline in an
    owner's memory store appear as ``state="inlined"`` rows. The union
    of every process's reference tables gives the reachability set the
    leak verdicts test against.
    """
    objects: Dict[str, dict] = {}
    arenas: List[dict] = []
    flows: List[dict] = []
    referenced: set = set()
    owners: Dict[str, dict] = {}
    scrape_errors = 0
    for proc in processes:
        if proc.get("error"):
            scrape_errors += 1
            continue
        node = proc.get("node_id")
        owner_id = proc.get("client_id") or str(node)
        for oid_hex in proc.get("referenced", ()):
            referenced.add(oid_hex)
        for row in proc.get("owned", ()):
            owners[row["object_id"]] = dict(row, owner=owner_id)
        for fl in proc.get("flows", ()):
            flows.append(dict(fl, node_id=node, pid=proc.get("pid")))
        store = proc.get("store")
        if store:
            # arena=None means the node's store has no introspection
            # surface (native C++ store): no row — a phantom all-zero
            # arena would read as "healthy and empty" in triage output
            if store.get("arena") is not None:
                arenas.append(dict(store["arena"], node_id=node))
            for row in store.get("objects", ()):
                r = objects.get(row["object_id"])
                if r is None:
                    r = objects[row["object_id"]] = dict(row)
                    r["nodes"] = []
                r["nodes"].append(node)
                # a spilled copy elsewhere must not mask a live one
                if row.get("state") == "arena":
                    r["state"] = "arena"
                r["size"] = max(r.get("size") or 0, row.get("size") or 0)
    for oid_hex, own in owners.items():
        if oid_hex not in objects and own.get("inlined"):
            objects[oid_hex] = {
                "object_id": oid_hex, "state": "inlined",
                "size": own.get("size") or 0, "nodes": [],
            }
    rows: List[dict] = []
    for oid_hex, r in objects.items():
        own = owners.get(oid_hex)
        if own is not None:
            r["owner"] = own.get("owner")
            r["refs"] = own.get("refs", 0)
            r["pins"] = max(r.get("pins") or 0, own.get("pins") or 0)
            if own.get("callsite"):
                r["callsite"] = own["callsite"]
            if r.get("age_s") is None and own.get("age_s") is not None:
                r["age_s"] = own["age_s"]
        r["referenced"] = oid_hex in referenced
        if locations is not None and oid_hex in locations:
            r["locations"] = locations[oid_hex]
        rows.append(r)
    rows.sort(key=lambda r: -(r.get("size") or 0))
    totals: Dict[str, dict] = {}
    for r in rows:
        t = totals.setdefault(r.get("state") or "?",
                              {"count": 0, "bytes": 0})
        t["count"] += 1
        t["bytes"] += r.get("size") or 0
    flows.sort(key=lambda f: f.get("ts") or 0)
    verdicts = leak_verdicts(rows, complete=(scrape_errors == 0)) \
        + pressure_verdicts(arenas)
    return {
        "objects": rows,
        "arenas": arenas,
        "flows": flows[-flow_limit:],
        "totals": totals,
        "verdicts": verdicts,
        "referenced_count": len(referenced),
        "scrape_errors": scrape_errors,
    }


def leak_verdicts(rows: Sequence[dict], complete: bool = True,
                  min_age_s: float = LEAK_MIN_AGE_S) -> List[dict]:
    """Objects resident in a store yet referenced by NO process in the
    scrape: unreachable-yet-undeleted. Age-gated (a fresh put's report
    may still be in flight) and downgraded to suspected when part of the
    cluster didn't answer (an unreachable owner is not a dead owner)."""
    out = []
    for r in rows:
        if r.get("state") == "inlined" or r.get("referenced"):
            continue
        age = r.get("age_s")
        if age is not None and age < min_age_s:
            continue
        out.append({
            "kind": "leak",
            "confidence": "likely" if complete else "suspected",
            "object_id": r["object_id"],
            "bytes": r.get("size") or 0,
            "state": r.get("state"),
            "nodes": r.get("nodes") or [],
            "callsite": r.get("callsite"),
            "age_s": age,
            "detail": "resident but referenced by no live process"
                      + ("" if complete
                         else " (scrape incomplete: owner may be"
                              " unreachable, not gone)"),
        })
    return out


def pressure_verdicts(arenas: Sequence[dict]) -> List[dict]:
    """Per-node store-pressure attribution: capacity overshoot named by
    cause, pool segments pinned only by reader flocks (with pids), and
    heavy fragmentation (dead ranges are hole-punch candidates)."""
    out: List[dict] = []
    for a in arenas:
        node = a.get("node_id")
        spilled = a.get("spilled") or {}
        by_cause = spilled.get("overshoot_by_cause") or {}
        for cause, nbytes in sorted(by_cause.items()):
            if nbytes:
                out.append({
                    "kind": "overshoot", "node_id": node, "bytes": nbytes,
                    "cause": cause,
                    "detail": {
                        "register_external":
                            "one-file fallback writes landed past "
                            "capacity (lease denied or legacy path)",
                        "untracked_restore":
                            "a predecessor raylet's spilled objects "
                            "restored into an already-full store",
                    }.get(cause, cause),
                })
        for ent in a.get("pool_pinned") or ():
            out.append({
                "kind": "pinned_segment", "node_id": node,
                "bytes": ent.get("charged") or ent.get("file_size") or 0,
                "file": ent.get("file"),
                "holder_pids": ent.get("holder_pids") or [],
                "detail": "recycling-pool segment kept alive only by a "
                          "reader's SHARED flock — a stuck zero-copy "
                          "view pins its pages",
            })
        dead = a.get("dead_bytes") or 0
        live = a.get("live_bytes") or 0
        if dead and dead >= max(live, 1):
            out.append({
                "kind": "fragmentation", "node_id": node, "bytes": dead,
                "fragmentation": dead / (dead + live) if dead + live else 0.0,
                "detail": "over half the resident slab bytes are dead "
                          "entries inside live segments — hole-punch "
                          "reclamation candidates (see dead_ranges)",
            })
    return out


def group_objects(rows: Sequence[dict], by: str) -> List[dict]:
    """Aggregate object rows by callsite / node / owner / state:
    ``[{key, count, bytes}]`` sorted biggest first."""
    if by not in ("callsite", "node", "owner", "state"):
        raise ValueError(f"group_by must be callsite|node|owner|state, "
                         f"got {by!r}")

    def key_of(r: dict) -> str:
        if by == "node":
            nodes = r.get("nodes") or []
            return str(nodes[0])[:12] if nodes else "(no node)"
        v = r.get(by)
        return str(v) if v else f"(unknown {by})"

    groups: Dict[str, dict] = {}
    for r in rows:
        g = groups.setdefault(key_of(r), {"count": 0, "bytes": 0})
        g["count"] += 1
        g["bytes"] += r.get("size") or 0
    return sorted(
        ({"key": k, **v} for k, v in groups.items()),
        key=lambda g: (-g["bytes"], g["key"]),
    )
