"""State API: programmatic cluster introspection.

ray parity: python/ray/util/state/api.py (`ray.util.state.list_actors/
list_tasks/list_nodes/list_objects/...`, aggregation in
dashboard/state_aggregator.py:141 StateAPIManager). TPU-native the sources
are the GCS tables (actors, nodes, jobs, placement groups, task events,
object directory) plus per-raylet node stats — there is no separate
aggregator process; the driver queries the GCS over its existing
connection.

Every ``list_*`` accepts ``filters`` as an iterable of ``(key, "=", value)``
(or ``(key, "!=", value)``) tuples and a ``limit``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

__all__ = [
    "list_actors",
    "list_tasks",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_jobs",
    "list_workers",
    "list_logs",
    "get_log",
    "summarize_tasks",
    "get_node_stats",
    "get_stacks",
    "timeline",
    "train_timeline",
    "steptrace_summary",
    "serve_summary",
    "request_timeline",
    "object_summary",
    "arena_summary",
    "profile_cpu",
    "profile_memory",
    "metrics_summary",
]


def _gcs_request(method: str, payload=None):
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    cw = global_worker.core_worker
    return cw.io.run(cw.gcs.request(method, payload or {}))


def _apply_filters(rows: List[dict], filters, limit: Optional[int]):
    for key, op, value in filters or ():
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported filter op {op!r} (=, !=)")
    return rows[: limit or len(rows)]


def _hexify(row: dict) -> dict:
    out = {}
    for k, v in row.items():
        if isinstance(v, bytes):
            v = v.hex()
        out[k] = v
    return out


def list_actors(filters: Optional[Iterable[Tuple]] = None,
                limit: Optional[int] = None) -> List[dict]:
    rows = [_hexify(r) for r in _gcs_request("list_actors")]
    return _apply_filters(rows, filters, limit)


def list_tasks(filters: Optional[Iterable[Tuple]] = None,
               limit: Optional[int] = None,
               events_limit: Optional[int] = None) -> List[dict]:
    """Latest known state per task, derived from the task-event log
    (ray parity: `ray list tasks` via gcs_task_manager.h).
    ``events_limit`` caps how many raw events are fetched from the GCS
    (default 100k — the full buffer at the default config)."""
    events = _gcs_request("list_task_events",
                          {"limit": events_limit or 100_000})
    latest: dict = {}
    for ev in events:
        if ev.get("state") == "SPAN":  # tracing spans share the event log
            continue
        key = (ev["task_id"], ev.get("attempt", 0))
        cur = latest.get(key)
        if cur is None or ev["ts"] >= cur["ts"]:
            latest[key] = ev
    rows = sorted(latest.values(), key=lambda e: e["ts"])
    return _apply_filters(rows, filters, limit)


def list_task_events(limit: Optional[int] = None) -> List[dict]:
    return _gcs_request("list_task_events", {"limit": limit or 10_000})


def list_nodes(filters: Optional[Iterable[Tuple]] = None,
               limit: Optional[int] = None) -> List[dict]:
    return _apply_filters(_gcs_request("get_nodes"), filters, limit)


def list_objects(filters: Optional[Iterable[Tuple]] = None,
                 limit: Optional[int] = None) -> List[dict]:
    return _apply_filters(
        _gcs_request("list_objects", {"limit": limit}), filters, limit
    )


def list_placement_groups(filters: Optional[Iterable[Tuple]] = None,
                          limit: Optional[int] = None) -> List[dict]:
    """PG table rows, including the gang scheduler's topology
    provenance: ``node_coords`` (torus coord per bundle host),
    ``contention_score`` (ring-overlap of the chosen placement vs gangs
    committed before it), ``sched_strategy``
    ("topology-contention" | "resource-fit"), and ``repack_moves``."""
    return _apply_filters(_gcs_request("pg_table", {}), filters, limit)


def list_jobs(filters: Optional[Iterable[Tuple]] = None,
              limit: Optional[int] = None) -> List[dict]:
    rows = [_hexify(r) for r in _gcs_request("list_jobs")]
    return _apply_filters(rows, filters, limit)


def list_workers(filters: Optional[Iterable[Tuple]] = None,
                 limit: Optional[int] = None) -> List[dict]:
    """Per-node worker counts (from raylet node stats)."""
    rows = []
    for node in _gcs_request("get_nodes"):
        if not node.get("alive"):
            continue
        stats = get_node_stats(node["node_id"])
        if stats is not None:
            rows.append(stats)
    return _apply_filters(rows, filters, limit)


# ---------------------------------------------------------------------------
# cluster log plane (ray parity: ray.util.state.list_logs/get_log —
# dashboard/modules/log; here the head fans to per-node agents over HTTP)
# ---------------------------------------------------------------------------

def _agent_addr(node: dict) -> Optional[str]:
    """Base URL of a node's dashboard agent (port from the GCS KV the
    agent registered at boot)."""
    port = _gcs_request("kv_get", {"ns": b"node_agents",
                                   "key": node["node_id"].encode()})
    if not port:
        return None
    return f"http://{node['host']}:{int(port.decode())}"


def _match_node(node: dict, node_id: Optional[str]) -> bool:
    return node_id is None or node["node_id"] == node_id \
        or node["node_id"].startswith(node_id)


def list_logs(node_id: Optional[str] = None,
              timeout: float = 30.0) -> dict:
    """Log files per node: ``{node_id: [{"file", "bytes"}, ...]}``
    (``node_id`` may be a prefix). Fans head->agents; nodes without a
    reachable agent report ``{"error": ...}``."""
    import requests

    out: dict = {}
    for node in _gcs_request("get_nodes"):
        if not node.get("alive") or not _match_node(node, node_id):
            continue
        base = _agent_addr(node)
        if base is None:
            out[node["node_id"]] = {"error": "no node agent"}
            continue
        try:
            r = requests.get(f"{base}/api/v0/logs", timeout=timeout)
            out[node["node_id"]] = r.json()
        except Exception as e:
            out[node["node_id"]] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _task_log_event(task_id: Optional[str] = None,
                    actor_id: Optional[str] = None) -> Optional[dict]:
    """Latest task event carrying log attribution for a task/actor."""
    best = None
    for ev in _gcs_request("list_task_events", {"limit": 100_000}):
        if task_id is not None and ev.get("task_id") != task_id:
            continue
        if actor_id is not None and ev.get("actor_id") != actor_id:
            continue
        if ev.get("log_file") is None:
            continue
        if best is None or (ev["ts"], ev.get("log_end") is not None) >= \
                (best["ts"], best.get("log_end") is not None):
            best = ev
    return best


def _agent_for_node_id(node_id: str, strict: bool = True) -> Optional[str]:
    for node in _gcs_request("get_nodes"):
        if node["node_id"] == node_id or node["node_id"].startswith(node_id):
            return _agent_addr(node)
    return None


def get_log(filename: Optional[str] = None,
            task_id: Optional[str] = None,
            actor_id: Optional[str] = None,
            node_id: Optional[str] = None,
            tail: Optional[int] = None,
            follow: bool = False,
            timeout: float = 30.0):
    """Fetch log lines by filename, task id, or actor id.

    - ``task_id``: the task's EXACT output — resolved through the
      attribution span (log_file, log_start, log_end) its executor
      stamped on the FINISHED/FAILED task event, read back as a byte
      range from that node's agent. Not a grep.
    - ``actor_id``: the actor worker's log file (located via the actor's
      latest attributed event), tailed.
    - ``filename``: that session log file (``node_id`` narrows the
      search; without it every alive node is probed).

    Returns a list of lines, or a generator of lines when ``follow=True``
    (filename/actor mode only: polls the file as it grows).
    """
    import requests

    if sum(x is not None for x in (filename, task_id, actor_id)) != 1:
        raise ValueError("pass exactly one of filename, task_id, actor_id")

    if task_id is not None:
        ev = _task_log_event(task_id=task_id)
        if ev is None:
            raise ValueError(f"no log attribution recorded for task "
                             f"{task_id} (still running, or pruned)")
        base = _agent_for_node_id(ev["node_id"])
        if base is None:
            raise RuntimeError(f"node agent for {ev['node_id'][:12]} "
                               f"unreachable")
        end = ev.get("log_end")
        if end is None:
            # still running: read start -> EOF (current size via listing)
            files = requests.get(f"{base}/api/v0/logs",
                                 timeout=timeout).json()
            end = next((f["bytes"] for f in files
                        if f["file"] == ev["log_file"]), ev["log_start"])
        r = requests.get(f"{base}/api/v0/logs/range", params={
            "file": ev["log_file"], "start": ev["log_start"], "end": end,
        }, timeout=timeout)
        lines = r.json().get("lines", [])
        return lines[-tail:] if tail else lines

    if actor_id is not None:
        ev = _task_log_event(actor_id=actor_id)
        if ev is None:
            raise ValueError(f"no log attribution recorded for actor "
                             f"{actor_id}")
        filename, node_id = ev["log_file"], ev["node_id"]

    # filename mode (possibly via actor_id above)
    base = None
    if node_id is not None:
        base = _agent_for_node_id(node_id)
    else:
        for node in _gcs_request("get_nodes"):
            if not node.get("alive"):
                continue
            cand = _agent_addr(node)
            if cand is None:
                continue
            try:
                files = requests.get(f"{cand}/api/v0/logs",
                                     timeout=timeout).json()
            except Exception:
                continue
            if any(f.get("file") == filename for f in files):
                base = cand
                break
    if base is None:
        raise ValueError(f"log file {filename!r} not found on any "
                         f"reachable node agent")
    r = requests.get(f"{base}/api/v0/logs/tail", params={
        "file": filename, "lines": tail or 100,
    }, timeout=timeout)
    payload = r.json()
    if payload.get("error"):
        raise ValueError(payload["error"])
    if not follow:
        return payload["lines"]

    def _follow():
        import time as _time

        offset = payload.get("end", 0)
        yield from payload["lines"]
        while True:
            _time.sleep(1.0)
            rr = requests.get(f"{base}/api/v0/logs/range", params={
                "file": filename, "start": offset, "end": offset + 2**20,
            }, timeout=timeout).json()
            if rr.get("error"):
                # rotated/removed file must surface, not spin silently
                raise RuntimeError(
                    f"following {filename!r} failed: {rr['error']}")
            got = rr.get("lines") or []
            # resume at the last complete line: a line caught mid-write
            # stays unread until its newline lands, instead of being
            # yielded as two torn halves across polls
            new_offset = rr.get("end_complete",
                                offset + rr.get("bytes", 0))
            if rr.get("bytes", 0) > new_offset - offset and got:
                got.pop()  # trailing partial held for the next poll
            offset = new_offset
            yield from got

    return _follow()


def _node_request(node: dict, method: str, payload=None,
                  timeout: Optional[float] = None) -> Optional[dict]:
    """One request to a raylet discovered from the nodes table (shared
    connect/request/teardown choreography for per-node probes)."""
    from ray_tpu_torch._private.rpcio import EventLoopThread, connect

    io = EventLoopThread("state-probe")
    try:
        conn = io.run(connect(node["host"], node["port"], retries=2))
        reply = io.run(conn.request(method, payload or {}, timeout=timeout))
        io.run(conn.close())
        return reply
    except Exception:
        return None
    finally:
        io.stop()


def get_stacks(node_id: Optional[str] = None) -> List[dict]:
    """Thread stack dumps of every worker, per node (ray parity:
    `ray stack` / dashboard reporter's py-spy dump — here workers
    self-report via sys._current_frames, offline-safe)."""
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    out: List[dict] = []
    for node in _gcs_request("get_nodes"):
        if not node["alive"]:
            continue
        if node_id is not None and node["node_id"] != node_id:
            continue
        reply = _node_request(node, "node_stacks", timeout=30)
        out.append(reply if reply is not None else
                   {"node_id": node["node_id"], "error": "unreachable"})
    return out


def get_node_stats(node_id: str) -> Optional[dict]:
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    for node in _gcs_request("get_nodes"):
        if node["node_id"] == node_id:
            return _node_request(node, "node_stats")
    return None


def steptrace_summary(limit: Optional[int] = None) -> dict:
    """One cluster-wide step-observatory scrape, merged: collectives
    joined by (group, seq) with per-rank arrival-skew attribution
    (``skew``, ``last_rank``, ``missing``), step phases / step
    boundaries / compile events per rank, and the GCS's rolling per-rank
    straggler scores. Triggers the GCS-side metrics fold as a side
    effect, so ``collective_skew_seconds`` and
    ``steptrace_straggler_score`` advance on the /metrics scrape.
    ``limit`` caps the merge to the newest N accumulated records (the
    fold always ingests everything) — callers that only need the fold
    side effect or a cheap summary pass a small limit."""
    return _gcs_request("steptrace_cluster",
                        {"limit": limit} if limit else {})


def train_timeline(filename: Optional[str] = None) -> list:
    """Merged multi-rank training timeline as Chrome-trace JSON
    (Perfetto / chrome://tracing loadable): one process row per rank
    with step boundaries, ``step_phase`` intervals, per-collective
    slices annotated with (group, seq) arrival skew + the last-arriving
    rank, and compile events (kernel builds). The per-step complement of
    ``ray_tpu_torch.timeline()`` (which renders task scheduling): this one
    shows where each training step's time actually goes and which rank
    every collective waited on."""
    import json

    from ray_tpu_torch._private import steptrace

    merged = steptrace_summary()
    trace = steptrace.chrome_trace(merged)
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def serve_summary(limit: Optional[int] = None) -> dict:
    """One cluster-wide request-observatory scrape, merged: per-request
    rows joined by request id (every hop's phase spans — ingress, route
    with the router's inflight snapshot, replica queue wait, batch
    formation, execute, serialize — plus streaming first/last-byte
    marks), per-deployment p50/p95/p99 + TTFT summaries, per-replica
    phase profiles, and slow-replica skew verdicts ("replica r3 is slow,
    and it's queue wait, not execute"). Triggers the GCS-side metrics
    fold as a side effect, so ``serve_request_phase_seconds`` and
    ``serve_request_ttft_seconds`` advance on the /metrics scrape.
    ``limit`` caps the merge to the newest N accumulated records."""
    return _gcs_request("reqtrace_cluster",
                        {"limit": limit} if limit else {})


def request_timeline(filename: Optional[str] = None) -> list:
    """Merged serve request timeline as Chrome-trace JSON (Perfetto /
    chrome://tracing loadable): one process row per replica (plus the
    proxy side), phase slices per request, streaming first/last-byte
    instants — the serve complement of ``train_timeline()``. Each slice
    carries its request id, so one slow request reads end to end across
    proxy and replica rows."""
    import json

    from ray_tpu_torch._private import reqtrace

    merged = serve_summary()
    trace = reqtrace.chrome_trace(merged)
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def object_summary(group_by: Optional[str] = None,
                   limit: Optional[int] = None) -> dict:
    """One cluster-wide memory-observatory scrape, merged: per-object
    lifecycle rows (state arena/external/spilled/inlined, size, owner,
    refcount, pin count, locations, age, creation callsite), per-node
    arena introspection, the bounded spill/restore/push/fetch flow log,
    and leak/pressure **verdicts** (objects resident yet referenced by
    no process, pool segments pinned by reader flocks with the pinning
    pids, capacity overshoot attributed to its cause).

    ``group_by`` ("callsite" | "node" | "owner" | "state") adds a
    ``groups`` aggregation; ``limit`` caps the object rows returned."""
    from ray_tpu_torch._private import memview

    merged = _gcs_request("memview_cluster", {})
    if limit:
        merged["objects"] = (merged.get("objects") or [])[:limit]
    if group_by:
        merged["groups"] = memview.group_objects(
            merged.get("objects") or [], group_by)
    return merged


def arena_summary() -> List[dict]:
    """Per-node slab-arena introspection: segment occupancy with live vs
    dead entry counts and **dead byte ranges** (hole-punch reclamation
    candidates), fragmentation ratio, recycling-pool and leased-vs-
    sealed stats, per-client slab charge, pool segments pinned by reader
    flocks (with pids), and the spill/overshoot tallies."""
    return _gcs_request("memview_cluster", {}).get("arenas") or []


def profile_cpu(**kwargs):
    """Cluster-wide sampled CPU profile (ray parity: the dashboard's
    py-spy flamegraph attach). See ray_tpu_torch.util.profiling.profile_cpu."""
    from ray_tpu_torch.util import profiling

    return profiling.profile_cpu(**kwargs)


def profile_memory(**kwargs):
    """Cluster-wide tracemalloc memory diff (ray parity: the dashboard's
    memray attach). See ray_tpu_torch.util.profiling.profile_memory."""
    from ray_tpu_torch.util import profiling

    return profiling.profile_memory(**kwargs)


def metrics_summary() -> dict:
    """Merged cluster-wide runtime+user metrics, compacted: counters and
    gauges -> value per labelset, histograms -> count/sum/mean/p50/p95/p99
    (one GCS fan-out scrape; see ray_tpu_torch.util.metrics)."""
    from ray_tpu_torch.util import metrics

    return metrics.metrics_summary()


def summarize_tasks() -> dict:
    """Counts by (name, state) — ray parity: `ray summary tasks`."""
    summary: dict = {}
    for row in list_tasks():
        entry = summary.setdefault(
            row["name"], {"FINISHED": 0, "FAILED": 0, "RUNNING": 0,
                          "PENDING": 0, "total": 0}
        )
        state = row["state"]
        if state.startswith("PENDING"):
            entry["PENDING"] += 1
        elif state in entry:
            entry[state] += 1
        entry["total"] += 1
    return summary


def timeline(filename: Optional[str] = None,
             limit: Optional[int] = None) -> list:
    """Chrome-trace dump of the task-event log (ray parity:
    `ray timeline` — _private/state.py:416 chrome_tracing_dump). Load the
    output in chrome://tracing or Perfetto. Tracing spans (util.tracing)
    ride the same event log and render as their own "span" slices, so a
    driver-opened span and its worker-side execution child land in one
    trace. ``limit`` caps the raw events fetched (default 100k)."""
    import json

    events = _gcs_request("list_task_events", {"limit": limit or 100_000})
    # Pair RUNNING -> FINISHED/FAILED into complete ("X") slices.
    running: dict = {}
    trace = []
    for ev in sorted(events, key=lambda e: e["ts"]):
        key = (ev["task_id"], ev.get("attempt", 0))
        if ev["state"] == "SPAN":
            # distributed-tracing span (tracing.py flush): already a
            # complete interval — emit directly
            trace.append({
                "name": ev["name"],
                "cat": "span",
                "ph": "X",
                "ts": ev.get("span_start", ev["ts"]) * 1e6,
                "dur": max(ev.get("duration", 0.0) * 1e6, 1.0),
                "pid": (ev.get("node_id") or "")[:8],
                "tid": ev.get("pid", 0),
                "args": {
                    "trace_id": ev.get("trace_id"),
                    "span_id": ev["task_id"],
                    "parent_span_id": ev.get("parent_span_id"),
                    "attributes": ev.get("attributes", {}),
                },
            })
            continue
        if ev["state"] == "RUNNING":
            running[key] = ev
        elif ev["state"] in ("FINISHED", "FAILED") and key in running:
            start = running.pop(key)
            trace.append({
                "name": ev["name"],
                "cat": "task",
                "ph": "X",
                "ts": start["ts"] * 1e6,
                "dur": max((ev["ts"] - start["ts"]) * 1e6, 1.0),
                "pid": ev["node_id"][:8],
                "tid": ev.get("pid", 0),
                "args": {
                    "task_id": ev["task_id"],
                    "state": ev["state"],
                    "attempt": ev.get("attempt", 0),
                },
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
