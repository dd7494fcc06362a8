"""Dashboard head: aiohttp JSON API over the state/metrics surfaces.

ray parity: dashboard/head.py:81 DashboardHead with the per-domain module
routes collapsed onto ray_tpu_torch.util.state + util.metrics + the job
submission KV. Runs inside the driver process on its own thread (no
separate head process needed — the GCS connection is shared).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from collections import deque
from typing import Optional

_server = None

# In-head metrics history ring: one compact summary of the merged cluster
# scrape per metrics_history_interval_s tick, metrics_history_len deep
# (~10 min at the defaults). The SPA Metrics tab draws its sparkline
# time-series from this — the head is the one process with a stable
# vantage point, so reloading the page doesn't lose the series.
_metrics_history: deque = deque(maxlen=240)


def _json_response(payload, status: int = 200):
    from aiohttp import web

    return web.Response(
        text=json.dumps(payload, default=str),
        content_type="application/json",
        status=status,
    )


def _build_app():
    from aiohttp import web

    from ray_tpu_torch.util import state

    routes = web.RouteTableDef()

    @routes.get("/")
    async def index(request):
        """Single-file UI over this JSON API (stands in for the
        reference's React client without a build toolchain)."""
        import os

        path = os.path.join(os.path.dirname(__file__), "static",
                            "index.html")
        with open(path) as f:
            return web.Response(text=f.read(), content_type="text/html")

    @routes.get("/api/v0/healthz")
    async def healthz(request):
        return _json_response({"status": "ok"})

    def _listing(fn):
        async def handler(request):
            limit = request.query.get("limit")
            rows = await asyncio.get_running_loop().run_in_executor(
                None, lambda: fn(limit=int(limit) if limit else None)
            )
            return _json_response(rows)

        return handler

    routes.get("/api/v0/nodes")(_listing(state.list_nodes))
    routes.get("/api/v0/actors")(_listing(state.list_actors))
    routes.get("/api/v0/tasks")(_listing(state.list_tasks))
    routes.get("/api/v0/placement_groups")(
        _listing(state.list_placement_groups)
    )
    routes.get("/api/v0/jobs")(_listing(state.list_jobs))

    # One memview_cluster scrape is a cluster-wide fan-out (every
    # raylet, worker, and driver): the objects and memory tabs polling
    # every 5s must share ONE recent scrape, not trigger one each. The
    # lock serializes concurrent misses (handlers run on executor
    # threads) so two viewers share a single fan-out.
    _memview_cache = {"ts": 0.0, "data": None}
    _memview_cache_lock = threading.Lock()

    def _object_summary_cached() -> dict:
        with _memview_cache_lock:
            now = time.monotonic()
            if _memview_cache["data"] is not None \
                    and now - _memview_cache["ts"] < 4.0:
                return _memview_cache["data"]
            data = state.object_summary()
            _memview_cache["ts"] = time.monotonic()
            _memview_cache["data"] = data
            return data

    @routes.get("/api/v0/objects")
    async def objects(request):
        """Object lifecycle rows from the memory observatory (state,
        size, owner, refs, locations, creation callsite). The bare GCS
        directory is the fallback BOTH when the memview scrape fails
        and when it has no rows — a native-store cluster
        (slab_arena=0) reports workers but no store ledger, and an
        empty lifecycle listing must not mask live directory entries."""
        limit = request.query.get("limit")
        limit = int(limit) if limit else 500

        def run():
            try:
                rows = (_object_summary_cached().get("objects")
                        or [])[:limit]
            except Exception:
                logging.getLogger(__name__).warning(
                    "memview scrape failed; serving the bare object "
                    "directory", exc_info=True)
                rows = []
            return rows or state.list_objects(limit=limit)

        out = await asyncio.get_running_loop().run_in_executor(None, run)
        return _json_response(out)

    @routes.get("/api/v0/memory")
    async def memory(request):
        """Memory observatory for the Memory tab: object lifecycle rows,
        per-node arena introspection (dead ranges, fragmentation, pool),
        the flow log, and leak/pressure verdicts — one memview_cluster
        scrape (what `ray_tpu_torch memory` prints)."""
        group_by = request.query.get("group_by") or None

        def run():
            from ray_tpu_torch._private import memview

            merged = dict(_object_summary_cached())
            if group_by:
                merged["groups"] = memview.group_objects(
                    merged.get("objects") or [], group_by)
            return merged

        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, run)
        except ValueError as e:
            return _json_response({"error": str(e)}, status=400)
        return _json_response(out)

    @routes.get("/api/v0/tasks/summarize")
    async def summarize(request):
        out = await asyncio.get_running_loop().run_in_executor(
            None, state.summarize_tasks
        )
        return _json_response(out)

    @routes.get("/api/v0/timeline")
    async def timeline(request):
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.timeline(None)
        )
        return _json_response(out)

    @routes.get("/api/v0/train")
    async def train_summary(request):
        """Step observatory summary for the Train tab: merged collectives
        with skew attribution, per-rank straggler scores, step phases,
        compile events (one steptrace_cluster scrape). This is a POLLING
        surface (5s SPA auto-refresh rendering only the top slices), so
        the merge is capped to the newest records by default; ?limit=0
        uncaps it."""
        try:
            limit = int(request.query.get("limit", "20000"))
        except ValueError:
            return _json_response({"error": "limit must be an integer"},
                                  status=400)
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.steptrace_summary(limit=limit or None)
        )
        return _json_response(out)

    @routes.get("/api/v0/train_timeline")
    async def train_timeline(request):
        """Merged multi-rank step timeline as Chrome-trace JSON
        (Perfetto-loadable; what `ray_tpu_torch train timeline` writes)."""
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.train_timeline(None)
        )
        return _json_response(out)

    @routes.get("/api/v0/serve_requests")
    async def serve_requests(request):
        """Request observatory for the Serve tab: per-request phase
        rows joined by request id, per-deployment p50/p95/p99 + TTFT,
        per-replica phase profiles, and slow-replica skew verdicts (one
        reqtrace_cluster scrape — what `ray_tpu_torch serve requests` prints).
        A POLLING surface (5s SPA auto-refresh), so the merge is capped
        to the newest records by default; ?limit=0 uncaps it."""
        try:
            limit = int(request.query.get("limit", "20000"))
        except ValueError:
            return _json_response({"error": "limit must be an integer"},
                                  status=400)
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.serve_summary(limit=limit or None)
        )
        return _json_response(out)

    @routes.get("/api/v0/serve_timeline")
    async def serve_timeline(request):
        """Merged per-request serve timeline as Chrome-trace JSON
        (Perfetto-loadable; what `ray_tpu_torch serve timeline` writes)."""
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.request_timeline(None)
        )
        return _json_response(out)

    @routes.get("/api/v0/metrics")
    async def metrics(request):
        from ray_tpu_torch.util import metrics as m

        out = await asyncio.get_running_loop().run_in_executor(
            None, m.list_metrics
        )
        return _json_response(out)

    @routes.get("/api/v0/serve_llm")
    async def serve_llm(request):
        """LLM serving slice of the cluster metrics scrape: KV page-state
        gauges, per-replica prefix hit rate, batch occupancy, token/shed
        counters — the same numbers `ray_tpu_torch serve llm` prints."""
        from ray_tpu_torch.util import metrics as m

        def _slice():
            return {name: entry.get("series", [])
                    for name, entry in m.metrics_summary().items()
                    if name.startswith(("kv_cache", "serve_llm"))}

        out = await asyncio.get_running_loop().run_in_executor(None, _slice)
        return _json_response(out)

    def _prom_text() -> str:
        """Merged cluster scrape (runtime + user metrics via the GCS
        fan-out) + synthesized cluster built-ins, as one exposition."""
        from ray_tpu_torch._private import metrics_core
        from ray_tpu_torch.dashboard.prometheus import (
            cluster_builtin_metrics,
            render_metrics,
        )
        from ray_tpu_torch.util import metrics as m

        merged = m.cluster_snapshot().get("merged", {})
        records = metrics_core.snapshot_records(merged)
        records.update(cluster_builtin_metrics())
        return render_metrics(records)

    @routes.get("/metrics")
    async def prometheus_metrics(request):
        """Prometheus text exposition: runtime + user metrics from ONE
        cluster-wide scrape, plus cluster built-ins (ray parity: the
        per-node metrics agent's scrape endpoint, lifted cluster-wide)."""
        text = await asyncio.get_running_loop().run_in_executor(
            None, _prom_text)
        return web.Response(
            text=text, content_type="text/plain", charset="utf-8"
        )

    @routes.get("/api/metrics")
    async def api_metrics(request):
        """The same scrape as /metrics; ?format=json returns the compact
        summary (counters/gauges -> value, histograms -> p50/p95/p99)."""
        if request.query.get("format") == "json":
            from ray_tpu_torch.util import metrics as m

            out = await asyncio.get_running_loop().run_in_executor(
                None, m.metrics_summary)
            return _json_response(out)
        text = await asyncio.get_running_loop().run_in_executor(
            None, _prom_text)
        return web.Response(text=text, content_type="text/plain",
                            charset="utf-8")

    @routes.get("/api/v0/metrics_history")
    async def metrics_history(request):
        """The in-head snapshot ring (see _metrics_history): a list of
        {ts, metrics} summaries the SPA renders as sparklines."""
        return _json_response(list(_metrics_history))

    @routes.get("/api/v0/logs")
    async def logs_listing(request):
        """Cluster log listing: head fans to every node agent
        (?node_id= narrows, prefix ok)."""
        node_id = request.query.get("node_id")
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.list_logs(node_id=node_id)
        )
        return _json_response(out)

    @routes.get("/api/v0/logs/tail")
    async def logs_tail(request):
        """Tail one log file anywhere in the cluster:
        ?node_id=&file=&lines=N."""
        q = request.query
        if not q.get("file"):
            return _json_response({"error": "file required"}, status=400)
        try:
            lines = int(q.get("lines", "100"))
        except ValueError:
            return _json_response({"error": "lines must be an integer"},
                                  status=400)
        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: state.get_log(
                    filename=q["file"], node_id=q.get("node_id") or None,
                    tail=lines,
                )
            )
        except Exception as e:
            return _json_response({"error": str(e)}, status=404)
        return _json_response({"file": q["file"], "lines": out})

    @routes.get("/api/v0/logs/task")
    async def logs_task(request):
        """A task's exact output via its attribution span:
        ?task_id=<hex> (or ?actor_id=<hex> for the actor's worker log)."""
        q = request.query
        task_id = q.get("task_id") or None
        actor_id = q.get("actor_id") or None
        if not task_id and not actor_id:
            return _json_response({"error": "task_id or actor_id required"},
                                  status=400)
        try:
            tail = int(q["tail"]) if q.get("tail") else None
        except ValueError:
            return _json_response({"error": "tail must be an integer"},
                                  status=400)
        try:
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: state.get_log(task_id=task_id,
                                            actor_id=actor_id, tail=tail)
            )
        except Exception as e:
            return _json_response({"error": str(e)}, status=404)
        return _json_response({"task_id": task_id, "actor_id": actor_id,
                               "lines": out})

    @routes.get("/api/v0/stacks")
    async def stacks(request):
        node_id = request.query.get("node_id")
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: state.get_stacks(node_id=node_id)
        )
        return _json_response(out)

    @routes.get("/api/v0/events")
    async def events(request):
        from ray_tpu_torch.util import events as ev

        limit = request.query.get("limit")
        out = await asyncio.get_running_loop().run_in_executor(
            None, lambda: ev.list_events(limit=int(limit) if limit else 100)
        )
        return _json_response(out)

    @routes.get("/api/profile/cpu")
    async def profile_cpu(request):
        """On-demand cluster CPU flamegraph (ray parity: the dashboard's
        py-spy attach). ?duration=&hz=&node_id=&actor_id=&format=
        json|speedscope|collapsed."""
        from ray_tpu_torch.util import profiling

        q = request.query
        try:
            duration = min(float(q.get("duration", 2.0)), 60.0)
            hz = float(q["hz"]) if q.get("hz") else None
        except ValueError:
            return _json_response(
                {"error": "duration and hz must be numbers"}, status=400)
        fmt = q.get("format", "json")

        def run():
            return profiling.profile_cpu(
                duration=duration,
                hz=hz,
                node_id=q.get("node_id") or None,
                actor_id=q.get("actor_id") or None,
                include_gcs=q.get("include_gcs") in ("1", "true"),
            )

        prof = await asyncio.get_running_loop().run_in_executor(None, run)
        if fmt == "speedscope":
            return _json_response(prof.speedscope())
        if fmt == "collapsed":
            return web.Response(text=prof.collapsed(),
                                content_type="text/plain")
        return _json_response(prof.raw)

    @routes.get("/api/profile/memory")
    async def profile_memory(request):
        """On-demand cluster memory diff (tracemalloc top-N sites).
        ?duration=&node_id=&actor_id=."""
        from ray_tpu_torch.util import profiling

        q = request.query
        try:
            duration = min(float(q.get("duration", 2.0)), 60.0)
        except ValueError:
            return _json_response(
                {"error": "duration must be a number"}, status=400)

        def run():
            return profiling.profile_memory(
                duration=duration,
                node_id=q.get("node_id") or None,
                actor_id=q.get("actor_id") or None,
                include_gcs=q.get("include_gcs") in ("1", "true"),
            )

        prof = await asyncio.get_running_loop().run_in_executor(None, run)
        return _json_response(prof.raw)

    @routes.get("/api/v0/cluster_resources")
    async def cluster_resources(request):
        import ray_tpu_torch

        loop = asyncio.get_running_loop()
        total = await loop.run_in_executor(None, ray_tpu_torch.cluster_resources)
        avail = await loop.run_in_executor(None, ray_tpu_torch.available_resources)
        return _json_response({"total": total, "available": avail})

    app = web.Application()
    app.add_routes(routes)
    return app


class _DashboardServer:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._loop = None
        self._error: Optional[BaseException] = None
        self._history_task = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="dashboard-head", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=30) or self._error is not None:
            raise RuntimeError(
                f"dashboard failed to start on {host}:{port}: "
                f"{self._error or 'timed out'}"
            )

    def _run(self):
        from aiohttp import web

        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def serve():
            runner = web.AppRunner(_build_app())
            await runner.setup()
            site = web.TCPSite(runner, self.host, self.port)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]
            self._started.set()
            self._history_task = asyncio.get_running_loop().create_task(
                self._history_loop())

        try:
            self._loop.run_until_complete(serve())
        except BaseException as e:  # surface bind/setup errors to __init__
            self._error = e
            self._started.set()
            return
        self._loop.run_forever()

    async def _history_loop(self):
        """Periodically fold one merged cluster scrape into the in-head
        ring (sparkline time-series source). Scrape failures (GCS
        restarting, teardown races) skip the tick — the ring must only
        ever hold real snapshots."""
        global _metrics_history

        from ray_tpu_torch._private import metrics_core
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

        # deque maxlen is fixed at construction: rebuild the ring to the
        # configured depth (the route reads the module global each call)
        keep = max(2, int(cfg.metrics_history_len))
        _metrics_history = deque(maxlen=keep)

        def scrape():
            from ray_tpu_torch.util import metrics as m

            snap = m.cluster_snapshot()
            return {
                "ts": time.time(),
                "processes": sum(
                    1 for p in snap.get("processes", ())
                    if not p.get("error")),
                "metrics": metrics_core.summarize(snap.get("merged", {})),
            }

        loop = asyncio.get_running_loop()
        while True:
            # the master switch gates the recurring fan-out too — a
            # disabled plane must not keep paying the cluster scrape
            if cfg.metrics_enabled:
                try:
                    entry = await loop.run_in_executor(None, scrape)
                    _metrics_history.append(entry)
                except Exception:
                    pass
            await asyncio.sleep(cfg.metrics_history_interval_s)

    def _shutdown(self):
        # runs ON the loop: cancel the history task first so it unwinds
        # (its wakeup is queued ahead of the stop callback), then stop
        if self._history_task is not None:
            self._history_task.cancel()
        self._loop.call_soon(self._loop.stop)

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._shutdown)


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the JSON API server; returns the bound port. Requires a
    connected driver (ray_tpu_torch.init first)."""
    global _server
    if _server is not None:
        return _server.port
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    server = _DashboardServer(host, port)  # raises on bind/setup failure
    _server = server
    return _server.port


def stop_dashboard():
    global _server
    if _server is not None:
        _server.stop()
        _server = None
