"""Per-node dashboard agent.

ray parity: dashboard/agent.py (the per-node agent process serving
node-local HTTP: stats, log listing/tailing, profiling) — one agent
subprocess per raylet, spawned and owned by it. Node-local data never
transits the head: operators (or the dashboard head acting as a proxy)
hit the agent directly.

Routes:
  GET /api/v0/node    — node stats (via the local raylet's node_stats RPC)
  GET /api/v0/stacks  — local workers' thread dumps
  GET /api/v0/profile?kind=cpu|mem&duration=N — node-local profiling
      window (raylet + its workers; see _private/profiler.py)
  GET /metrics        — node-local Prometheus scrape (raylet + workers,
      merged; also at /api/v0/metrics, ?format=json for raw snapshots)
  GET /api/v0/steptrace — node-local step-observatory rings (this
      raylet's workers; cross-rank skew merges at the GCS)
  GET /api/v0/memview — node-local memory observatory (this raylet's
      store ledger + arena introspection + its workers' owner tables;
      cluster-wide leak verdicts merge at the GCS)
  GET /api/v0/reqtrace — node-local request observatory (this raylet's
      workers' serve trace rings; cross-process request-id joins merge
      at the GCS)
  GET /api/v0/logs    — session log files (name, size)
  GET /api/v0/logs/tail?file=<name>&lines=N — tail one log file
  GET /api/v0/logs/range?file=<name>&start=A&end=B — exact byte range
      (the log plane's per-task attribution spans resolve through this)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
from typing import List, Optional, Tuple

# hard ceiling on one range/tail read (a bad span or a huge `lines`
# must not buffer an entire multi-GB log into one HTTP response)
MAX_READ_BYTES = 8 * 1024 * 1024


def _json(payload, status=200):
    from aiohttp import web

    return web.Response(
        text=json.dumps(payload, default=str),
        content_type="application/json", status=status,
    )


def safe_log_name(name: str) -> bool:
    """Session-log filenames only: no traversal, no absolute paths, no
    dotfiles (the token file lives one directory up)."""
    return bool(name) and "/" not in name and "\\" not in name \
        and not name.startswith(".")


def tail_file(path: str, lines: int) -> Tuple[List[str], int]:
    """Last ``lines`` full lines of ``path``. The read window SCALES with
    the request (doubling until enough newlines are in view or BOF) —
    the old fixed 256 KiB window silently truncated large requests — and
    a window that starts mid-file drops its torn leading partial line.
    Returns (lines, start_offset_of_first_returned_byte, end_offset)."""
    lines = max(1, min(int(lines), 100_000))
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        window = min(max(64 * 1024, lines * 256), MAX_READ_BYTES)
        while True:
            start = max(0, size - window)
            f.seek(start)
            data = f.read(size - start)
            # need lines+1 newlines so `lines` COMPLETE lines survive
            # dropping the torn head; at BOF or the byte ceiling, take
            # what is there
            if start == 0 or data.count(b"\n") > lines \
                    or window >= MAX_READ_BYTES:
                break
            window *= 2
    raw = data.split(b"\n")
    if start > 0:
        start += len(raw[0]) + 1
        raw = raw[1:]  # torn leading partial line
    if raw and not raw[-1]:
        raw.pop()  # trailing newline artifact
    cut = raw[-lines:]
    start += sum(len(r) + 1 for r in raw[: len(raw) - len(cut)])
    return [r.decode("utf-8", "replace") for r in cut], start, size


def read_range(path: str, start: int, end: int) -> bytes:
    """Exact byte range [start, end) of a log file, ceiling-capped."""
    start = max(0, int(start))
    end = max(start, int(end))
    with open(path, "rb") as f:
        f.seek(start)
        return f.read(min(end - start, MAX_READ_BYTES))


class Agent:
    def __init__(self, raylet_port: int, session_dir: str):
        self.raylet_port = raylet_port
        self.session_dir = session_dir
        self._conn = None

    async def _raylet(self):
        if self._conn is None or self._conn.closed:
            from ray_tpu_torch._private.rpcio import connect

            self._conn = await connect("127.0.0.1", self.raylet_port)
        return self._conn

    async def node(self, request):
        conn = await self._raylet()
        return _json(await conn.request("node_stats", {}, timeout=30))

    async def stacks(self, request):
        conn = await self._raylet()
        return _json(await conn.request("node_stacks", {}, timeout=30))

    async def profile(self, request):
        """Node-local profiling window (this raylet + its workers) —
        the per-node analog of the head's /api/profile/*:
        ?kind=cpu|mem&duration=&hz=."""
        q = request.query
        kind = q.get("kind", "cpu")
        if kind not in ("cpu", "mem"):
            return _json({"error": "kind must be cpu or mem"}, status=400)
        try:
            duration = min(float(q.get("duration", "2")), 60.0)
            hz = float(q["hz"]) if q.get("hz") else None
        except ValueError:
            return _json({"error": "duration and hz must be numbers"},
                         status=400)
        payload = {"kind": kind, "duration": duration}
        if hz is not None:
            payload["hz"] = hz
        conn = await self._raylet()
        reply = await conn.request("profile_node", payload,
                                   timeout=duration + 45)
        return _json(reply)

    async def metrics(self, request):
        """Node-local Prometheus scrape: this raylet + its workers,
        merged (the per-node analog of the head's /metrics — a stock
        Prometheus scrape_config can target every node agent directly).
        ?format=json returns the raw per-process snapshots."""
        from aiohttp import web

        from ray_tpu_torch._private import metrics_core
        from ray_tpu_torch.dashboard.prometheus import render_metrics

        conn = await self._raylet()
        reply = await conn.request("metrics_node", {}, timeout=30)
        processes = reply.get("processes") or []
        if request.query.get("format") == "json":
            return _json(reply)
        merged = metrics_core.merge_snapshots(
            [p.get("metrics") or {} for p in processes
             if not p.get("error")])
        text = render_metrics(metrics_core.snapshot_records(merged))
        return web.Response(text=text, content_type="text/plain",
                            charset="utf-8")

    async def steptrace(self, request):
        """Node-local step-observatory snapshot: this raylet's workers'
        telemetry rings (collective ops, step phases, compile events) —
        the per-node analog of the head's /api/v0/train. Cross-rank skew
        needs the GCS merge; this surface is for poking one node."""
        conn = await self._raylet()
        return _json(await conn.request("steptrace_node", {}, timeout=30))

    async def memview(self, request):
        """Node-local memory observatory: the store ledger's object
        rows, arena segment introspection (dead ranges, pool, per-client
        charge), and this node's workers' owner tables — the per-node
        analog of the head's /api/v0/memory. Cluster-wide leak verdicts
        need the GCS merge; this surface is for poking one node."""
        conn = await self._raylet()
        return _json(await conn.request("memview_node", {}, timeout=30))

    async def reqtrace(self, request):
        """Node-local request-observatory snapshot: this raylet's
        workers' serve trace rings (proxies and replicas are actors in
        worker processes) — the per-node analog of the head's
        /api/v0/serve_requests. Cross-process request joins need the
        GCS merge; this surface is for poking one node."""
        conn = await self._raylet()
        return _json(await conn.request("reqtrace_node", {}, timeout=30))

    async def logs(self, request):
        log_dir = os.path.join(self.session_dir, "logs")
        out = []
        try:
            for name in sorted(os.listdir(log_dir)):
                full = os.path.join(log_dir, name)
                if os.path.isfile(full):
                    out.append({"file": name, "bytes": os.path.getsize(full)})
        except OSError:
            pass
        return _json(out)

    def _log_path(self, request):
        name = request.query.get("file", "")
        if not safe_log_name(name):
            return None, _json({"error": "bad file name"}, status=400)
        return os.path.join(self.session_dir, "logs", name), None

    async def tail(self, request):
        path, err = self._log_path(request)
        if err is not None:
            return err
        try:
            lines = int(request.query.get("lines", "100"))
        except ValueError:
            return _json({"error": "lines must be an integer"}, status=400)
        try:
            out, start, end = tail_file(path, lines)
        except OSError:
            return _json({"error": "no such log"}, status=404)
        return _json({"file": request.query["file"], "lines": out,
                      "start": start, "end": end})

    async def range(self, request):
        """Exact byte range of one log file — how per-task attribution
        spans (log_file, log_start, log_end on task events) resolve to
        the task's actual output."""
        path, err = self._log_path(request)
        if err is not None:
            return err
        try:
            start = int(request.query.get("start", "0"))
            end = int(request.query.get("end", "0"))
        except ValueError:
            return _json({"error": "start/end must be integers"}, status=400)
        try:
            data = read_range(path, start, end)
        except OSError:
            return _json({"error": "no such log"}, status=404)
        text = data.decode("utf-8", "replace")
        out = text.split("\n")
        if out and not out[-1]:
            out.pop()
        # end_complete: offset just past the last NEWLINE in the range —
        # followers resume there so a line caught mid-write is never
        # yielded as two torn halves
        last_nl = data.rfind(b"\n")
        end_complete = start + (last_nl + 1 if last_nl >= 0 else 0)
        return _json({"file": request.query["file"], "start": start,
                      "bytes": len(data), "end_complete": end_complete,
                      "lines": out})


async def amain(args) -> None:
    # Capture the owner's pid FIRST: if the raylet is SIGKILLed during our
    # startup window, a later getppid() would already read the reparented
    # value (1) and the orphan check below would never fire.
    ppid = os.getppid()

    from aiohttp import web

    agent = Agent(args.raylet_port, args.session_dir)
    app = web.Application()
    app.router.add_get("/api/v0/node", agent.node)
    app.router.add_get("/api/v0/stacks", agent.stacks)
    app.router.add_get("/api/v0/profile", agent.profile)
    app.router.add_get("/metrics", agent.metrics)
    app.router.add_get("/api/v0/metrics", agent.metrics)
    app.router.add_get("/api/v0/steptrace", agent.steptrace)
    app.router.add_get("/api/v0/memview", agent.memview)
    app.router.add_get("/api/v0/reqtrace", agent.reqtrace)
    app.router.add_get("/api/v0/logs", agent.logs)
    app.router.add_get("/api/v0/logs/tail", agent.tail)
    app.router.add_get("/api/v0/logs/range", agent.range)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", args.port)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)
    # Park until the owning raylet goes away. Normal shutdown kills us
    # explicitly, but a SIGKILLed raylet (chaos tests, OOM killer) cannot —
    # detect that by watching for reparenting: the raylet spawns the agent
    # as a direct child, so a PPID change means the owner is gone. Without
    # this, every killed node leaks an agent process that lingers and
    # re-dials its old raylet port after the port number is recycled.
    while os.getppid() == ppid:
        await asyncio.sleep(2.0)


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default="")
    args = parser.parse_args(argv)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
