"""Synthetic serve load harness: an open-loop asyncio HTTP client.

Every serve change is to be measured under load; this is the measuring
device. It drives a real deployment through the real proxy with an
OPEN-LOOP arrival process — request i is launched at ``t0 + i/rps``
regardless of completions, the way independent internet clients arrive —
so queueing delay shows up in the latency histogram instead of throttling
the offered load (the classic closed-loop coordination blindspot). A
``TCPConnector`` sized to ``connections`` keeps 1k+ concurrent sockets
open when the service lags the offered rate.

Per request it records send time, time to first body byte (TTFT — for
chunked streaming responses this is the first token), completion time,
status, and the ``x-request-id`` the proxy minted (so a slow outlier can
be looked up in ``ray_tpu_torch serve requests --slow`` by id). A sampler
coroutine polls a caller-provided gauge reader (the bench lane passes a
cluster-scrape of ``serve_replica_queue_depth``) into a
queue-depth-over-time series.

Used by ``chip_smoke.py``'s autoscaling phase and importable for ad-hoc A/Bs:

    from ray_tpu_torch.serve.load_harness import run_load
    out = run_load(url, rps=200, duration_s=10, connections=1024)
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["run_load", "run_load_async", "percentiles"]


def percentiles(vals: List[float]) -> Dict[str, float]:
    # one percentile formula for the whole observatory: the bench lanes
    # compare harness numbers against reqtrace's merge output
    from ray_tpu_torch._private.reqtrace import _pct

    if not vals:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                "p99": 0.0, "max": 0.0}
    s = sorted(vals)
    return {"count": len(s), "mean": sum(s) / len(s),
            "p50": _pct(s, 0.50), "p95": _pct(s, 0.95),
            "p99": _pct(s, 0.99), "max": s[-1]}


async def run_load_async(
    url: str,
    rps: float = 100.0,
    duration_s: float = 10.0,
    connections: int = 1024,
    method: str = "GET",
    payload: Optional[bytes] = None,
    timeout_s: float = 30.0,
    depth_sampler: Optional[Callable[[], Any]] = None,
    depth_sample_interval_s: float = 1.0,
    payloads: Optional[Sequence[bytes]] = None,
    keep_bodies: bool = False,
) -> Dict[str, Any]:
    """Open-loop load: ``rps * duration_s`` requests launched on a fixed
    schedule; returns latency/TTFT percentiles, error counts, achieved
    rps, peak in-flight, and the sampled queue-depth series. Request i
    sends ``payloads[i % len(payloads)]`` where given (else ``payload``);
    with ``keep_bodies`` the result also holds every answered request's
    ``{"i", "status", "body"}`` under ``bodies``, in order of i, so a
    caller can check what each answer said."""
    import aiohttp

    n_total = max(1, int(rps * duration_s))
    interval = 1.0 / max(rps, 1e-9)
    results: List[tuple] = []  # (ok, latency, ttft, status)
    errors: Dict[str, int] = {}
    inflight = 0
    peak_inflight = 0
    depth_series: List[dict] = []
    slow_rids: List[tuple] = []  # (latency, rid) worst observed
    bodies: List[dict] = []

    conn = aiohttp.TCPConnector(limit=connections, force_close=False)
    tmo = aiohttp.ClientTimeout(total=timeout_s)
    t0 = time.perf_counter()

    async def one(i: int, session):
        nonlocal inflight, peak_inflight
        # open-loop schedule: wait until this request's arrival time
        delay = t0 + i * interval - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        inflight += 1
        peak_inflight = max(peak_inflight, inflight)
        t_send = time.perf_counter()
        ttft = None
        data = payloads[i % len(payloads)] if payloads else payload
        try:
            async with session.request(method, url, data=data) as resp:
                rid = resp.headers.get("x-request-id", "")
                # first body byte = TTFT (streaming: the first token)
                chunk = await resp.content.readany()
                ttft = time.perf_counter() - t_send
                body = []
                while chunk:
                    if keep_bodies:
                        body.append(chunk)
                    chunk = await resp.content.readany()
                latency = time.perf_counter() - t_send
                if keep_bodies:
                    bodies.append({"i": i, "status": resp.status,
                                   "body": b"".join(body)})
                ok = resp.status < 500
                results.append((ok, latency, ttft, resp.status))
                if not ok:
                    errors[f"http_{resp.status}"] = errors.get(
                        f"http_{resp.status}", 0) + 1
                elif rid:
                    slow_rids.append((latency, rid))
                    if len(slow_rids) > 256:
                        slow_rids.sort(reverse=True)
                        del slow_rids[64:]
        except Exception as e:  # noqa: BLE001 — tally, keep offering load
            results.append((False, time.perf_counter() - t_send, ttft, 0))
            key = type(e).__name__
            errors[key] = errors.get(key, 0) + 1
        finally:
            inflight -= 1

    async def sample_depth():
        while True:
            await asyncio.sleep(depth_sample_interval_s)
            try:
                loop = asyncio.get_running_loop()
                depth = await loop.run_in_executor(None, depth_sampler)
            except Exception:
                depth = None
            depth_series.append({
                "t": round(time.perf_counter() - t0, 3),
                "depth": depth,
                "client_inflight": inflight,
            })

    sampler_task = None
    async with aiohttp.ClientSession(connector=conn, timeout=tmo) as sess:
        if depth_sampler is not None:
            sampler_task = asyncio.ensure_future(sample_depth())
        try:
            await asyncio.gather(*(one(i, sess) for i in range(n_total)))
        finally:
            if sampler_task is not None:
                sampler_task.cancel()
    wall = time.perf_counter() - t0

    lat_ok = [r[1] for r in results if r[0]]
    ttft_ok = [r[2] for r in results if r[0] and r[2] is not None]
    n_ok = sum(1 for r in results if r[0])
    slow_rids.sort(reverse=True)
    out = {
        "offered_rps": rps,
        "requests": n_total,
        "ok": n_ok,
        "errors": sum(errors.values()),
        "error_kinds": errors,
        "wall_s": round(wall, 3),
        "achieved_rps": round(n_ok / wall, 1) if wall > 0 else 0.0,
        "peak_inflight": peak_inflight,
        "connections": connections,
        "latency": percentiles(lat_ok),
        "ttft": percentiles(ttft_ok),
        "queue_depth_series": depth_series,
        "slowest": [{"latency_s": round(lat, 4), "rid": rid}
                    for lat, rid in slow_rids[:10]],
    }
    if keep_bodies:
        out["bodies"] = sorted(bodies, key=lambda b: b["i"])
    return out


def run_load(url: str, **kwargs) -> Dict[str, Any]:
    """Sync wrapper around ``run_load_async`` (fresh event loop)."""
    return asyncio.run(run_load_async(url, **kwargs))
