"""Core-API microbenchmarks (``ray_tpu_torch microbenchmark``).

Reference parity: ray python/ray/_private/ray_perf.py:93-311 (`ray
microbenchmark`) — the standard suite of control-plane throughput numbers:
task submission (sync/async), actor calls (1:1 and async), put/get of
small objects, and put gigabytes. Values are machine-dependent; the suite
exists so scheduler/runtime regressions show up as numbers, not vibes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np


def _timeit(name: str, fn: Callable[[], int], warmup: int = 1,
            repeat: int = 3) -> Tuple[str, float]:
    """fn runs one batch and returns how many operations it performed;
    report the best ops/s across repeats (like ray_perf's timeit)."""
    for _ in range(warmup):
        fn()
    best = 0.0
    for _ in range(repeat):
        t0 = time.perf_counter()
        n = fn()
        dt = time.perf_counter() - t0
        best = max(best, n / dt)
    return name, best


def _lat_hist():
    """Standalone log2 latency histogram (metrics_core) for per-op tail
    tracking: the sequential benches time EACH op into it so BENCH_CORE
    carries p50/p95/p99, not just the mean ops/s (tail regressions — a
    stalled dispatch pass, a GC pause per N ops — are invisible in
    means). Batched/pipelined benches keep mean-only: a per-op latency
    inside a 1000-deep pipeline measures queue depth, not the runtime."""
    from ray_tpu_torch._private import metrics_core as mc

    return mc.Histogram({}, scale=mc.LATENCY)


def _lat_summary(h) -> dict:
    from ray_tpu_torch._private import metrics_core as mc

    qs = mc.hist_quantiles(h._series(), (0.5, 0.95, 0.99))
    return {"p50_us": round(qs[0.5] * 1e6, 1),
            "p95_us": round(qs[0.95] * 1e6, 1),
            "p99_us": round(qs[0.99] * 1e6, 1)}


def run_object_plane_bench(small: bool = False) -> List[dict]:
    """Dedicated object-plane lane: put / get latency at 100B, 64KB, 1MB
    and 64MB (8MB in --small/CI mode) with p50/p95/p99 via the
    metrics_core histogram path. 100B rides the inline memory store by
    design; the bulk sizes must be slab-backed (arena data path) — each
    row carries ``slab_backed`` so CI can gate the structural invariant,
    not just the throughput."""
    import ray_tpu_torch  # noqa: F401 (cluster must already be initialized)
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    big = ("8MB", 8 << 20, 6) if small else ("64MB", 64 << 20, 8)
    sizes = [
        ("100B", 100, 200 if small else 1000),
        ("64KB", 64 * 1024, 100 if small else 400),
        ("1MB", 1 << 20, 30 if small else 100),
        big,
    ]
    results: List[dict] = []
    for name, size, iters in sizes:
        arr = np.arange(size, dtype=np.uint8)
        hput, hget = _lat_hist(), _lat_hist()
        slab_backed = False
        put_s = get_s = 0.0
        # one warmup op (slab lease, worker pools) outside the clocks
        ray_tpu_torch.get(ray_tpu_torch.put(arr))
        for _ in range(iters):
            t0 = time.perf_counter()
            ref = ray_tpu_torch.put(arr)
            t1 = time.perf_counter()
            got = ray_tpu_torch.get(ref)
            t2 = time.perf_counter()
            hput.record(t1 - t0)
            hget.record(t2 - t1)
            put_s += t1 - t0
            get_s += t2 - t1
            buf = cw._pinned_buffers.get(ref.binary())
            if buf is not None and getattr(buf, "seg_id", None) is not None:
                slab_backed = True
            assert got.nbytes == size
            del ref, got, buf
        for op, h, secs in (("put", hput, put_s), ("get", hget, get_s)):
            row = {"benchmark": f"obj {op} {name}",
                   "value": round(iters / secs, 1) if secs else 0.0,
                   "unit": "ops/s", "bytes": size,
                   "slab_backed": slab_backed}
            row.update(_lat_summary(h))
            results.append(row)
            print(f"obj {op} {name:<6s} {row['value']:>12,.1f} ops/s  "  # lint: allow-print
                  f"p50={row['p50_us']:,.0f}us p95={row['p95_us']:,.0f}us "
                  f"p99={row['p99_us']:,.0f}us slab={slab_backed}")
    return results


def run_transfer_plane_bench(small: bool = False) -> List[dict]:
    """Cross-node transfer lane (arena-to-arena plane): push and pull
    MB/s at 128KB / 1MB / 64MB (8MB in --small/CI mode) between two
    live nodes — 128KB, not 64KB, because anything at or under the
    100KB inline threshold rides task specs / the owner's memory store
    and never touches the transfer plane — p50/p95/p99 per op, plus
    the structural invariant rows ride
    on: on a slab-backed store every cross-node ``fetch`` / ``push_rx``
    flow row must report ``path="arena"`` (receive-side slab assembly —
    heap rows mean the copy path silently came back). Requires an
    initialized cluster with >= 2 alive nodes; each round moves a FRESH
    object so the push dedup / local-copy short-circuits never hide the
    transfer."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    from ray_tpu_torch.util.transfer import push_object

    me = ray_tpu_torch.get_runtime_context().get_node_id()
    peers = [n["node_id"] for n in ray_tpu_torch.nodes()
             if n["alive"] and n["node_id"] != me]
    if not peers:
        raise RuntimeError(
            "run_transfer_plane_bench needs a second alive node"
        )
    peer = peers[0]

    @ray_tpu_torch.remote
    def _fetch(r):
        return r.nbytes

    big = ("8MB", 8 << 20, 4) if small else ("64MB", 64 << 20, 6)
    sizes = [
        # smallest store-backed size: anything <= the 100KB inline
        # threshold rides the owner's memory store / task specs and
        # never touches the transfer plane at all
        ("128KB", 128 * 1024, 10 if small else 30),
        ("1MB", 1 << 20, 8 if small else 20),
        big,
    ]
    results: List[dict] = []
    for name, size, iters in sizes:
        for op in ("push", "pull"):
            h = _lat_hist()
            best = 0.0
            for i in range(iters):
                arr = np.full(size, (i * 7 + len(name)) % 251, np.uint8)
                ref = ray_tpu_torch.put(arr)
                t0 = time.perf_counter()
                if op == "push":
                    ok = push_object(ref, [peer]) == 1
                else:
                    ok = ray_tpu_torch.get(_fetch.options(
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            peer)
                    ).remote(ref), timeout=120) == size
                dt = time.perf_counter() - t0
                assert ok, (op, name, i)
                h.record(dt)
                best = max(best, size / dt / 1e6)
                del ref
            row = {"benchmark": f"xfer {op} {name}", "value": round(best, 2),
                   "unit": "MB/s", "bytes": size}
            row.update(_lat_summary(h))
            results.append(row)
    # structural invariant: the flow log's receive rows name their path
    time.sleep(0.5)  # let the last push_rx row land in the remote ring
    flows = state.object_summary().get("flows") or []
    rx = [f for f in flows if f.get("kind") in ("fetch", "push_rx")]
    arena_paths = bool(rx) and all(f.get("path") == "arena" for f in rx)
    from ray_tpu_torch._private.worker import global_worker

    slab = bool(getattr(global_worker.core_worker, "arena_enabled", False))
    for row in results:
        row["arena_paths"] = arena_paths
        row["slab_backed"] = slab
        print(f"{row['benchmark']:<16s} {row['value']:>10,.1f} MB/s  "  # lint: allow-print
              f"p50={row['p50_us']:,.0f}us p95={row['p95_us']:,.0f}us "
              f"p99={row['p99_us']:,.0f}us arena={arena_paths}")
    return results


def run_microbenchmarks(select: str = "", small: bool = False) -> List[dict]:
    """Run the suite against an initialized ray_tpu_torch cluster. ``select``
    substring-filters benchmark names; ``small`` shrinks batch sizes (CI)."""
    import ray_tpu_torch

    results: List[dict] = []
    batch = 100 if small else 1000
    data_mb = 10 if small else 100

    @ray_tpu_torch.remote
    def nop(*_a):
        return b"ok"

    @ray_tpu_torch.remote
    class Sink:
        def ping(self, *_a):
            return b"ok"

        async def aping(self):
            return b"ok"

    def record(name, ops_s, unit="ops/s", lat=None):
        row = {"benchmark": name, "value": round(ops_s, 1), "unit": unit}
        tail = ""
        if lat is not None and lat.count():
            row.update(_lat_summary(lat))
            tail = (f"  p50={row['p50_us']:,.0f}us "
                    f"p95={row['p95_us']:,.0f}us "
                    f"p99={row['p99_us']:,.0f}us")
        results.append(row)
        # CLI table output (ray_tpu_torch microbenchmark prints to stdout)
        print(f"{name:<42s} {ops_s:>12,.1f} {unit}{tail}")  # lint: allow-print

    benches: Dict[str, Tuple[str, Callable[[], Tuple[str, float]]]] = {}

    def bench(key, display):
        def deco(fn):
            benches[key] = (display, fn)
            return fn
        return deco

    @bench("single_client_tasks_sync", "single client tasks sync")
    def _tasks_sync():
        h = _lat_hist()

        def run():
            for _ in range(batch // 10):
                t0 = time.perf_counter()
                ray_tpu_torch.get(nop.remote())
                h.record(time.perf_counter() - t0)
            return batch // 10
        return _timeit("single client tasks sync", run) + (h,)

    @bench("single_client_tasks_async", "single client tasks async")
    def _tasks_async():
        def run():
            ray_tpu_torch.get([nop.remote() for _ in range(batch)])
            return batch
        return _timeit("single client tasks async", run)

    @bench("actor_calls_sync_1_1", "1:1 actor calls sync")
    def _actor_sync():
        a = Sink.remote()
        ray_tpu_torch.get(a.ping.remote())
        h = _lat_hist()

        def run():
            for _ in range(batch // 10):
                t0 = time.perf_counter()
                ray_tpu_torch.get(a.ping.remote())
                h.record(time.perf_counter() - t0)
            return batch // 10
        out = _timeit("1:1 actor calls sync", run)
        ray_tpu_torch.kill(a)
        return out + (h,)

    @bench("actor_calls_async_1_1", "1:1 actor calls async")
    def _actor_async():
        a = Sink.remote()
        ray_tpu_torch.get(a.ping.remote())

        def run():
            ray_tpu_torch.get([a.ping.remote() for _ in range(batch)])
            return batch
        out = _timeit("1:1 actor calls async", run)
        ray_tpu_torch.kill(a)
        return out

    @bench("actor_calls_async_n_n", "n:n actor calls async")
    def _actor_nn():
        # 4 actors fed concurrently from this client (ray_perf's n:n shape
        # with the caller side folded into one submitting process)
        actors = [Sink.remote() for _ in range(4)]
        ray_tpu_torch.get([a.ping.remote() for a in actors])

        def run():
            refs = []
            for a in actors:
                refs.extend(a.ping.remote() for _ in range(batch // 4))
            ray_tpu_torch.get(refs)
            return (batch // 4) * 4
        out = _timeit("n:n actor calls async", run)
        for a in actors:
            ray_tpu_torch.kill(a)
        return out

    @bench("get_10k_refs", "get 10k small refs")
    def _get_10k():
        n = 1000 if small else 10000
        refs = [ray_tpu_torch.put(b"x" * 100) for _ in range(n)]

        def run():
            got = ray_tpu_torch.get(refs)
            assert len(got) == n
            return n
        return _timeit("get 10k small refs", run)

    @bench("put_small", "small put (100B)")
    def _put_small():
        h = _lat_hist()

        def run():
            for _ in range(batch):
                t0 = time.perf_counter()
                ray_tpu_torch.put(b"x" * 100)
                h.record(time.perf_counter() - t0)
            return batch
        return _timeit("small put (100B)", run) + (h,)

    @bench("put_get_roundtrip", "put+get roundtrip (1KB)")
    def _put_get():
        h = _lat_hist()

        def run():
            for _ in range(batch // 10):
                t0 = time.perf_counter()
                ray_tpu_torch.get(ray_tpu_torch.put(b"x" * 1000))
                h.record(time.perf_counter() - t0)
            return batch // 10
        return _timeit("put+get roundtrip (1KB)", run) + (h,)

    @bench("put_get_1mb_numpy", "put+get 1MB numpy")
    def _put_get_1mb():
        # the zero-copy object-plane latency number: serialize (out-of-band
        # views) -> shm write -> register -> mmap read -> deserialize
        arr = np.arange(1024 * 1024, dtype=np.uint8)
        n = max(1, batch // 10)
        h = _lat_hist()

        def run():
            got = None
            for _ in range(n):
                t0 = time.perf_counter()
                got = ray_tpu_torch.get(ray_tpu_torch.put(arr))
                h.record(time.perf_counter() - t0)
            assert got.nbytes == arr.nbytes
            del got
            return n
        return _timeit("put+get 1MB numpy", run) + (h,)

    @bench("actor_call_1mb_arg", "actor call 1MB arg")
    def _actor_1mb_arg():
        # bulk-argument path: the arg exceeds the inline threshold, so each
        # call ships it through the object plane and the worker maps it
        arr = np.arange(1024 * 1024, dtype=np.uint8)
        a = Sink.remote()
        ray_tpu_torch.get(a.ping.remote())
        n = max(1, batch // 10)

        def run():
            ray_tpu_torch.get([a.ping.remote(arr) for _ in range(n)])
            return n
        out = _timeit("actor call 1MB arg", run)
        ray_tpu_torch.kill(a)
        return out

    @bench("actor_call_64kb_arg", "actor call 64KB arg")
    def _actor_64kb_arg():
        # inline-argument path: below the inline threshold the arg rides the
        # rpc frame itself — out-of-band on v2, so the array is never copied
        # into the pickle stream on send
        arr = np.arange(64 * 1024, dtype=np.uint8)
        a = Sink.remote()
        ray_tpu_torch.get(a.ping.remote())
        n = max(1, batch // 4)

        def run():
            ray_tpu_torch.get([a.ping.remote(arr) for _ in range(n)])
            return n
        out = _timeit("actor call 64KB arg", run)
        ray_tpu_torch.kill(a)
        return out

    @bench("put_gigabytes", "put gigabytes")
    def _put_gb():
        arr = np.zeros(data_mb * 1024 * 1024, dtype=np.uint8)

        def run():
            ref = ray_tpu_torch.put(arr)
            got = ray_tpu_torch.get(ref)
            assert got.nbytes == arr.nbytes
            del ref, got
            return 2 * arr.nbytes  # bytes moved (put + get)
        # warmup=3: the first cycles write fresh tmpfs pages and seed the
        # store's recycling pool; steady-state puts then memcpy into warm
        # pages — the regime a training loop's put/free cadence lives in
        name, bps = _timeit("put gigabytes", run, warmup=3, repeat=3)
        return name, bps / 1e9  # GB/s

    import gc

    for key, (display, fn) in benches.items():
        # match either the registry key or the printed display name
        if select and select not in key and select not in display:
            continue
        # isolate: collect the previous bench's dropped refs and let the
        # resulting free bursts drain before timing the next bench (the
        # 10k-refs teardown otherwise bleeds into put bandwidth)
        gc.collect()
        time.sleep(0.5)
        out = fn()
        name, value = out[0], out[1]
        lat = out[2] if len(out) > 2 else None
        record(name, value, "GB/s" if key == "put_gigabytes" else "ops/s",
               lat=lat)
    if not results:
        print(f"no benchmarks matched --select {select!r}; available: "  # lint: allow-print
              + ", ".join(benches))
    return results


# stage rows for the control-plane lane: display label -> (metric, label
# filter). Remaining labels (node, path, ...) are merged — the lane reports
# the cluster-wide distribution per stage, not per-node shards.
_CP_STAGES = (
    ("id mint", "control_plane_stage_seconds", {"stage": "id_mint"}),
    ("envelope build", "control_plane_stage_seconds",
     {"stage": "envelope_build"}),
    ("submit rpc", "rpc_request_latency_seconds", {"method": "submit_batch"}),
    ("lease wait", "rpc_request_latency_seconds",
     {"method": "lease_workers"}),
    ("dispatch (placement)", "raylet_task_placement_latency_seconds", None),
    ("dispatch (execute rpc)", "rpc_request_latency_seconds",
     {"method": "execute_task"}),
    ("dispatch (batch rpc)", "rpc_request_latency_seconds",
     {"method": "execute_task_batch"}),
    ("submit->run", "control_plane_stage_seconds",
     {"stage": "submit_to_run"}),
    ("result return", "control_plane_stage_seconds",
     {"stage": "result_return"}),
)


def run_control_plane_bench(small: bool = False) -> List[dict]:
    """Control-plane lane (``BENCH_CONTROL_PLANE=1``): run the two
    sync-roundtrip microbenchmarks (the rows the fast-path levers target),
    then scrape the cluster-wide metrics snapshot and report the per-stage
    latency breakdown of one call — envelope build, id mint, submit RPC,
    lease wait, dispatch, result return — from the metrics-core histograms
    every process already records. Requires
    ``RAY_TPU_TORCH_control_plane_stage_timing=1`` exported BEFORE init so the
    driver, raylet and workers all inherit the stage clocks."""
    from ray_tpu_torch._private import metrics_core as mc
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    if not cfg.control_plane_stage_timing:
        raise RuntimeError(
            "control-plane bench needs RAY_TPU_TORCH_control_plane_stage_timing=1 "
            "in the environment before ray_tpu_torch.init() — otherwise the stage "
            "histograms this lane reads are never recorded")

    rows: List[dict] = []
    # substring select would also catch the *_async rows ("async" contains
    # "sync"), so filter by exact registry key, one bench per pass
    for sel in ("single_client_tasks_sync", "actor_calls_sync_1_1"):
        rows.extend(run_microbenchmarks(select=sel, small=small))

    from ray_tpu_torch.util.metrics import cluster_snapshot

    snap = cluster_snapshot().get("merged", {})

    def stage_series(metric: str, want) -> dict:
        """One mergeable series for (metric, label filter): series whose
        tags match ``want`` are folded together across their remaining
        labels (node, path, ...)."""
        acc: dict = {}
        for s in (snap.get(metric) or {}).get("series", ()):
            tags = s.get("tags", {})
            if want and any(tags.get(k) != v for k, v in want.items()):
                continue
            if not acc:
                acc = {"buckets": list(s.get("buckets", ())),
                       "boundaries": list(s.get("boundaries", ())),
                       "count": s.get("count", 0),
                       "sum": s.get("sum", 0.0)}
            elif acc["boundaries"] == list(s.get("boundaries", ())):
                acc["buckets"] = [a + b for a, b in
                                  zip(acc["buckets"], s.get("buckets", ()))]
                acc["count"] += s.get("count", 0)
                acc["sum"] += s.get("sum", 0.0)
        return acc

    print(f"{'stage':<24s} {'calls':>8s} {'mean_us':>10s} "  # lint: allow-print
          f"{'p50_us':>10s} {'p95_us':>10s} {'p99_us':>10s}")
    for label, metric, want in _CP_STAGES:
        s = stage_series(metric, want)
        count = int(s.get("count", 0) or 0)
        row = {"benchmark": f"cp stage {label}", "value": count,
               "unit": "calls"}
        if count:
            qs = mc.hist_quantiles(s, (0.5, 0.95, 0.99))
            row.update({"mean_us": round(s["sum"] / count * 1e6, 1),
                        "p50_us": round(qs[0.5] * 1e6, 1),
                        "p95_us": round(qs[0.95] * 1e6, 1),
                        "p99_us": round(qs[0.99] * 1e6, 1)})
            print(f"{label:<24s} {count:>8d} {row['mean_us']:>10,.1f} "  # lint: allow-print
                  f"{row['p50_us']:>10,.1f} {row['p95_us']:>10,.1f} "
                  f"{row['p99_us']:>10,.1f}")
        else:
            row["note"] = "no samples"
            print(f"{label:<24s} {0:>8d}        (no samples)")  # lint: allow-print
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Collective backend lane (BENCH_COLLECTIVE=1)
# ---------------------------------------------------------------------------


def run_collective_bench(small: bool = False) -> List[dict]:
    """Collective-backend lane: store-path allreduce latency at
    64KB / 1MB / 64MB x {fp32, int8} x world {2, 4} with p50/p95/p99,
    the chunked-vs-monolithic A/B at the top size (the tentpole gate:
    chunked must not lose, target >=1.3x), the int8 wire-compression
    ratio (logical/wire bytes, target >=2x) with a driver-side check
    that the quantized result stays inside the analytic per-block error
    bound, and the skewed-rank sub-lane: one rank's kv_put RPCs are
    slowed through the faultsim machinery and straggler-aware chunk
    ordering (EWMA-reordered fetch schedule) is A/B'd against FIFO.
    ``small`` drops the 64MB size and shrinks iteration counts (CI)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    sizes = [(64 << 10, "64KB", 30), (1 << 20, "1MB", 12),
             (64 << 20, "64MB", 3)]
    if small:
        sizes = [(64 << 10, "64KB", 10), (1 << 20, "1MB", 5)]
    worlds = [2, 4]
    rows: List[dict] = []

    @ray_tpu_torch.remote
    class ColWorker:
        def _rt_init_collective(self, world_size, rank, backend, group_name,
                                epoch=0, quant=""):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(world_size, rank, backend, group_name,
                                      epoch=epoch, quant=quant)
            return rank

        def set_cfg(self, updates):
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            GLOBAL_CONFIG.update(updates)
            return True

        def run_allreduce(self, group, nbytes, iters, seed, op="sum",
                          return_out=False, nudge=False):
            """Time ``iters`` allreduces of an nbytes fp32 tensor; returns
            per-op durations plus this process's wire/logical byte and
            chunk-retry deltas (from the collective transport counters).
            ``nudge`` issues a throwaway kv_del before each op — the hook
            the skew sub-lane's faultsim delay rule latches onto to stall
            ONE rank's op entry (emulating compute skew)."""
            from ray_tpu_torch.util import collective as col
            from ray_tpu_torch.util.collective import collective as colmod

            arr = np.random.RandomState(seed).randn(
                max(1, nbytes // 4)).astype(np.float32)
            m = colmod._metrics()
            w0, l0 = m[0].default._value, m[1].default._value
            r0 = m[2].default._value
            durs, out, cc_done = [], None, []
            for _ in range(iters):
                x = arr.copy()
                if nudge:
                    colmod._kv_del_prefix(b"__skew:nudge__")
                t0 = time.perf_counter()
                out = col.allreduce(x, group, op=op)
                durs.append(time.perf_counter() - t0)
                cc_done.append(dict(colmod._group(group).peer_cc_done))
            res = {"durs": durs, "wire": m[0].default._value - w0,
                   "logical": m[1].default._value - l0,
                   "retries": m[2].default._value - r0,
                   "cc_done": cc_done}
            if return_out:
                res["out"] = np.asarray(out)
            return res

    def _row(name, durs, extra=None):
        d = np.array(durs) * 1e3
        row = {"benchmark": name, "value": round(float(np.median(d)), 3),
               "unit": "ms/op", "p50_ms": round(float(np.percentile(d, 50)), 3),
               "p95_ms": round(float(np.percentile(d, 95)), 3),
               "p99_ms": round(float(np.percentile(d, 99)), 3),
               "iters": len(durs)}
        if extra:
            row.update(extra)
        rows.append(row)
        print(f"{name:<44s} p50={row['p50_ms']:>9,.2f}ms "  # lint: allow-print
              f"p95={row['p95_ms']:>9,.2f}ms p99={row['p99_ms']:>9,.2f}ms"
              + (f"  {extra}" if extra else ""))
        return row

    def _fanout(workers, group, nbytes, iters, op="sum", return_out=False,
                nudge=False):
        outs = ray_tpu_torch.get(
            [w.run_allreduce.remote(group, nbytes, iters, 1000 + r, op,
                                    return_out and r == 0, nudge)
             for r, w in enumerate(workers)], timeout=600)
        return outs

    gates: Dict[str, bool] = {}
    from ray_tpu_torch.util import collective as col

    for world in worlds:
        workers = [ColWorker.remote() for _ in range(world)]
        for grp, quant in ((f"b{world}", ""), (f"q{world}", "int8")):
            col.create_collective_group(workers, world, list(range(world)),
                                        backend="store", group_name=grp,
                                        quant=quant)
        for nbytes, label, iters in sizes:
            # fp32 chunked (default config: 1MB chunks, pipelined)
            outs = _fanout(workers, f"b{world}", nbytes, iters)
            _row(f"allreduce fp32 {label} w{world}", outs[0]["durs"])
            # int8 quantized wire
            outs = _fanout(workers, f"q{world}", nbytes, iters, op="sum",
                           return_out=nbytes <= (1 << 20))
            wire, logical = outs[0]["wire"], outs[0]["logical"]
            ratio = logical / wire if wire else 0.0
            _row(f"allreduce int8 {label} w{world}", outs[0]["durs"],
                 {"wire_bytes": int(wire), "logical_bytes": int(logical),
                  "logical_over_wire": round(ratio, 2)})
            if nbytes == (1 << 20):
                # acceptance: quantized wire bytes <= 0.3x logical
                gates[f"int8_wire_w{world}"] = wire <= 0.3 * logical
            if "out" in outs[0]:
                # analytic per-block bound check against the true sum
                arrs = [np.random.RandomState(1000 + r).randn(
                    max(1, nbytes // 4)).astype(np.float32)
                    for r in range(world)]
                ref = np.sum(np.stack(arrs), axis=0)
                err = float(np.abs(outs[0]["out"] - ref).max())
                scales = [float(np.abs(a).max()) / 127.0 for a in arrs]
                bound = 0.5 * sum(scales) + 0.5 * float(
                    np.abs(ref).max()) / 127.0 + 1e-6
                gates[f"int8_err_{label}_w{world}"] = err <= bound

        # chunked-vs-monolithic A/B at the top size, fp32, best-of-N.
        # Force a chunk size well below the tensor so the "chunked" arm
        # actually chunks even in small mode (1MB tensors are NOT > the
        # 1MB default threshold and would silently route monolithic).
        nbytes, label, iters = sizes[-1]
        ab_chunk = min(cfg.collective_chunk_bytes or (1 << 20),
                       max(nbytes // 8, 64 << 10))
        ray_tpu_torch.get([w.set_cfg.remote({"collective_chunk_bytes": 0})
                     for w in workers], timeout=30)
        mono = _fanout(workers, f"b{world}", nbytes, iters)
        _row(f"allreduce fp32 {label} w{world} monolithic", mono[0]["durs"])
        ray_tpu_torch.get([w.set_cfg.remote({"collective_chunk_bytes": ab_chunk})
                     for w in workers], timeout=30)
        chunked = _fanout(workers, f"b{world}", nbytes, iters)
        _row(f"allreduce fp32 {label} w{world} chunked", chunked[0]["durs"])
        ray_tpu_torch.get([w.set_cfg.remote(
            {"collective_chunk_bytes": cfg.collective_chunk_bytes})
            for w in workers], timeout=30)
        speedup = (min(mono[0]["durs"]) / min(chunked[0]["durs"])
                   if chunked[0]["durs"] else 0.0)
        rows.append({"benchmark": f"chunked speedup {label} w{world}",
                     "value": round(speedup, 2), "unit": "x (best-of-N)",
                     "chunk_bytes": ab_chunk,
                     "mono_best_ms": round(min(mono[0]["durs"]) * 1e3, 2),
                     "chunked_best_ms":
                         round(min(chunked[0]["durs"]) * 1e3, 2)})
        print(f"chunked speedup {label} w{world}: "  # lint: allow-print
              f"{speedup:.2f}x (mono best {min(mono[0]['durs'])*1e3:.1f}ms "
              f"-> chunked best {min(chunked[0]['durs'])*1e3:.1f}ms)")
        if nbytes >= (64 << 20):
            # the acceptance gates apply at the 64MB top size; small mode
            # stops at 1MB, where chunk overhead ~ pipelining win (noise)
            gates[f"chunked_not_slower_w{world}"] = speedup >= 1.0
            if world == 2:
                gates["chunked_speedup_target"] = speedup >= 1.3

    # -- skewed-rank sub-lane: rank 1 enters every op late (a faultsim
    # delay rule stalls its pre-op nudge RPC's write stream, emulating
    # compute skew); straggler-aware chunk deferral vs FIFO, measured on
    # fast rank 0. An allreduce's completion is ALWAYS bound by the
    # slowest contributor (every output chunk depends on the late
    # rank's input), so no fetch schedule can shrink single-op wall
    # clock here and the lane does not gate on it. What deferral buys —
    # and what overlap_grads monetizes — is fast ranks retiring
    # fast-peer work UNDER the straggler's delay instead of serialized
    # after it: FIFO parks the bounded pipeline windows on the late
    # rank's unpublished chunks, starving the fast peer's ready ones.
    # The gate reads rank 0's peer_cc_done: the offset into the fetch
    # loop when the FAST peer's last contribution chunk retired.
    slow_env = {"runtime_env": {"env_vars": {
        "RAY_TPU_TORCH_RPC_FAULTS": "kv_del:delay:1:0:350"}}}
    skew_workers = [ColWorker.remote(),
                    ColWorker.options(**slow_env).remote(),
                    ColWorker.remote()]
    col.create_collective_group(skew_workers, 3, [0, 1, 2],
                                backend="store", group_name="skew")
    sk_bytes = (2 << 20) if small else (4 << 20)
    sk_iters = 4 if small else 6
    sk_cfg = {"collective_chunk_bytes": 64 << 10,
              "collective_pipeline_depth": 2}
    ray_tpu_torch.get([w.set_cfg.remote(dict(sk_cfg,
                                       collective_straggler_threshold=0.0))
                 for w in skew_workers], timeout=30)
    _fanout(skew_workers, "skew", sk_bytes, 2, nudge=True)  # warmup
    fifo = _fanout(skew_workers, "skew", sk_bytes, sk_iters, nudge=True)
    frow = _row("allreduce skew w3 fifo", fifo[0]["durs"],
                {"retries": int(fifo[0]["retries"])})
    ray_tpu_torch.get([w.set_cfg.remote(dict(sk_cfg,
                                       collective_straggler_threshold=0.05))
                 for w in skew_workers], timeout=30)
    _fanout(skew_workers, "skew", sk_bytes, 2, nudge=True)  # learn EWMA
    strag = _fanout(skew_workers, "skew", sk_bytes, sk_iters, nudge=True)
    srow = _row("allreduce skew w3 straggler-aware", strag[0]["durs"],
                {"retries": int(strag[0]["retries"])})

    def _fast_done_ms(outs):
        # rank 0's fast peer is rank 2 (rank 1 carries the delay rule)
        vals = [d[2] for d in outs[0]["cc_done"] if 2 in d]
        return round(float(np.median(vals)) * 1e3, 1) if vals else 0.0

    fifo_done, strag_done = _fast_done_ms(fifo), _fast_done_ms(strag)
    gates["straggler_beats_fifo"] = 0.0 < strag_done < fifo_done
    # sanity: deferral must not cost wall clock (10% tolerance for noise)
    gates["straggler_not_slower"] = srow["p50_ms"] <= 1.10 * frow["p50_ms"]
    rows.append({"benchmark": "skew w3 fast-peer cc retire",
                 "value": round(fifo_done / strag_done, 2)
                 if strag_done else 0.0,
                 "unit": "x (>1 = straggler-aware retires fast-peer "
                         "chunks earlier)",
                 "fifo_ms": fifo_done, "straggler_ms": strag_done,
                 "fifo_p50_ms": frow["p50_ms"],
                 "straggler_p50_ms": srow["p50_ms"]})
    print(f"skew w3 fast-peer cc retire: fifo {fifo_done}ms -> "  # lint: allow-print
          f"straggler-aware {strag_done}ms")

    rows.append({"benchmark": "collective gates",
                 "value": float(all(gates.values())), "unit": "all-pass",
                 "gates": gates})
    print(f"gates: {gates}")  # lint: allow-print
    return rows
