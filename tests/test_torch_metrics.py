"""The port's counterpart of ``tests/test_metrics.py`` (18 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name, the 2 slow ones slow as in the reference. The scrape's built-in
series keep the reference's names (``ray_tpu_node_count``,
``ray_tpu_resources_total``), which the port's ``dashboard/prometheus.py``
emits.

The reference's description:

Runtime metrics plane (_private/metrics_core.py + the rebased
ray_tpu.util.metrics): hot-path counters/gauges/log2 histograms, the
metrics_snapshot RPC fan-out (worker -> raylet -> GCS), and the
Prometheus scrape surfaces.

Analog of ray: python/ray/tests/test_metrics_agent.py (every subsystem's
series shows up on the scrape endpoint) plus the src/ray/stats/ unit
tests (bucket placement, merge) — rebuilt over the dependency-free core.

Fast deterministic tests (unmarked beyond ``metrics``, tier-1): core
types, log2/explicit bucket placement, quantile estimation, cross-process
snapshot merge, Prometheus exposition validity, the user-metrics rebase,
and the rpcio accounting invariants (per-ATTEMPT latency vs exactly-once
logical counters through the idempotent-retry dedup path). Cluster tests
(slow): single-node scrape end-to-end with live-process GC, the 2-node
/metrics <250ms smoke, and the <2% self-measured overhead gate.
"""

import asyncio
import json
import re
import time
import urllib.request
import uuid

import pytest

from ray_tpu_torch._private import faultsim, metrics_core
from ray_tpu_torch._private.rpcio import (
    ConnectionLost,
    RpcServer,
    RpcTimeoutError,
    call_with_retries,
    connect,
)
from tests.conftest import wait_for_condition
from tests.torch_fixtures import port_cluster, port_regular, port_regular_fn  # noqa: F401

pytestmark = pytest.mark.metrics


# ---------------------------------------------------------------------------
# unit: core types (standalone Registry — never the process-global one)
# ---------------------------------------------------------------------------
def test_counter_gauge_basics():
    r = metrics_core.Registry()
    c = r.counter("reqs", "requests")
    c.inc()
    c.inc(2.5)
    c.labels(route="/a").inc()
    g = r.gauge("depth")
    g.set(7)
    g.inc()
    g.dec(3)
    r.gauge("cb_depth").set_fn(lambda: 42.0)
    snap = r.snapshot()
    assert snap["reqs"]["type"] == "counter"
    by_tags = {tuple(sorted(s["tags"].items())): s["value"]
               for s in snap["reqs"]["series"]}
    assert by_tags[()] == 3.5
    assert by_tags[(("route", "/a"),)] == 1.0
    assert snap["depth"]["series"][0]["value"] == 5.0
    # callback gauges evaluate at snapshot time (zero hot-path cost)
    assert snap["cb_depth"]["series"][0]["value"] == 42.0
    # same name, same family object; conflicting type raises
    assert r.counter("reqs") is c or r.counter("reqs").name == "reqs"
    with pytest.raises(ValueError):
        r.gauge("reqs")


def test_lazy_default_child_no_spurious_series():
    """A labeled-only family must not emit an empty unlabeled series."""
    r = metrics_core.Registry()
    r.counter("labeled_only").labels(kind="x").inc()
    tags = [s["tags"] for s in r.snapshot()["labeled_only"]["series"]]
    assert tags == [{"kind": "x"}]


def test_histogram_log2_bucket_placement():
    """LATENCY scale: floor 1us, 26 buckets; bucket i holds values
    < floor * 2**i (index = int(v/floor).bit_length()), overflow clamps."""
    h = metrics_core.Histogram({}, scale=metrics_core.LATENCY)
    assert len(h._bounds) == 26 and h._bounds[0] == 1e-6
    cases = [
        (0.5e-6, 0),    # below the floor
        (1.5e-6, 1),    # [1us, 2us)
        (3e-6, 2),      # [2us, 4us)
        (1.0, 20),      # 2**20 us ~ 1.05s bucket
        (1e9, 26),      # way past 32s -> overflow bucket
    ]
    for v, want in cases:
        before = h._counts[want]
        h.record(v)
        assert h._counts[want] == before + 1, (v, want, h._counts)
    assert h.count() == len(cases)
    series = h._series()
    assert series["count"] == len(cases)
    assert series["sum"] == pytest.approx(sum(v for v, _ in cases))


def test_histogram_size_scale_and_explicit_boundaries():
    s = metrics_core.Histogram({}, scale=metrics_core.SIZE)
    s.record(1024)
    assert s._counts[11] == 1  # [1KiB, 2KiB)
    # explicit boundaries take the bisect path; le is inclusive
    e = metrics_core.Histogram({}, boundaries=[1.0, 10.0, 100.0])
    for v, want in [(0.5, 0), (1.0, 0), (5, 1), (10.0, 1), (99, 2),
                    (1e6, 3)]:
        before = e._counts[want]
        e.record(v)
        assert e._counts[want] == before + 1, (v, want)


def test_hist_quantiles_bounded_error():
    """Log2 buckets keep the quantile estimate within a factor of 2 of
    the true value, and the estimates are monotone in q."""
    h = metrics_core.Histogram({}, scale=metrics_core.LATENCY)
    for _ in range(90):
        h.record(100e-6)
    for _ in range(10):
        h.record(10e-3)
    qs = metrics_core.hist_quantiles(h._series(), (0.5, 0.95, 0.99))
    assert qs[0.5] <= qs[0.95] <= qs[0.99]
    assert 50e-6 <= qs[0.5] <= 200e-6
    assert 5e-3 <= qs[0.99] <= 20e-3
    # empty histogram -> zeros, no division error
    empty = metrics_core.Histogram({}, scale=metrics_core.LATENCY)
    assert metrics_core.hist_quantiles(empty._series())[0.5] == 0.0


def test_enable_flag_gates_recording():
    r = metrics_core.Registry()
    c = r.counter("gated")
    h = r.histogram("gated_h")
    calls0 = metrics_core.record_calls()
    metrics_core.set_enabled(False)
    try:
        c.inc()
        h.record(1e-3)
        assert c.default.value() == 0.0
        assert h.default.count() == 0
        assert metrics_core.record_calls() == calls0
    finally:
        metrics_core.set_enabled(True)
    c.inc()
    h.record(1e-3)
    assert c.default.value() == 1.0
    assert metrics_core.record_calls() == calls0 + 2


# ---------------------------------------------------------------------------
# unit: cross-process merge (the raylet/GCS fan-out layers)
# ---------------------------------------------------------------------------
def _two_process_snapshots():
    r1, r2 = metrics_core.Registry(), metrics_core.Registry()
    for r, n in ((r1, 3), (r2, 4)):
        c = r.counter("ops_total")
        c.labels(verb="put").inc(n)
        h = r.histogram("lat", scale=metrics_core.LATENCY)
        for i in range(n):
            h.record(1e-6 * (1 << i))
    r1.counter("ops_total").labels(verb="get").inc(7)  # only in r1
    r2.gauge("depth").set(5)                           # only in r2
    return r1.snapshot(), r2.snapshot()


def test_merge_snapshots_sums_and_buckets():
    s1, s2 = _two_process_snapshots()
    merged = metrics_core.merge_snapshots([s1, s2])
    ops = {tuple(sorted(s["tags"].items())): s["value"]
           for s in merged["ops_total"]["series"]}
    assert ops[(("verb", "put"),)] == 7.0  # 3 + 4
    assert ops[(("verb", "get"),)] == 7.0  # r1 only, carried through
    assert merged["depth"]["series"][0]["value"] == 5.0
    lat = merged["lat"]["series"][0]
    assert lat["count"] == 7
    # buckets merged elementwise: each process recorded one value per
    # power-of-two, the smaller set is a prefix of the larger
    per1 = s1["lat"]["series"][0]["buckets"]
    per2 = s2["lat"]["series"][0]["buckets"]
    assert lat["buckets"] == [a + b for a, b in zip(per1, per2)]
    assert lat["sum"] == pytest.approx(
        s1["lat"]["series"][0]["sum"] + s2["lat"]["series"][0]["sum"])
    # merge is associative enough for the fan-out: (s1+s2)+s1 == 2*s1+s2
    again = metrics_core.merge_snapshots([merged, s1])
    assert again["lat"]["series"][0]["count"] == 10


def test_merge_drops_mismatched_boundaries():
    r1, r2 = metrics_core.Registry(), metrics_core.Registry()
    r1.histogram("h", boundaries=[1, 2, 4]).record(1.5)
    r2.histogram("h", boundaries=[1, 10]).record(1.5)
    merged = metrics_core.merge_snapshots([r1.snapshot(), r2.snapshot()])
    # first declaration wins; the conflicting dump is dropped whole
    s = merged["h"]["series"][0]
    assert s["boundaries"] == [1.0, 2.0, 4.0]
    assert s["count"] == 1


def test_summarize_shapes():
    s1, s2 = _two_process_snapshots()
    out = metrics_core.summarize(metrics_core.merge_snapshots([s1, s2]))
    assert out["ops_total"]["type"] == "counter"
    lat = out["lat"]["series"][0]
    assert set(lat) >= {"count", "sum", "mean", "p50", "p95", "p99"}
    assert lat["count"] == 7 and lat["p50"] <= lat["p99"]


# ---------------------------------------------------------------------------
# unit: Prometheus text exposition validity
# ---------------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"            # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""  # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" [-+0-9.eE]+(e[-+]?[0-9]+)?$|^.* \+?[Ii]nf$|^.* [Nn]a[Nn]$")


def assert_valid_prometheus_text(text: str):
    """Structural validation of the exposition: every line is a comment
    or a well-formed sample; histogram bucket counts are cumulative and
    the +Inf bucket equals _count."""
    assert text.endswith("\n")
    cum = {}        # (name, non-le labels) -> last cumulative count
    counts = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), f"malformed sample line: {line!r}"
        name = line.split("{")[0].split(" ")[0]
        value = float(line.rsplit(" ", 1)[1])
        labels = ""
        if "{" in line:
            labels = line[line.index("{") + 1:line.rindex("}")]
        if name.endswith("_bucket"):
            parts = [kv for kv in labels.split(",") if kv]
            le = [kv for kv in parts if kv.startswith('le="')][0]
            rest = ",".join(kv for kv in parts if not kv.startswith('le="'))
            key = (name, rest)
            assert value >= cum.get(key, 0.0), f"non-cumulative: {line!r}"
            cum[key] = value
            if le == 'le="+Inf"':
                counts[(name[:-len("_bucket")], rest)] = value
        elif name.endswith("_count"):
            base = name[: -len("_count")]
            if (base, labels) in counts:
                assert value == counts[(base, labels)], \
                    f"+Inf bucket != _count for {base}"
    return True


def test_render_metrics_valid_exposition():
    s1, s2 = _two_process_snapshots()
    merged = metrics_core.merge_snapshots([s1, s2])
    from ray_tpu_torch.dashboard.prometheus import render_metrics

    text = render_metrics(metrics_core.snapshot_records(merged))
    assert_valid_prometheus_text(text)
    assert 'ops_total{verb="put"} 7.0' in text
    assert "# TYPE lat histogram" in text
    assert "lat_count 7" in text


# ---------------------------------------------------------------------------
# unit: user-metrics API rebased onto the core
# ---------------------------------------------------------------------------
def test_user_metrics_register_in_core_registry():
    from ray_tpu_torch.util import metrics as um

    name = f"user_reqs_{uuid.uuid4().hex[:8]}"
    hname = f"user_lat_{uuid.uuid4().hex[:8]}"
    try:
        c = um.Counter(name, "user counter", tag_keys=("route",))
        c.inc(2, tags={"route": "/a"})
        with pytest.raises(ValueError):
            c.inc(1, tags={"bogus": "k"})
        with pytest.raises(ValueError):
            c.inc(-1)
        # no boundaries -> the pre-rebase default buckets, NOT the
        # runtime latency scale (user values are arbitrary magnitudes)
        assert um.Histogram(
            f"dflt_{hname}").boundaries == [0.1, 1, 10, 100, 1000]
        metrics_core.registry().unregister(f"dflt_{hname}")
        h = um.Histogram(hname, boundaries=[0.1, 1, 10])
        h.observe(0.5)
        snap = metrics_core.registry().snapshot()
        assert snap[name]["series"][0]["value"] == 2.0
        assert snap[name]["series"][0]["tags"] == {"route": "/a"}
        assert snap[hname]["series"][0]["count"] == 1
        assert snap[hname]["series"][0]["boundaries"] == [0.1, 1.0, 10.0]
        # default tags merge under declared keys
        c.set_default_tags({"route": "/b"})
        c.inc()
        by = {s["tags"]["route"]: s["value"]
              for s in metrics_core.registry().snapshot()[name]["series"]}
        assert by == {"/a": 2.0, "/b": 1.0}
    finally:
        metrics_core.registry().unregister(name)
        metrics_core.registry().unregister(hname)


# ---------------------------------------------------------------------------
# rpcio accounting invariants (in-process RpcServer, process-global
# registry — all assertions are deltas)
# ---------------------------------------------------------------------------
class _Handler:
    def __init__(self):
        self.count = 0

    def rpc_bump(self, conn, p):
        self.count += 1
        return self.count

    def rpc_echo(self, conn, p):
        return p

    async def rpc_hang(self, conn, p):
        await asyncio.sleep(60)


def _counter_value(name, **tags):
    dump = metrics_core.registry().snapshot().get(name)
    for s in (dump or {}).get("series", ()):
        if s["tags"] == tags:
            return s["value"]
    return 0.0


def _hist_count(name, **tags):
    dump = metrics_core.registry().snapshot().get(name)
    for s in (dump or {}).get("series", ()):
        if s["tags"] == tags:
            return s["count"]
    return 0


def test_rpc_latency_per_attempt_but_handled_once():
    """THE dedup-accounting invariant: a retried idempotent request
    records one latency observation per ATTEMPT while the logical
    rpc_handled_total counter counts the execution exactly once (the
    replay path answers from the idempotency cache without re-counting).
    """

    async def main():
        handler = _Handler()
        srv = RpcServer(handler)
        port = await srv.start()
        lat0 = _hist_count("rpc_request_latency_seconds", method="bump")
        handled0 = _counter_value("rpc_handled_total", method="bump")
        c1 = await connect("127.0.0.1", port, retries=3)
        r1 = await c1.request("bump", {}, timeout=10, idem=("tok-m", 1))
        await c1.close()
        # retry on a FRESH connection, as a real post-connection-loss
        # retry would: replayed result, no second execution
        c2 = await connect("127.0.0.1", port, retries=3)
        try:
            r2 = await c2.request("bump", {}, timeout=10, idem=("tok-m", 1))
            assert (r1, r2) == (1, 1) and handler.count == 1
            lat1 = _hist_count("rpc_request_latency_seconds", method="bump")
            handled1 = _counter_value("rpc_handled_total", method="bump")
            assert lat1 - lat0 == 2, "each attempt records latency"
            assert handled1 - handled0 == 1, \
                "deduped retry must not double-count the logical request"
        finally:
            await c2.close()
            await srv.stop()

    asyncio.run(main())


def test_rpc_timeout_and_retry_and_fault_counters():
    """Deadline hits bump rpc_request_timeouts_total; call_with_retries
    re-attempts bump rpc_retries_total; injected faults are metered by
    kind in rpc_faults_injected_total."""

    async def main():
        srv = RpcServer(_Handler())
        port = await srv.start()
        to0 = _counter_value("rpc_request_timeouts_total", method="hang")
        rt0 = _counter_value("rpc_retries_total", method="echo")
        dr0 = _counter_value("rpc_faults_injected_total", kind="drop")
        conn = await connect("127.0.0.1", port, retries=3)
        state = {"conn": conn}

        async def get_conn():
            # drop faults sever the connection mid-frame; real retry
            # loops redial, so this one does too
            if state["conn"] is None or state["conn"].closed:
                state["conn"] = await connect("127.0.0.1", port, retries=3)
            return state["conn"]

        try:
            with pytest.raises(RpcTimeoutError):
                await conn.request("hang", {}, timeout=0.2)
            assert _counter_value(
                "rpc_request_timeouts_total", method="hang") - to0 == 1
            faultsim.install("echo:drop:1.0:7")
            try:
                with pytest.raises(ConnectionLost):
                    await call_with_retries(
                        get_conn, "echo", {"x": 1}, timeout=0.2,
                        attempts=3, base_delay=0.01)
            finally:
                faultsim.clear()
            assert _counter_value(
                "rpc_retries_total", method="echo") - rt0 == 2
            assert _counter_value(
                "rpc_faults_injected_total", kind="drop") - dr0 == 3
        finally:
            faultsim.clear()
            if state["conn"] is not None:
                await state["conn"].close()
            await srv.stop()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# cluster: scrape end-to-end (single node, shared fixture)
# ---------------------------------------------------------------------------
def test_cluster_scrape_end_to_end(port_regular):
    """One GCS fan-out scrape returns runtime AND user metrics merged:
    rpcio latency histograms, raylet queue gauges, object-store size
    histograms, and a driver-side user Counter — all in one snapshot,
    and the Prometheus rendering of it is structurally valid."""
    import ray_tpu_torch
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.util import metrics as um
    from ray_tpu_torch.util import state

    name = f"e2e_user_total_{uuid.uuid4().hex[:8]}"
    c = um.Counter(name, "e2e", tag_keys=("route",))
    c.inc(3, tags={"route": "/x"})

    @ray_tpu_torch.remote
    def nop():
        return 1

    assert sum(ray_tpu_torch.get([nop.remote() for _ in range(20)])) == 20
    # plain tasks ride direct worker leases past the raylet scheduler;
    # push one burst through the raylet-routed path so the placement
    # histogram sees queue->dispatch transitions
    GLOBAL_CONFIG.update({"direct_task_leases": False})
    try:
        assert sum(ray_tpu_torch.get([nop.remote() for _ in range(10)])) == 10
    finally:
        GLOBAL_CONFIG.update({"direct_task_leases": True})
    # past max_direct_call_object_size so the put hits the shm store
    ray_tpu_torch.get(ray_tpu_torch.put(b"z" * (256 * 1024)))
    try:
        snap = um.cluster_snapshot()
        merged = snap["merged"]
        roles = {p.get("role") for p in snap["processes"]
                 if not p.get("error")}
        assert {"gcs", "raylet", "driver"} <= roles  # workers via raylet
        assert snap.get("record_calls", 0) > 0
        # runtime series from three different subsystems
        lat = merged["rpc_request_latency_seconds"]
        assert any(s["count"] > 0 for s in lat["series"])
        assert any(s["tags"].get("node")
                   for s in merged["raylet_ready_queue_depth"]["series"])
        # BOTH dispatch paths stamp placement latency now: the raylet's
        # ready->dispatch series AND the driver-side direct-lease
        # enqueue->push series, split by the path label
        plat = merged["raylet_task_placement_latency_seconds"]
        paths = {s["tags"].get("path")
                 for s in plat["series"] if s["count"] > 0}
        assert {"raylet", "direct"} <= paths, paths
        assert any(s["count"] > 0
                   for s in merged["object_store_put_bytes"]["series"])
        assert merged["worker_task_run_seconds"]["series"]
        # the user counter rides the SAME scrape
        assert merged[name]["series"][0]["value"] == 3.0
        # summary + exposition over the same snapshot
        summary = state.metrics_summary()
        s = summary["rpc_request_latency_seconds"]["series"][0]
        assert s["count"] > 0 and 0 < s["p50"] <= s["p99"]
        text = um.prometheus_text(merged)
        assert_valid_prometheus_text(text)
        assert "rpc_request_latency_seconds_bucket" in text
        assert name in text
        # monotonic *_total series expose TYPE counter (rate() contract)
        assert "# TYPE raylet_tasks_dispatched_total counter" in text
        # list_metrics reflects LIVE processes and does not accumulate
        a = um.list_metrics()
        b = um.list_metrics()
        assert len(a[name]) == len(b[name]) == 1
        assert a[name][0]["role"] == "driver"
    finally:
        metrics_core.registry().unregister(name)


def test_dead_process_metrics_drop_from_scrape(port_regular):
    """The KV-GC satellite, by construction: a killed actor's process
    stops answering the scrape, so its user metric disappears from
    list_metrics() instead of accumulating forever."""
    import ray_tpu_torch
    from ray_tpu_torch.util import metrics as um

    name = f"gc_actor_total_{uuid.uuid4().hex[:8]}"

    @ray_tpu_torch.remote
    class M:
        def __init__(self, name):
            from ray_tpu_torch.util.metrics import Counter

            self.c = Counter(name, "dies with the actor")
            self.name = name

        def bump(self):
            self.c.inc()
            return 1

    a = M.remote(name)
    assert ray_tpu_torch.get(a.bump.remote()) == 1
    wait_for_condition(lambda: name in um.list_metrics(), timeout=15)
    ray_tpu_torch.kill(a)
    wait_for_condition(lambda: name not in um.list_metrics(), timeout=30)


def test_dashboard_metrics_endpoints(port_regular):
    """/metrics (Prometheus text), /api/metrics?format=json (summary),
    and the /api/v0/metrics_history ring the SPA sparklines read."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    GLOBAL_CONFIG.update({"metrics_history_interval_s": 0.5})
    port = start_dashboard()
    base = f"http://127.0.0.1:{port}"
    try:
        text = urllib.request.urlopen(base + "/metrics", timeout=30).read(
        ).decode()
        assert_valid_prometheus_text(text)
        assert "rpc_request_latency_seconds_bucket" in text
        assert "ray_tpu_node_count" in text  # synthesized built-ins merge in
        summary = json.loads(urllib.request.urlopen(
            base + "/api/metrics?format=json", timeout=30).read())
        assert "rpc_request_latency_seconds" in summary
        text2 = urllib.request.urlopen(
            base + "/api/metrics", timeout=30).read().decode()
        assert_valid_prometheus_text(text2)

        def ring_filled():
            hist = json.loads(urllib.request.urlopen(
                base + "/api/v0/metrics_history", timeout=30).read())
            return (len(hist) >= 2
                    and "rpc_request_latency_seconds" in hist[-1]["metrics"]
                    and hist[-1]["ts"] > hist[0]["ts"])

        wait_for_condition(ring_filled, timeout=30)
    finally:
        stop_dashboard()
        GLOBAL_CONFIG.update({"metrics_history_interval_s": 5.0})


# ---------------------------------------------------------------------------
# cluster: 2-node smoke + overhead gate (slow lane)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_two_node_scrape_smoke(port_cluster):
    """The acceptance scrape: a 2-node cluster's merged /metrics is valid
    Prometheus text carrying per-node raylet series from BOTH nodes, and
    the node agent's /metrics answers in <250ms."""
    import ray_tpu_torch
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote
    def nop():
        return 1

    # touch both nodes so every raylet has dispatch activity
    assert sum(ray_tpu_torch.get([nop.remote() for _ in range(40)])) == 40
    from ray_tpu_torch.util import metrics as um

    merged = um.cluster_snapshot()["merged"]
    nodes = {s["tags"].get("node")
             for s in merged["raylet_worker_pool_size"]["series"]}
    assert len(nodes) == 2, f"expected both raylets in the merge: {nodes}"

    port = start_dashboard()
    try:
        url = f"http://127.0.0.1:{port}/metrics"
        urllib.request.urlopen(url, timeout=60).read()  # warm the path
        t0 = time.perf_counter()
        text = urllib.request.urlopen(url, timeout=60).read().decode()
        elapsed = time.perf_counter() - t0
        assert_valid_prometheus_text(text)
        assert "raylet_task_placement_latency_seconds_bucket" in text
        assert elapsed < 0.25, f"/metrics took {elapsed * 1e3:.0f}ms"
    finally:
        stop_dashboard()


@pytest.mark.slow
def test_metrics_overhead_under_2_percent(port_regular_fn):
    """The bench.py acceptance gate, as a test: self-measured
    instrumentation share of the sync-task hot path < 2% (paired with
    the profiler gate's posture — the end-to-end throughput delta is
    reported only, this box's A/A noise swamps it)."""
    from ray_tpu_torch.util.metrics import metrics_overhead_bench

    out = metrics_overhead_bench(batch=150, repeat=3, rounds=2)
    assert out["events_in_window"] > 0, "instrumentation must be live"
    assert out["self_fraction"] < 0.02, out
