"""The port's counterpart of ``tests/test_profiler.py`` (16 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name, the 2 slow ones slow as in the reference.
``test_mem_profiler_diff_captures_allocation`` looks for this file's name
among the allocation sites, as the reference's looks for its own.

The reference's description:

On-demand profiling subsystem (_private/profiler.py +
util/profiling): sampled CPU flamegraphs with per-task/actor attribution
and tracemalloc memory diffs, fanned out worker -> raylet -> GCS.

ray parity: dashboard/modules/reporter/profile_manager.py (py-spy /
memray attach), rebuilt dependency-free as in-process samplers behind
RPC verbs.
"""

import json
import threading
import time

import pytest

from ray_tpu_torch._private import profiler
from tests.torch_fixtures import port_cluster, port_regular, port_regular_fn  # noqa: F401


# ---------------------------------------------------------------------------
# unit: sampler
# ---------------------------------------------------------------------------
def _busy_loop(stop, tag=None):
    def spin_hotspot():
        x = 0
        while not stop.is_set():
            x += 1
            if x % 100_000 == 0:
                time.sleep(0)  # release the GIL occasionally
        return x

    if tag is not None:
        with tag:
            spin_hotspot()
    else:
        spin_hotspot()


def test_cpu_sampler_basic():
    stop = threading.Event()
    t = threading.Thread(target=_busy_loop, args=(stop,),
                         name="busy-test-thread", daemon=True)
    t.start()
    s = profiler.CpuSampler(hz=200.0)
    s.start()
    assert s.running
    time.sleep(0.4)
    out = s.stop()
    stop.set()
    t.join()
    assert not s.running
    assert out["kind"] == "cpu"
    assert out["samples"] > 5
    assert out["effective_hz"] > 0
    assert 0 <= out["overhead_fraction"] < 1
    joined = "\n".join(out["stacks"])
    # the busy function appears, root-first under its thread frame
    assert "spin_hotspot" in joined
    assert "thread:busy-test-thread" in joined
    # double start on a fresh sampler object works; on a running one raises
    s2 = profiler.CpuSampler(hz=50.0)
    s2.start()
    with pytest.raises(RuntimeError):
        s2.start()
    s2.stop()


def test_cpu_sampler_task_attribution():
    stop = threading.Event()
    tag = profiler.tag_current_thread("do_work", actor_id="ab12cd34" * 4)
    t = threading.Thread(target=_busy_loop, args=(stop, tag), daemon=True)
    t.start()
    s = profiler.CpuSampler(hz=200.0)
    s.start()
    time.sleep(0.3)
    out = s.stop()
    stop.set()
    t.join()
    tagged = [st for st in out["stacks"] if "actor:" + "ab12cd34" * 4 in st]
    assert tagged, out["stacks"]
    # the synthetic frames sit between the thread root and the real stack
    frames = tagged[0].split(";")
    ai = frames.index("actor:" + "ab12cd34" * 4)
    assert frames[ai + 1] == "method:do_work"
    assert any("spin_hotspot" in f for f in frames[ai + 2:])
    # tag cleanup: after the context exits the registry is empty for
    # threads that are gone
    assert t.ident not in profiler._THREAD_TAGS


def test_cpu_sampler_autothrottles():
    s = profiler.CpuSampler(hz=500.0, max_overhead_fraction=1e-7)
    s.start()
    time.sleep(0.3)
    out = s.stop()
    # an impossible overhead budget must force the interval up, not spin
    assert out["throttled"] is True
    assert s.interval > 1.0 / 500.0
    assert out["effective_hz"] < 500.0


def test_tag_current_thread_nests():
    outer = profiler.tag_current_thread("outer", task_id="aa" * 8)
    inner = profiler.tag_current_thread("inner", task_id="bb" * 8)
    with outer:
        assert profiler.current_thread_tag() == ("task", "aa" * 8, "outer")
        with inner:
            assert profiler.current_thread_tag() == \
                ("task", "bb" * 8, "inner")
        assert profiler.current_thread_tag() == ("task", "aa" * 8, "outer")
    assert profiler.current_thread_tag() is None


# ---------------------------------------------------------------------------
# unit: merge + export
# ---------------------------------------------------------------------------
def _fake_proc(pid, stacks, **extra):
    return dict({"kind": "cpu", "pid": pid, "role": "worker",
                 "samples": sum(stacks.values()), "stacks": stacks}, **extra)


def test_merge_profiles_sums_stacks():
    a = _fake_proc(1, {"thread:x;f (m.py:1)": 3, "thread:x;g (m.py:2)": 1})
    b = _fake_proc(2, {"thread:x;f (m.py:1)": 2})
    err = {"pid": 3, "error": "unreachable"}
    merged = profiler.merge_profiles([a, b, err, None], kind="cpu")
    assert merged["samples"] == 6
    assert merged["stacks"]["thread:x;f (m.py:1)"] == 5
    assert merged["stacks"]["thread:x;g (m.py:2)"] == 1
    assert len(merged["processes"]) == 2
    assert merged["errors"] == [err]


def test_merge_profiles_mem_sites():
    a = {"kind": "mem", "pid": 1, "sites": [
        {"site": "m.py:10", "size_bytes": 100, "count": 2,
         "size_diff_bytes": 100, "count_diff": 2}]}
    b = {"kind": "mem", "pid": 2, "sites": [
        {"site": "m.py:10", "size_bytes": 50, "count": 1,
         "size_diff_bytes": 50, "count_diff": 1},
        {"site": "n.py:3", "size_bytes": 10, "count": 1,
         "size_diff_bytes": -10, "count_diff": -1}]}
    merged = profiler.merge_profiles([a, b], kind="mem")
    by_site = {s["site"]: s for s in merged["sites"]}
    assert by_site["m.py:10"]["size_diff_bytes"] == 150
    assert by_site["m.py:10"]["count"] == 3
    assert by_site["n.py:3"]["size_diff_bytes"] == -10
    # sorted by |delta| descending
    assert merged["sites"][0]["site"] == "m.py:10"


def test_collapsed_format():
    text = profiler.to_collapsed({"a;b;c": 7, "a;d": 9})
    lines = text.strip().split("\n")
    assert lines == ["a;d 9", "a;b;c 7"]  # count-descending, 'stack N'


def test_speedscope_schema():
    procs = [
        _fake_proc(1, {"thread:m;f (m.py:1);g (m.py:2)": 4,
                       "thread:m;f (m.py:1)": 2},
                   role="worker", node_id="n0de" * 4),
        _fake_proc(2, {"thread:m;f (m.py:1)": 1}, role="raylet"),
    ]
    ss = profiler.to_speedscope(procs, name="test profile")
    assert ss["$schema"].startswith("https://www.speedscope.app/")
    assert ss["name"] == "test profile"
    frames = ss["shared"]["frames"]
    assert all(isinstance(f["name"], str) for f in frames)
    assert len(ss["profiles"]) == 2
    for prof in ss["profiles"]:
        assert prof["type"] == "sampled"
        assert len(prof["samples"]) == len(prof["weights"])
        for sample in prof["samples"]:
            assert all(0 <= i < len(frames) for i in sample)
    # frame table is SHARED: 'f (m.py:1)' appears exactly once
    assert sum(1 for f in frames if f["name"] == "f (m.py:1)") == 1
    json.dumps(ss)  # must be JSON-serializable as-is


def test_speedscope_empty():
    ss = profiler.to_speedscope([])
    assert ss["profiles"]  # speedscope rejects files with no profiles
    json.dumps(ss)


# ---------------------------------------------------------------------------
# unit: memory profiler
# ---------------------------------------------------------------------------
def test_mem_profiler_diff_captures_allocation():
    m = profiler.MemProfiler(n_frames=4)
    m.start()
    hoard = [bytes(64) * 256 for _ in range(2000)]  # ~32MB, from this line
    out = m.stop(top_n=20, diff=True)
    assert out["kind"] == "mem"
    assert out["sites"]
    joined = " ".join(s["site"] for s in out["sites"])
    assert "test_torch_profiler.py" in joined
    top = out["sites"][0]
    assert top["size_diff_bytes"] > 1_000_000
    del hoard
    # stopped: a second collect must fail, and a fresh session must work
    with pytest.raises(RuntimeError):
        m.collect()
    m.start()
    m.stop()


def test_profiler_service_lifecycle():
    svc = profiler.ProfilerService(role="test")
    st = svc.status()
    assert st == {"role": "test", "pid": st["pid"],
                  "cpu_running": False, "mem_running": False}
    assert svc.start({"kind": "cpu", "hz": 50})["ok"]
    assert "already running" in svc.start({"kind": "cpu"})["error"]
    assert svc.status()["cpu_running"]
    time.sleep(0.1)
    out = svc.stop({"kind": "cpu"})
    assert out["role"] == "test"
    assert out["samples"] >= 0
    assert "not running" in svc.stop({"kind": "cpu"})["error"]
    assert "unknown profiler kind" in svc.start({"kind": "gpu"})["error"]


# ---------------------------------------------------------------------------
# end-to-end: cluster fan-out, per-actor attribution (acceptance criterion)
# ---------------------------------------------------------------------------
def test_profile_cpu_cluster_end_to_end(port_regular):
    import ray_tpu_torch
    from ray_tpu_torch.util import profiling, state

    @ray_tpu_torch.remote
    class Burner:
        def burn(self, seconds):
            deadline = time.monotonic() + seconds
            x = 0
            while time.monotonic() < deadline:
                x += 1
            return x

    actor = Burner.remote()
    ray_tpu_torch.get(actor.burn.remote(0.01))  # actor is up
    ref = actor.burn.remote(3.0)  # busy across the whole window

    prof = profiling.profile_cpu(duration=1.2, hz=200)
    assert prof.samples > 0, prof.raw
    roles = {p.get("role") for p in prof.processes}
    assert "worker" in roles and "raylet" in roles, roles
    # ACCEPTANCE: the busy actor's method frames are attributed to its id
    actor_hex = actor._actor_id.hex()
    attributed = [s for s in prof.stacks if f"actor:{actor_hex}" in s]
    assert attributed, list(prof.stacks)[:10]
    assert any("burn" in s for s in attributed)
    # the per-actor slice isolates it
    sliced = prof.filter(actor_hex)
    assert sliced.samples > 0
    assert all(actor_hex in s for s in sliced.stacks)
    # speedscope export round-trips and names the worker profile
    ss = prof.speedscope()
    json.dumps(ss)
    assert any(p["samples"] for p in ss["profiles"])
    # state-API wrapper reaches the same surface
    prof2 = state.profile_cpu(duration=0.3, hz=50)
    assert prof2.processes
    ray_tpu_torch.get(ref)
    ray_tpu_torch.kill(actor)


def test_profile_memory_cluster_end_to_end(port_regular):
    import ray_tpu_torch
    from ray_tpu_torch.util import profiling

    @ray_tpu_torch.remote
    class Hoarder:
        def __init__(self):
            self.data = []

        def hoard(self, n, seconds):
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline:
                if len(self.data) < n:
                    self.data.append(bytearray(512 * 1024))
                time.sleep(0.02)
            return len(self.data)

    actor = Hoarder.remote()
    ref = actor.hoard.remote(40, 2.5)
    prof = profiling.profile_memory(duration=1.2)
    assert prof.processes, prof.raw
    assert prof.sites
    # growth in the hoarding worker dominates the merged deltas
    assert prof.sites[0]["size_diff_bytes"] != 0
    ray_tpu_torch.get(ref)
    ray_tpu_torch.kill(actor)


def test_profile_status_and_manual_start_stop(port_regular):
    """The granular start/stop/status verbs work against this driver's
    own GCS connection (operator attach without the fan-out)."""
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    st = cw.io.run(cw.gcs.request("profile_status", {}))
    assert st["role"] == "gcs" and not st["cpu_running"]
    assert cw.io.run(
        cw.gcs.request("profile_start", {"kind": "cpu", "hz": 50})
    )["ok"]
    assert cw.io.run(cw.gcs.request("profile_status", {}))["cpu_running"]
    time.sleep(0.2)
    out = cw.io.run(cw.gcs.request("profile_stop", {"kind": "cpu"}))
    assert out["role"] == "gcs"
    assert out["samples"] > 0


@pytest.mark.slow
def test_profile_cpu_multinode_fanout(port_cluster):
    """Two raylets: the GCS merge carries processes from BOTH nodes and
    busy work on each is visible in the merged stacks."""
    import ray_tpu_torch
    from ray_tpu_torch.util import profiling

    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote(num_cpus=1)
    def burn(seconds):
        deadline = time.monotonic() + seconds
        x = 0
        while time.monotonic() < deadline:
            x += 1
        return x

    refs = [burn.remote(4.0) for _ in range(4)]  # spans both nodes
    time.sleep(0.5)
    prof = profiling.profile_cpu(duration=1.5, hz=100)
    nodes = {p.get("node_id") for p in prof.processes if p.get("node_id")}
    assert len(nodes) >= 2, prof.processes
    assert any("burn" in s for s in prof.stacks), list(prof.stacks)[:10]
    # node-scoped capture restricts the fan-out
    one = sorted(nodes)[0]
    scoped = profiling.profile_cpu(duration=0.5, hz=100, node_id=one)
    assert {p.get("node_id") for p in scoped.processes
            if p.get("node_id")} == {one}
    ray_tpu_torch.get(refs)


@pytest.mark.slow
def test_profiler_overhead_under_5_percent(port_regular_fn):
    # _fn (function-scoped) because the multinode test above tears down
    # the module-scoped shared cluster; this one needs a fresh init.
    """The acceptance microbench at 100 Hz. The robust <5% gate is the
    samplers' SELF-MEASURED cpu share (what the auto-throttle enforces;
    ~1.3% measured here). The end-to-end throughput delta is also
    captured, but this box (2-CPU gVisor) has a ±30% throughput noise
    floor — no-profiler A/A runs vary 1.8x — so it only gets a sanity
    bound; bench.py BENCH_PROFILER_OVERHEAD=1 reports both numbers."""
    from ray_tpu_torch.util.profiling import profiler_overhead_bench

    out = profiler_overhead_bench(hz=100.0, batch=150, window_s=5.0)
    assert out["profile_error"] is None, out
    assert out["profile_samples"] > 0
    assert out["sampling_cpu_fraction"] < 0.05, out
    assert out["overhead_fraction"] < 0.5, out  # noise-floor sanity only
