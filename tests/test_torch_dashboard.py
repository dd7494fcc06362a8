"""The port's counterpart of ``tests/test_dashboard.py`` (4 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name; the CLI is ``python -m ray_tpu_torch`` with
``RAY_TPU_TORCH_GCS_ADDR``. The SPA's node table names its accelerator
column "GPU" and reads a node's ``GPU`` resource where the reference's
reads ``TPU`` (``test_node_table_reads_the_gpu_column``).

The reference's description:

Dashboard JSON API + state CLI (ray parity: dashboard HTTP routes,
`ray list` CLI).
"""

import json
import subprocess
import sys
import time
import urllib.request

import ray_tpu_torch
from tests.torch_fixtures import port_regular  # noqa: F401


@ray_tpu_torch.remote
def ping(x):
    return x


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as resp:
        return json.loads(resp.read())


def test_dashboard_json_api(port_regular):
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    ray_tpu_torch.get([ping.remote(i) for i in range(3)], timeout=60)
    port = start_dashboard()
    try:
        assert _get(port, "/api/v0/healthz")["status"] == "ok"
        nodes = _get(port, "/api/v0/nodes")
        assert nodes and nodes[0]["alive"]
        res = _get(port, "/api/v0/cluster_resources")
        assert res["total"].get("CPU", 0) > 0

        # task events flush to the GCS in batches: wait for ALL three pings
        # to be reported finished, not just the first batch
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            tasks = _get(port, "/api/v0/tasks")
            if sum(t["name"] == "ping" and t["state"] == "FINISHED"
                   for t in tasks) >= 3:
                break
            time.sleep(0.5)
        else:
            raise AssertionError("3 finished ping tasks never appeared")
        summary = _get(port, "/api/v0/tasks/summarize")
        assert summary["ping"]["FINISHED"] >= 3
        assert isinstance(_get(port, "/api/v0/timeline"), list)
        assert isinstance(_get(port, "/api/v0/actors"), list)
    finally:
        stop_dashboard()


def test_cli_list_and_summary(port_regular):
    from ray_tpu_torch._private.worker import global_worker

    ray_tpu_torch.get([ping.remote(i) for i in range(2)], timeout=60)
    time.sleep(3)  # task events flush
    host, port = global_worker.core_worker.gcs_addr

    from ray_tpu_torch._private.node import package_env

    env = package_env()
    env["RAY_TPU_TORCH_GCS_ADDR"] = f"{host}:{port}"
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "list", "nodes"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)[0]["alive"] is True

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "list", "tasks",
         "--filter", "state=FINISHED"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert all(r["state"] == "FINISHED" for r in rows)

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "summary"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "ping" in out.stdout


def test_dashboard_profile_endpoints(port_regular):
    """/api/profile/* (ray parity: the dashboard's py-spy attach button):
    cluster CPU profile in json + speedscope + collapsed formats, memory
    diff, and the SPA's Profile tab wiring."""
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    @ray_tpu_torch.remote
    def burn(seconds):
        deadline = time.monotonic() + seconds
        x = 0
        while time.monotonic() < deadline:
            x += 1
        return x

    ref = burn.remote(4.0)
    port = start_dashboard()
    try:
        prof = _get(port, "/api/profile/cpu?duration=1.0&hz=100")
        assert prof["kind"] == "cpu"
        assert prof["samples"] > 0
        assert {p["role"] for p in prof["processes"]} >= {"worker", "raylet"}
        ss = _get(port, "/api/profile/cpu?duration=0.5&format=speedscope")
        assert ss["$schema"].startswith("https://www.speedscope.app/")
        assert ss["profiles"]
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/profile/cpu"
            "?duration=0.5&format=collapsed", timeout=60
        ) as resp:
            assert "text/plain" in resp.headers["Content-Type"]
            collapsed = resp.read().decode()
        assert all(line.rsplit(" ", 1)[1].isdigit()
                   for line in collapsed.strip().splitlines() if line)
        mem = _get(port, "/api/profile/memory?duration=0.5")
        assert mem["kind"] == "mem"
        assert isinstance(mem["sites"], list)
        # the SPA ships the Profile tab and its fetch wiring
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10
        ) as resp:
            body = resp.read().decode()
        assert "runProfile" in body and '"profile"' in body
    finally:
        stop_dashboard()
    ray_tpu_torch.get(ref)


def test_dashboard_spa_and_full_api_surface(port_regular):
    """Browser-level smoke without a browser: the SPA page serves with
    its tab structure, and EVERY endpoint the SPA fetches responds with
    valid JSON describing live cluster state."""
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    ray_tpu_torch.get([ping.remote(i) for i in range(3)], timeout=60)
    port = start_dashboard()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10
        ) as resp:
            body = resp.read().decode()
            assert "text/html" in resp.headers["Content-Type"]
        # SPA skeleton: tab nav + the client-side pieces the pages use
        assert "ray_tpu_torch" in body and 'id="nav"' in body
        for marker in ("overview", "timeline", "metrics", "filterBar",
                       "drawTimeline", "spark", "straggler", '"memory"',
                       "fmtBytes", '"serve"', "serve_requests",
                       "dominant phase"):
            assert marker in body, f"SPA missing {marker}"
        # every endpoint the SPA's want-map fetches must answer
        for ep in ("nodes", "actors", "tasks?limit=1000", "objects?limit=500",
                   "memory", "placement_groups", "jobs", "events?limit=200",
                   "metrics", "metrics_history", "timeline", "train",
                   "train_timeline", "serve_requests", "serve_timeline",
                   "tasks/summarize", "cluster_resources"):
            out = _get(port, f"/api/v0/{ep}")
            assert out is not None, ep
        nodes = _get(port, "/api/v0/nodes")
        assert nodes and nodes[0]["alive"]
    finally:
        stop_dashboard()


def test_node_table_reads_the_gpu_column(port_regular):
    """The SPA's node table names its accelerator column "GPU" and reads a
    node's ``GPU`` resource, where the reference's reads ``TPU``: the
    port's nodes advertise cards. The page is the reference's otherwise."""
    import os

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    port = start_dashboard()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10
        ) as resp:
            body = resp.read().decode()
    finally:
        stop_dashboard()
    column = '["GPU", r => (r.resources_total || {}).GPU ?? ""]'
    assert column in body
    assert '"TPU"' not in body and ".TPU" not in body
    ref = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ray_tpu", "dashboard", "static",
        "index.html")
    with open(ref, encoding="utf-8") as f:
        ref_body = f.read()
    assert ref_body.replace("ray_tpu", "ray_tpu_torch").replace(
        column.replace("GPU", "TPU"), column) == body
