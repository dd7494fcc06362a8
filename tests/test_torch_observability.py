"""The port's counterpart of ``tests/test_observability.py`` (4 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name. The module's cluster starts as the
reference's does (``num_cpus=4``), through
``tests/torch_fixtures.own_port_cluster``: a port cluster an earlier module
on the same xdist worker left up is shut down first, where ``init`` would
raise "called twice" (``test_own_port_cluster_replaces_one_left_up``).

The reference's description:

Observability export tests.

Analog of ray: python/ray/tests/test_metrics_agent.py (Prometheus scrape),
test_logging.py (worker stdout reaches the driver), and the event
aggregator tests — Prometheus text endpoint on the dashboard, structured
cluster events, and raylet log tailing to driver-subscribed pubsub.
"""

import time

import pytest
import requests

import ray_tpu_torch
from tests.torch_fixtures import own_port_cluster


@pytest.fixture(scope="module")
def obs_cluster():
    with own_port_cluster(num_cpus=4):
        yield


def test_own_port_cluster_replaces_one_left_up():
    """Runs before any case asks for ``obs_cluster``: a port cluster is up,
    as one an earlier module on this worker left, and the module's own
    starts all the same, with its own resources, and is gone after."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=1)
    with own_port_cluster(num_cpus=4):
        assert ray_tpu_torch.cluster_resources()["CPU"] == 4.0
    assert not ray_tpu_torch.is_initialized()


def test_prometheus_endpoint(obs_cluster):
    from ray_tpu_torch.dashboard.head import start_dashboard, stop_dashboard
    from ray_tpu_torch.util.metrics import Counter

    c = Counter("test_requests_total", "test counter", tag_keys=("route",))
    c.inc(3, tags={"route": "/a"})
    c.inc(2, tags={"route": "/b"})
    from ray_tpu_torch.util import metrics as m

    m.flush()
    port = start_dashboard()
    try:
        text = requests.get(
            f"http://127.0.0.1:{port}/metrics", timeout=30
        ).text
        assert "# TYPE test_requests_total counter" in text
        assert 'test_requests_total{route="/a"} 3.0' in text
        # cluster built-ins render without user code
        assert 'ray_tpu_node_count{state="alive"} 1.0' in text
        assert "ray_tpu_resources_total" in text
    finally:
        stop_dashboard()


def test_structured_events(obs_cluster):
    from ray_tpu_torch.util import events as ev

    ev.record_event("deploy finished", severity="INFO", label="DEPLOY",
                    version="1.2.3")
    rows = ev.list_events(limit=50)
    labels = [r["label"] for r in rows]
    assert "DEPLOY" in labels
    mine = next(r for r in rows if r["label"] == "DEPLOY")
    assert mine["fields"]["version"] == "1.2.3"
    # the GCS recorded the node joining as an event
    assert any(r["label"] == "NODE_ADDED" for r in ev.list_events(
        source="gcs", limit=50
    ))
    with pytest.raises(ValueError):
        ev.record_event("bad", severity="LOUD")


def test_oom_kill_records_event(obs_cluster, tmp_path):
    """The memory-monitor kill path emits a WORKER_OOM_KILLED event."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch.util import events as ev

    # (covered end-to-end in test_object_plane's monitor test; here just
    # assert the query path filters correctly on an empty result)
    rows = ev.list_events(severity="FATAL", limit=10)
    assert rows == []


def test_worker_logs_reach_driver(obs_cluster, capfd):
    @ray_tpu_torch.remote
    def shouty():
        print("HELLO-FROM-WORKER-STDOUT-12321")
        return 1

    assert ray_tpu_torch.get(shouty.remote(), timeout=60) == 1
    # the raylet tails the worker log on log_tail_interval_s; wait for the
    # pubsub line to arrive and be printed by the driver's subscriber
    deadline = time.time() + 10
    seen = ""
    while time.time() < deadline:
        out = capfd.readouterr()
        seen += out.out + out.err
        if "HELLO-FROM-WORKER-STDOUT-12321" in seen:
            break
        time.sleep(0.2)
    assert "HELLO-FROM-WORKER-STDOUT-12321" in seen
    assert "pid=" in seen  # prefixed with worker identity
