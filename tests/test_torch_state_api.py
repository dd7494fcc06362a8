"""The port's counterpart of ``tests/test_state_api.py`` (5 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

State API + task events + timeline + metrics.

Reference analogs: ray python/ray/tests/test_state_api.py (list_actors/
list_tasks/...), `ray timeline` chrome trace, util/metrics.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state

from tests.torch_fixtures import port_regular  # noqa: F401


@ray_tpu_torch.remote
def work(x):
    return x * 2


@ray_tpu_torch.remote
class Greeter:
    def hi(self):
        return "hi"


def _wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.3)
    raise TimeoutError("condition not met")


def test_list_tasks_and_summary(port_regular):
    refs = [work.remote(i) for i in range(5)]
    assert ray_tpu_torch.get(refs, timeout=60) == [0, 2, 4, 6, 8]

    # Task events are flushed in batches; wait for the FINISHED records.
    def finished():
        rows = state.list_tasks(filters=[("state", "=", "FINISHED"),
                                         ("name", "=", "work")])
        return rows if len(rows) >= 5 else None

    rows = _wait_for(finished)
    assert all(r["node_id"] for r in rows)
    assert all(r.get("duration") is not None for r in rows)

    summary = state.summarize_tasks()
    assert summary["work"]["FINISHED"] >= 5


def test_list_actors_and_nodes(port_regular):
    g = Greeter.remote()
    assert ray_tpu_torch.get(g.hi.remote(), timeout=60) == "hi"
    actors = state.list_actors(filters=[("state", "=", "ALIVE")])
    assert any(a["class_name"] == "Greeter" for a in actors)

    nodes = state.list_nodes()
    assert len(nodes) >= 1
    assert all("resources_total" in n for n in nodes)

    stats = state.get_node_stats(nodes[0]["node_id"])
    assert stats is not None and "store_used_bytes" in stats


def test_list_objects(port_regular):
    import numpy as np

    ref = ray_tpu_torch.put(np.zeros(200_000, dtype=np.float32))  # plasma-sized
    objs = _wait_for(
        lambda: [o for o in state.list_objects()
                 if o["object_id"] == ref.binary().hex()] or None
    )
    assert objs[0]["locations"]
    del ref


def test_timeline_chrome_trace(port_regular, tmp_path):
    ray_tpu_torch.get([work.remote(i) for i in range(3)], timeout=60)
    path = str(tmp_path / "trace.json")
    trace = _wait_for(
        lambda: [e for e in ray_tpu_torch.timeline(path)
                 if e["name"] == "work"] or None
    )
    ev = trace[0]
    assert ev["ph"] == "X" and ev["dur"] >= 1.0
    import json

    with open(path) as f:
        assert json.load(f)


def test_metrics_counter_gauge_histogram(port_regular):
    from ray_tpu_torch.util import metrics

    c = metrics.Counter("test_requests", tag_keys=("route",))
    c.inc(1.0, tags={"route": "/a"})
    c.inc(2.0, tags={"route": "/a"})
    g = metrics.Gauge("test_depth")
    g.set(7.0)
    h = metrics.Histogram("test_latency", boundaries=[1, 10])
    h.observe(0.5)
    h.observe(5.0)
    h.observe(50.0)
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(ValueError):
        c.inc(1.0, tags={"bogus": "x"})

    metrics.flush()
    out = metrics.list_metrics()
    counter = out["test_requests"][0]
    assert counter["series"][0]["value"] == 3.0
    assert out["test_depth"][0]["series"][0]["value"] == 7.0
    hist = out["test_latency"][0]["series"][0]
    assert hist["buckets"] == [1, 1, 1] and hist["count"] == 3
