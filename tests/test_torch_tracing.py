"""The port's counterpart of ``tests/test_tracing.py`` (4 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name.

The reference's description:

Tracing: spans, driver->worker propagation, timeline integration.

ray parity: python/ray/tests/test_tracing.py (opt-in OTel tracing with
span context injected into task calls).
"""

import time

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from tests.torch_fixtures import port_regular  # noqa: F401


def _wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.3)
    raise TimeoutError("condition not met")


def test_spans_nest_and_propagate(port_regular):
    tracing.enable()
    try:
        @ray_tpu_torch.remote
        def traced_work(x):
            return x + 1

        with tracing.span("driver-root", phase="test") as root:
            assert ray_tpu_torch.get(traced_work.remote(1), timeout=60) == 2
            with tracing.span("inner"):
                pass
            trace_id = root["trace_id"]
        tracing.flush()

        spans = _wait_for(
            lambda: [s for s in tracing.get_spans(trace_id)
                     if s["name"] == "task::traced_work"] or None
        )
        # the worker-side execution span parents into the driver's root
        all_spans = tracing.get_spans(trace_id)
        by_name = {s["name"]: s for s in all_spans}
        assert "driver-root" in by_name and "inner" in by_name
        root_span = by_name["driver-root"]
        # span records carry span_id as task_id; inner must parent to root
        assert by_name["inner"]["parent_span_id"] == root_span["task_id"]
        task_span = spans[0]
        assert task_span["trace_id"] == trace_id
        assert task_span["parent_span_id"] is not None
        assert task_span["duration"] >= 0
    finally:
        tracing.disable()


def test_multihop_propagation(port_regular):
    """A traced task's nested .remote() call stays in the same trace
    (ray: span context injected hop by hop)."""
    tracing.enable()
    try:
        @ray_tpu_torch.remote
        def leaf():
            return "leaf"

        @ray_tpu_torch.remote
        def mid():
            import ray_tpu_torch as rt

            return rt.get(leaf.remote(), timeout=60)

        with tracing.span("hop-root") as root:
            assert ray_tpu_torch.get(mid.remote(), timeout=120) == "leaf"
            trace_id = root["trace_id"]
        tracing.flush()

        spans = _wait_for(
            lambda: (lambda ss: ss if {"task::mid", "task::leaf"} <=
                     {s["name"] for s in ss} else None)(
                tracing.get_spans(trace_id))
        )
        by_name = {s["name"]: s for s in spans}
        # leaf's span parents into mid's span: same trace, chained hops
        assert by_name["task::leaf"]["parent_span_id"] == \
            by_name["task::mid"]["task_id"]
    finally:
        tracing.disable()


def test_driver_span_parents_worker_span_in_timeline(port_regular):
    """e2e for the cross-process propagation path (tracing.py
    record_remote_span): a span opened on the DRIVER parents the
    worker-side execution span, and BOTH render in ray_tpu_torch.timeline()
    output as complete slices."""
    tracing.enable()
    try:
        @ray_tpu_torch.remote
        def traced_leaf():
            return 7

        with tracing.span("timeline-root") as root:
            assert ray_tpu_torch.get(traced_leaf.remote(), timeout=60) == 7
            trace_id = root["trace_id"]
        tracing.flush()

        spans = _wait_for(
            lambda: [s for s in tracing.get_spans(trace_id)
                     if s["name"] == "task::traced_leaf"] or None
        )
        root_span = next(s for s in tracing.get_spans(trace_id)
                         if s["name"] == "timeline-root")
        # parentage: the worker-side execution span chains to the driver's
        assert spans[0]["parent_span_id"] == root_span["task_id"]

        trace = ray_tpu_torch.timeline()
        by_name = {e["name"]: e for e in trace if e.get("cat") == "span"}
        assert "timeline-root" in by_name, "driver span missing in timeline"
        assert "task::traced_leaf" in by_name, "worker span missing"
        child, parent = by_name["task::traced_leaf"], by_name["timeline-root"]
        # same trace, linked parent, and the child interval nests inside
        assert child["args"]["trace_id"] == parent["args"]["trace_id"]
        assert child["args"]["parent_span_id"] == parent["args"]["span_id"]
        assert child["ts"] >= parent["ts"] - 1e3  # clock skew slack (us)
        # the limit= knob caps the raw event fetch without breaking shape
        assert isinstance(ray_tpu_torch.timeline(limit=5), list)
    finally:
        tracing.disable()


def test_disabled_tracing_is_noop(port_regular):
    tracing.disable()
    with tracing.span("nope") as rec:
        assert rec is None
    assert tracing.current_context() is None
