"""Distributed tracing: spans that propagate driver -> worker.

ray parity: python/ray/util/tracing/tracing_helper.py — the reference
lazily proxies OpenTelemetry and injects span context into task/actor
calls via a hidden parameter so spans nest across processes. TPU-native
and dependency-free: spans buffer in-process and flush through the GCS
task-event log (the same pipeline the timeline reads), and the current
span context rides the TaskSpec so worker-side execution spans parent
correctly. Enable with ``RAY_TPU_TORCH_TRACING=1`` or ``tracing.enable()``; when
an ``opentelemetry`` install is importable, finished spans are mirrored to
its tracer too.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_local = threading.local()
_enabled: Optional[bool] = None
_otel_tracer = None


def enable():
    global _enabled
    _enabled = True
    _try_otel()


def disable():
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get("RAY_TPU_TORCH_TRACING", "0") == "1"


def _try_otel():
    global _otel_tracer
    if _otel_tracer is not None:
        return
    try:  # optional mirror; absent in this image
        from opentelemetry import trace as otel_trace

        _otel_tracer = otel_trace.get_tracer("ray_tpu_torch")
    except ImportError:
        _otel_tracer = False


def current_context() -> Optional[Dict[str, str]]:
    """(trace_id, span_id) of the innermost open span, for injection into
    outgoing task specs."""
    stack = getattr(_local, "stack", None)
    if not stack:
        return None
    top = stack[-1]
    return {"trace_id": top["trace_id"], "span_id": top["span_id"]}


def set_remote_context(ctx: Optional[Dict[str, str]]):
    """Adopt a propagated context as the parent for spans opened in this
    thread (the executor sets it on the user-code thread while a traced
    task runs, so nested .remote() calls stay in the trace)."""
    _local.remote_ctx = ctx


def propagation_context() -> Optional[Dict[str, str]]:
    """Context to stamp on outgoing task specs: the innermost open span,
    else an adopted remote context. Unlike span(), this works even when
    this process never called enable() — the submitter upstream decided
    the trace exists, and it must survive multi-hop task graphs."""
    ctx = current_context()
    if ctx is not None:
        return ctx
    return getattr(_local, "remote_ctx", None)


@contextmanager
def span(name: str, **attributes):
    """Record one span; no-op (zero overhead beyond a check) when tracing
    is disabled."""
    if not is_enabled():
        yield None
        return
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    if stack:
        trace_id = stack[-1]["trace_id"]
        parent = stack[-1]["span_id"]
    else:
        remote = getattr(_local, "remote_ctx", None)
        if remote:
            trace_id = remote["trace_id"]
            parent = remote["span_id"]
        else:
            trace_id = uuid.uuid4().hex
            parent = None
    rec = {
        "trace_id": trace_id,
        "span_id": uuid.uuid4().hex[:16],
        "parent_span_id": parent,
        "name": name,
        "start": time.time(),
        "attributes": {k: str(v) for k, v in attributes.items()},
    }
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()
        rec["end"] = time.time()
        _record(rec)


def _record(rec: Dict[str, Any]):
    if _otel_tracer is None:  # env-var enablement path never ran enable()
        _try_otel()
    buf = getattr(_local, "buffer", None)
    if buf is None:
        buf = _local.buffer = []
    buf.append(rec)
    if len(buf) >= 64:
        flush()
    if _otel_tracer:
        try:  # mirror into a real OTel span (timestamps preserved)
            otel_span = _otel_tracer.start_span(
                rec["name"], start_time=int(rec["start"] * 1e9)
            )
            for k, v in rec["attributes"].items():
                otel_span.set_attribute(k, v)
            otel_span.end(end_time=int(rec["end"] * 1e9))
        except Exception:
            pass


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def record_remote_span(name: str, start: float, end: float,
                       parent_ctx: Dict[str, str],
                       attributes: Optional[Dict[str, str]] = None,
                       span_id: Optional[str] = None):
    """Record one completed span with an EXPLICIT propagated parent and
    flush immediately. Used by the task executor: it holds no thread-local
    state, so concurrently interleaved tasks cannot corrupt each other's
    parentage, and it works regardless of this process's enable latch
    (the SUBMITTER's tracing decision rides the spec)."""
    rec = {
        "trace_id": parent_ctx["trace_id"],
        "span_id": span_id or new_span_id(),
        "parent_span_id": parent_ctx["span_id"],
        "name": name,
        "start": start,
        "end": end,
        "attributes": {k: str(v) for k, v in (attributes or {}).items()},
    }
    _record(rec)
    flush()


def flush():
    """Push buffered spans into the GCS task-event log (they appear in
    ray_tpu_torch.timeline() and util.state.list_task_events)."""
    buf = getattr(_local, "buffer", None)
    if not buf:
        return
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    if cw is None:
        return
    events = []
    for rec in buf:
        events.append({
            "task_id": rec["span_id"],
            "name": rec["name"],
            "job_id": None,
            "actor_id": None,
            "attempt": 0,
            "state": "SPAN",
            "ts": rec["end"],
            "node_id": getattr(cw, "node_id", ""),
            "duration": rec["end"] - rec["start"],
            "trace_id": rec["trace_id"],
            "parent_span_id": rec["parent_span_id"],
            "span_start": rec["start"],
            "attributes": rec["attributes"],
            "pid": os.getpid(),
        })
    try:
        import asyncio

        try:
            on_io_loop = asyncio.get_running_loop() is cw.io.loop
        except RuntimeError:
            on_io_loop = False
        coro = cw.gcs.request("add_task_events", {"events": events})
        if on_io_loop:
            # Called from the io loop itself (executor task span): blocking
            # io.run here would deadlock — fire and forget.
            cw.io.call_soon(coro)
        else:
            cw.io.run(coro)
        _local.buffer = []
    except Exception:
        pass


def get_spans(trace_id: Optional[str] = None,
              limit: Optional[int] = None) -> List[dict]:
    """Spans recorded cluster-wide (from the GCS task-event log).
    ``limit`` caps the raw events fetched (default 100k)."""
    from ray_tpu_torch.util.state import list_task_events

    spans = [e for e in list_task_events(limit=limit or 100_000)
             if e.get("state") == "SPAN"]
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    return spans
