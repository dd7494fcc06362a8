"""The port's counterpart of ``tests/test_logs.py`` (19 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name. ``test_lint_print_forbids_bare_prints`` runs the port's own lint,
``ray_tpu_torch/tools/lint_print.py``, over ``ray_tpu_torch/_private`` (the
reference's runs ``scripts/lint_print.py`` over ``ray_tpu/_private``).

The reference's description:

Cluster log plane tests.

Analog of ray: python/ray/tests/test_logging.py (driver log streaming,
dedup) + the `ray logs` state-API tests — plus the TPU-native
differentiator: per-task byte-range attribution (executors stamp exact
(log_file, start, end) spans into the task-event pipeline, so a task's
output is an offset read, never a grep).
"""

import json
import os
import subprocess
import sys
import time
import uuid

import pytest
import requests

import ray_tpu_torch
from ray_tpu_torch._private import logplane
from ray_tpu_torch.util import state
from tests.torch_fixtures import port_regular  # noqa: F401

pytestmark = pytest.mark.logs

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# pure units: dedup window
# ---------------------------------------------------------------------------

def test_dedup_first_immediate_then_repeated_suffix():
    d = logplane.LogDeduplicator(window_s=1.0, color=False)
    out = d.feed("(a pid=1) ", "same line", now=0.0)
    assert out == ["(a pid=1) same line"]
    # 7 more identical lines from other workers inside the window: silent
    for i in range(7):
        assert d.feed(f"(a pid={i}) ", "same line", now=0.1 * i) == []
    # window expires: ONE summary line with the [repeated Nx] suffix
    out = d.flush(now=5.0)
    assert out == ["(a pid=6) same line [repeated 7x]"]
    assert d.flush(now=9.0) == []  # nothing pending


def test_dedup_distinct_lines_pass_through_and_forced_flush():
    d = logplane.LogDeduplicator(window_s=10.0, color=False)
    assert d.feed("(p) ", "alpha", now=0.0) == ["(p) alpha"]
    assert d.feed("(p) ", "beta", now=0.1) == ["(p) beta"]
    assert d.feed("(p) ", "alpha", now=0.2) == []  # duplicate suppressed
    # forced flush (driver shutdown) drains summaries even mid-window
    assert d.flush(now=0.3, force=True) == ["(p) alpha [repeated 1x]"]


def test_dedup_expired_summaries_drain_before_new_lines():
    d = logplane.LogDeduplicator(window_s=1.0, color=False)
    d.feed("(p) ", "x", now=0.0)
    d.feed("(q) ", "x", now=0.5)
    out = d.feed("(r) ", "fresh", now=3.0)  # arrival past x's window
    assert out == ["(q) x [repeated 1x]", "(r) fresh"]


# ---------------------------------------------------------------------------
# pure units: length caps + span table
# ---------------------------------------------------------------------------

def test_truncate_line_caps_and_marks():
    raw, cut = logplane.truncate_line(b"x" * 100, 10)
    assert cut and raw.startswith(b"xxxxxxxxxx") and b"[truncated]" in raw
    raw, cut = logplane.truncate_line(b"short", 10)
    assert not cut and raw == b"short"


def test_span_table_closed_beats_open_and_prunes():
    t = logplane.SpanTable(history=8)
    # previous task's exact closed range [0, 100); next task's provisional
    # open starts early at 40 (raylet saw the file before buffers flushed)
    t.open_span("t2", "next_task", 40)
    t.close_span("t1", "prev_task", 0, 100)
    assert t.resolve(50) == "prev_task"   # closed (exact) wins
    assert t.resolve(120) == "next_task"  # past the closed range: open
    assert t.resolve(100) == "next_task"  # end is exclusive
    t.close_span("t2", "next_task", 100, 200)
    assert t.resolve(150) == "next_task"
    t.prune(200)  # tailer consumed everything
    assert t.resolve(50) is None
    t.discard("missing")  # no-op


def test_span_table_bounded_history():
    t = logplane.SpanTable(history=4)
    for i in range(20):
        t.close_span(f"t{i}", f"task{i}", i * 10, i * 10 + 10)
    assert len(t._closed) == 4
    assert t.resolve(195) == "task19"


# ---------------------------------------------------------------------------
# pure units: agent tail window scaling + range reads + name validation
# ---------------------------------------------------------------------------

def test_tail_window_scales_to_request(tmp_path):
    from ray_tpu_torch.dashboard.agent import tail_file

    path = tmp_path / "big.out"
    lines = [f"line-{i:06d}" + "x" * 120 for i in range(5000)]
    path.write_bytes(b"\n".join(l.encode() for l in lines) + b"\n")
    # 2000 lines x ~130B ~= 260KB — past the old fixed 256KiB window
    out, start, end = tail_file(str(path), 2000)
    assert len(out) == 2000
    assert out[0] == lines[3000]   # exact, complete first line (not torn)
    assert out[-1] == lines[-1]
    assert end == path.stat().st_size


def test_tail_drops_torn_leading_line(tmp_path):
    from ray_tpu_torch.dashboard.agent import tail_file

    path = tmp_path / "torn.out"
    lines = [f"L{i}:" + "y" * 997 for i in range(200)]  # ~1KB lines
    path.write_bytes(b"\n".join(l.encode() for l in lines) + b"\n")
    out, start, _ = tail_file(str(path), 3)
    assert out == lines[-3:]
    # the returned start offset points at a line boundary
    with open(path, "rb") as f:
        f.seek(max(0, start - 1))
        assert start == 0 or f.read(1) == b"\n"


def test_range_read_exact_bytes(tmp_path):
    from ray_tpu_torch.dashboard.agent import read_range

    path = tmp_path / "r.out"
    path.write_bytes(b"aaaa\nbbbb\ncccc\n")
    assert read_range(str(path), 5, 10) == b"bbbb\n"
    assert read_range(str(path), 10, 10_000) == b"cccc\n"  # clamped to EOF


def test_bad_log_filenames_rejected():
    from ray_tpu_torch.dashboard.agent import safe_log_name

    assert safe_log_name("worker-abc-1.out")
    for bad in ("../secret", "a/b.out", ".hidden", "", "..\\win", "/etc/pw"):
        assert not safe_log_name(bad), bad


# ---------------------------------------------------------------------------
# pure unit: raylet tailer (attribution segs, per-tick byte budget)
# ---------------------------------------------------------------------------

class _FakeProc:
    pid = 4242


class _FakeWorker:
    def __init__(self, path):
        self.proc = _FakeProc()
        self.job_id = b"\x01\x02"
        self.log_path = str(path)
        self.log_offset = 0
        self.log_partial = b""
        self.log_spans = logplane.SpanTable()
        self.log_name = None


def test_tail_worker_log_attributes_by_offset(tmp_path):
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "w.out"
    data = b"pre\nfrom-task-a\nfrom-task-a2\nafter\n"
    path.write_bytes(data)
    w = _FakeWorker(path)
    a_start = data.index(b"from-task-a")
    a_end = data.index(b"after")
    w.log_spans.close_span("ta", "task_a", a_start, a_end)
    # first look holds: the batch starts with an unresolved fresh line
    # ("pre") and worker-side task events are debounced, so unattributed
    # fresh lines wait one tail tick for their span to land
    entry, stats = _tail_worker_log(w)
    assert entry is None and stats["lines"] == 0
    entry, stats = _tail_worker_log(w)
    assert stats["lines"] == 4 and stats["truncated"] == 0
    assert entry["pid"] == 4242
    assert entry["segs"] == [
        [None, ["pre"]],
        ["task_a", ["from-task-a", "from-task-a2"]],
        [None, ["after"]],
    ]
    # nothing new -> no entry
    entry, stats = _tail_worker_log(w)
    assert entry is None and stats["lines"] == 0


def test_tail_worker_log_budget_and_truncation(tmp_path):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch._private.raylet import _tail_worker_log

    path = tmp_path / "chatty.out"
    path.write_bytes(b"\n".join(b"z" * 200 for _ in range(2000)) + b"\n")
    w = _FakeWorker(path)
    old_budget = cfg.log_publish_max_bytes
    old_cap = cfg.log_max_line_bytes
    try:
        cfg.update({"log_publish_max_bytes": 64 * 1024,
                    "log_max_line_bytes": 50})
        # first look holds the fresh unresolved batch (span-less lines
        # wait one tick); the second look publishes it
        entry, stats = _tail_worker_log(w)
        assert entry is None and stats["lines"] == 0
        entry, stats = _tail_worker_log(w)
        # bounded per tick: well under the whole file, lines length-capped
        assert 0 < stats["lines"] < 2000
        assert stats["truncated"] == stats["lines"]
        assert all(len(l) < 80 for _, ls in entry["segs"] for l in ls)
        first_batch = stats["lines"]
        # the next tick continues where the budget stopped
        entry2, stats2 = _tail_worker_log(w)
        assert stats2["lines"] > 0
        assert w.log_offset <= path.stat().st_size
        assert first_batch + stats2["lines"] <= 2000
    finally:
        cfg.update({"log_publish_max_bytes": old_budget,
                    "log_max_line_bytes": old_cap})


def test_lint_print_forbids_bare_prints(tmp_path):
    """CI satellite: the port's own lint, ray_tpu_torch/tools/lint_print.py
    (never the reference's scripts/lint_print.py), passes on
    ray_tpu_torch/_private and fails on a violating tree."""
    script = os.path.join(REPO_ROOT, "ray_tpu_torch", "tools",
                          "lint_print.py")
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.join("ray_tpu_torch", "_private") in r.stdout
    bad = tmp_path / "mod.py"
    bad.write_text('print("oops")\n'
                   'print("fine", file=__import__("sys").stderr)\n'
                   'print("annotated")  # lint: allow-print\n')
    r = subprocess.run([sys.executable, script, str(tmp_path)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 1
    assert "mod.py:1" in r.stdout and "mod.py:2" not in r.stdout


# ---------------------------------------------------------------------------
# cluster: attribution offsets, state/CLI/dashboard surfaces, streaming
# ---------------------------------------------------------------------------

def _wait_for(fn, timeout=45.0, interval=0.3):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
        except Exception as e:  # surfaces flaky probes on timeout
            last = e
        time.sleep(interval)
    raise TimeoutError(f"condition not met (last: {last!r})")


def _wait_agents():
    """Every alive node's agent answers its log listing."""
    def probe():
        listing = state.list_logs()
        return listing and all(
            isinstance(files, list) for files in listing.values()
        ) and listing or None
    return _wait_for(probe, timeout=60)


def test_task_output_attributed_by_exact_offsets(port_regular):
    """get_log(task_id) returns exactly that task's lines — resolved via
    the executor-stamped byte range, so a sibling task's output printed
    into the SAME worker log never bleeds in."""
    mark_a, mark_b = uuid.uuid4().hex[:12], uuid.uuid4().hex[:12]

    @ray_tpu_torch.remote
    def shout(mark, n):
        for i in range(n):
            print(f"shout-{mark}-{i}")
        return mark

    ref_a = shout.remote(mark_a, 3)
    assert ray_tpu_torch.get(ref_a, timeout=60) == mark_a
    ref_b = shout.remote(mark_b, 2)
    assert ray_tpu_torch.get(ref_b, timeout=60) == mark_b
    _wait_agents()
    tid_a = ref_a.id().task_id().hex()
    tid_b = ref_b.id().task_id().hex()

    lines_a = _wait_for(lambda: state.get_log(task_id=tid_a))
    assert [l for l in lines_a if "shout-" in l] == \
        [f"shout-{mark_a}-{i}" for i in range(3)]
    assert not any(mark_b in l for l in lines_a)
    lines_b = _wait_for(lambda: state.get_log(task_id=tid_b))
    assert [l for l in lines_b if "shout-" in l] == \
        [f"shout-{mark_b}-{i}" for i in range(2)]
    assert not any(mark_a in l for l in lines_b)


def test_list_logs_and_get_log_filename(port_regular):
    listing = _wait_agents()
    files = [f["file"] for files in listing.values() for f in files]
    worker_logs = [f for f in files if f.startswith("worker-")]
    assert worker_logs, files
    lines = state.get_log(filename=worker_logs[0], tail=5)
    assert isinstance(lines, list)
    with pytest.raises(ValueError):
        state.get_log(filename="no-such-file.out")
    with pytest.raises(ValueError):
        state.get_log()  # exactly one selector required


def test_actor_log_via_attribution(port_regular):
    mark = uuid.uuid4().hex[:12]

    @ray_tpu_torch.remote
    class Chatter:
        def speak(self, i):
            print(f"actor-{mark}-{i}")
            return i

    c = Chatter.remote()
    assert ray_tpu_torch.get(c.speak.remote(1), timeout=60) == 1
    _wait_agents()
    from ray_tpu_torch._private.ids import ActorID

    aid = ActorID(c._actor_id).hex()
    lines = _wait_for(lambda: [
        l for l in state.get_log(actor_id=aid, tail=200)
        if f"actor-{mark}-1" in l
    ])
    assert lines


def test_driver_stream_prefix_carries_task_name(port_regular, capfd):
    mark = uuid.uuid4().hex[:12]

    @ray_tpu_torch.remote
    def named_shouter():
        print(f"stream-{mark}")
        return 1

    assert ray_tpu_torch.get(named_shouter.remote(), timeout=60) == 1
    seen = ""
    deadline = time.time() + 20
    while time.time() < deadline:
        out = capfd.readouterr()
        seen += out.out + out.err
        if f"stream-{mark}" in seen:
            break
        time.sleep(0.2)
    line = next(l for l in seen.splitlines() if f"stream-{mark}" in l)
    # (<TaskName> pid=<pid> node=<id8>) prefix, attributed by offset span
    assert "named_shouter" in line and "pid=" in line and "node=" in line


def test_finished_event_carries_log_span(port_regular):
    mark = uuid.uuid4().hex[:12]

    @ray_tpu_torch.remote
    def spanner():
        print(f"span-{mark}")
        return 1

    ref = spanner.remote()
    assert ray_tpu_torch.get(ref, timeout=60) == 1
    tid = ref.id().task_id().hex()

    def finished_ev():
        for ev in state.list_task_events(limit=100_000):
            if ev.get("task_id") == tid and ev.get("state") == "FINISHED":
                return ev
        return None

    ev = _wait_for(finished_ev)
    assert ev.get("log_file", "").startswith("worker-")
    assert isinstance(ev.get("log_start"), int)
    assert ev.get("log_end", 0) > ev["log_start"]
    # the recorded range really contains the printed bytes
    assert ev["log_end"] - ev["log_start"] >= len(f"span-{mark}\n")


def test_dashboard_logs_endpoints(port_regular):
    from ray_tpu_torch.dashboard.head import start_dashboard, stop_dashboard

    mark = uuid.uuid4().hex[:12]

    @ray_tpu_torch.remote
    def api_shout():
        print(f"api-{mark}")
        return 1

    ref = api_shout.remote()
    assert ray_tpu_torch.get(ref, timeout=60) == 1
    _wait_agents()
    tid = ref.id().task_id().hex()
    port = start_dashboard()
    base = f"http://127.0.0.1:{port}/api/v0"
    try:
        listing = requests.get(f"{base}/logs", timeout=30).json()
        assert listing and all(isinstance(v, list) for v in listing.values())
        node_id, files = next(iter(listing.items()))
        fname = next(f["file"] for f in files
                     if f["file"].startswith("worker-"))
        tail = requests.get(f"{base}/logs/tail", params={
            "file": fname, "lines": 10, "node_id": node_id,
        }, timeout=30).json()
        assert "lines" in tail
        # bad names bounce before touching the filesystem
        r = requests.get(f"{base}/logs/tail",
                         params={"file": "../secret"}, timeout=30)
        assert r.json().get("error")
        task = _wait_for(lambda: (lambda p: p if p.get("lines") else None)(
            requests.get(f"{base}/logs/task", params={"task_id": tid},
                         timeout=30).json()))
        assert any(f"api-{mark}" in l for l in task["lines"])
    finally:
        stop_dashboard()
