"""Log plane core: per-task byte-range attribution + streaming helpers.

Analog of the reference's log pipeline (ray: python/ray/_private/
log_monitor.py tails per-worker files and publishes lines; worker.py
print_logs renders them on the driver with ``(pid=..., ip=...)`` prefixes
and a dedup window). TPU-native the pieces are split by process:

- workers (executor.py) record the byte offset of their own log file
  around user-code execution (``stdio_offset`` / ``attach_result_span``)
  and stamp the exact ``(log_file, start, end)`` span into the task-event
  pipeline — any finished task/actor method maps to an exact byte range
  of its worker's log, no grep required;
- raylets (raylet.py) tail their workers' files and attribute each line
  to a task by matching its byte offset against a per-worker
  ``SpanTable`` fed from the task events flowing through them;
- drivers (api.py) print the streamed lines with task-name prefixes and
  collapse identical lines fanning in from many workers via
  ``LogDeduplicator``.

Everything here is dependency-free and pure enough to unit test without
a cluster (see tests/test_logs.py).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

_TRUNC_MARK = b"... [truncated]"


# ---------------------------------------------------------------------------
# worker-side: log file identity + offset capture
# ---------------------------------------------------------------------------

def worker_log_path() -> Optional[str]:
    """This worker process's own log file (the raylet redirects worker
    stdout/stderr there and exports the path at spawn)."""
    return os.environ.get("RAY_TPU_TORCH_WORKER_LOG_FILE") or None


def stdio_offset(flush: bool = True) -> Optional[int]:
    """Current end offset of this worker's log file. Flushes stdio first
    so buffered ``print()`` output is actually in the file — python
    block-buffers stdout when redirected, so without the flush a task's
    prints could land outside its recorded span (and reach the tailer a
    task late)."""
    path = worker_log_path()
    if not path:
        return None
    try:
        if flush:
            sys.stdout.flush()
            sys.stderr.flush()
        return os.path.getsize(path)
    except (OSError, ValueError):
        # ValueError: stdio already closed during interpreter teardown
        return None


def attach_result_span(result: dict, start: Optional[int]) -> dict:
    """Stamp the executed task's exact log byte range onto its result
    dict (picked up by the raylet / direct-push event emitters)."""
    if start is None:
        return result
    end = stdio_offset()
    path = worker_log_path()
    if end is None or path is None:
        return result
    result["log_span"] = {
        "file": os.path.basename(path), "start": start, "end": max(end, start),
    }
    return result


def open_event_fields() -> dict:
    """Task-event fields announcing where in the log a task is ABOUT to
    start writing (a provisional open span; the exact range arrives with
    the FINISHED/FAILED event)."""
    start = stdio_offset()
    path = worker_log_path()
    if start is None or path is None:
        return {}
    return {"log_file": os.path.basename(path), "log_start": start}


# ---------------------------------------------------------------------------
# raylet-side: byte-offset -> task-name attribution
# ---------------------------------------------------------------------------

class SpanTable:
    """Byte-range -> task attribution for ONE worker's log file.

    Fed from the task events flowing through the raylet: RUNNING events
    open a provisional span at their ``log_start``; FINISHED/FAILED
    events close it with the executor-measured exact range. ``resolve``
    prefers closed (exact) spans over open ones, so lines printed by a
    previous task before its buffers flushed never mis-attribute to the
    next task whose provisional start preceded them.
    """

    def __init__(self, history: int = 128):
        self.history = history
        self._open: Dict[str, Tuple[int, str]] = {}  # task_id -> (start, name)
        self._closed: List[Tuple[int, int, str]] = []  # (start, end, name)

    def open_span(self, task_id: str, name: str, start: int):
        self._open[task_id] = (int(start), name)
        if len(self._open) > self.history:  # leaked opens (lost close)
            self._open.pop(next(iter(self._open)))

    def close_span(self, task_id: str, name: str, start: int, end: int):
        self._open.pop(task_id, None)
        if end > start:
            self._closed.append((int(start), int(end), name))
            if len(self._closed) > self.history:
                del self._closed[: len(self._closed) - self.history]

    def discard(self, task_id: str):
        self._open.pop(task_id, None)

    def resolve(self, offset: int) -> Optional[str]:
        """Task name owning the byte at ``offset`` (newest match wins)."""
        for start, end, name in reversed(self._closed):
            if start <= offset < end:
                return name
        best = None
        best_start = -1
        for start, name in self._open.values():
            if best_start < start <= offset:
                best, best_start = name, start
        return best

    def prune(self, upto: int):
        """Drop closed spans entirely behind the tailer (their bytes have
        been published; nothing will ask again)."""
        self._closed = [s for s in self._closed if s[1] > upto]


def truncate_line(raw: bytes, limit: int) -> Tuple[bytes, bool]:
    """Cap one log line at ``limit`` bytes (length-capped records: a task
    dumping a multi-MB blob on one line must not balloon pubsub frames)."""
    if limit > 0 and len(raw) > limit:
        return raw[:limit] + _TRUNC_MARK, True
    return raw, False


# ---------------------------------------------------------------------------
# driver-side: identical-line dedup window
# ---------------------------------------------------------------------------

class LogDeduplicator:
    """Collapse identical lines fanning in from many workers.

    The first occurrence prints immediately; identical lines arriving
    within ``window_s`` are counted instead of printed, and when the
    window expires one summary line with a ``[repeated Nx]`` suffix is
    emitted (ray parity: worker.py's log deduplicator). Keyed on the raw
    line text — the whole point is collapsing the same line from N
    different workers/pids.
    """

    def __init__(self, window_s: float = 1.0, max_entries: int = 1024,
                 color: bool = True):
        self.window_s = window_s
        self.max_entries = max_entries
        self.color = color
        # line -> {"first": ts, "count": suppressed, "prefix": str}
        self._seen: Dict[str, dict] = {}

    def _summary(self, prefix: str, line: str, count: int) -> str:
        suffix = f"[repeated {count}x]"
        if self.color:
            suffix = f"\x1b[2m{suffix}\x1b[0m"
        return f"{prefix}{line} {suffix}"

    def feed(self, prefix: str, line: str,
             now: Optional[float] = None) -> List[str]:
        """Returns the lines to print for this arrival (possibly none —
        suppressed duplicate — possibly several: expired summaries drain
        ahead of the new line so output stays ordered)."""
        now = time.monotonic() if now is None else now
        out = self.flush(now=now)
        entry = self._seen.get(line)
        if entry is not None:
            entry["count"] += 1
            entry["prefix"] = prefix
            return out
        if len(self._seen) >= self.max_entries:
            stale = next(iter(self._seen))
            e = self._seen.pop(stale)
            if e["count"]:
                out.append(self._summary(e["prefix"], stale, e["count"]))
        self._seen[line] = {"first": now, "count": 0, "prefix": prefix}
        out.append(prefix + line)
        return out

    def flush(self, now: Optional[float] = None,
              force: bool = False) -> List[str]:
        """Emit ``[repeated Nx]`` summaries for expired windows (all
        windows when ``force``, e.g. at shutdown). Entries sit in
        insertion order and ``first`` is never updated, so the scan stops
        at the first live window — feed() calls this per line, and a
        full scan there was O(lines x window-population), the measured
        hot spot of the BENCH_LOG_OVERHEAD lane."""
        now = time.monotonic() if now is None else now
        expired = []
        for line, entry in self._seen.items():  # NO dict copy: feed()
            # calls this per line, and copying the window population per
            # line was the measured hot spot of BENCH_LOG_OVERHEAD
            if not force and now - entry["first"] <= self.window_s:
                break  # everything after was inserted later: still live
            expired.append((line, entry))
        out = []
        for line, entry in expired:
            del self._seen[line]
            if entry["count"]:
                out.append(
                    self._summary(entry["prefix"], line, entry["count"]))
        return out
