"""Per-operator execution stats.

ray parity: python/ray/data/_internal/stats.py (DatasetStats — per-stage
wall time, task counts, output rows/bytes, and the formatted summary
``Dataset.stats()`` prints).
"""

from __future__ import annotations

import time
from typing import List, Optional


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


class OpStats:
    """One operator's counters, filled in while its stage runs."""

    def __init__(self, name: str):
        self.name = name
        self.num_tasks = 0
        self.num_rows = 0
        self.output_bytes = 0
        self.wall_time_s = 0.0
        self.backpressure_s = 0.0  # time admission blocked on the budget
        self.peak_inflight_tasks = 0
        self._started: Optional[float] = None

    def start(self):
        if self._started is None:
            self._started = time.perf_counter()

    def finish(self):
        # idempotent: an operator that closed itself (AllToAll barrier)
        # must not have its wall time stretched by ExecStats.finalize()
        if self._started is not None:
            self.wall_time_s = time.perf_counter() - self._started
            self._started = None

    def record_output(self, meta):
        self.num_tasks += 1
        self.num_rows += meta.num_rows or 0
        self.output_bytes += meta.size_bytes or 0

    def summary_row(self) -> str:
        bp = f", backpressure {self.backpressure_s:.2f}s" \
            if self.backpressure_s > 0.005 else ""
        return (
            f"  {self.name}: {self.num_tasks} tasks, "
            f"{self.num_rows} rows, {_fmt_bytes(self.output_bytes)}, "
            f"{self.wall_time_s:.2f}s wall"
            f", peak {self.peak_inflight_tasks} in-flight{bp}"
        )


class ExecStats:
    """Whole-plan stats (one OpStats per executed operator)."""

    def __init__(self):
        self.ops: List[OpStats] = []
        self._t0 = time.perf_counter()
        self.total_s: Optional[float] = None
        # actual yielded plan output, counted by the executor; ops[-1] is
        # wrong when the final stage (Limit/Zip/Union) records no OpStats
        self.out_rows: Optional[int] = None
        self.out_bytes: Optional[int] = None

    def record_yield(self, meta):
        self.out_rows = (self.out_rows or 0) + (meta.num_rows or 0)
        self.out_bytes = (self.out_bytes or 0) + (meta.size_bytes or 0)

    def op(self, name: str) -> OpStats:
        st = OpStats(name)
        self.ops.append(st)
        return st

    def finalize(self):
        if self.total_s is None:
            self.total_s = time.perf_counter() - self._t0
            for op in self.ops:
                op.finish()

    def summary(self) -> str:
        self.finalize()
        lines = ["Execution stats:"]
        lines.extend(op.summary_row() for op in self.ops)
        if self.out_rows is not None:
            rows, out_bytes = self.out_rows, self.out_bytes or 0
        else:
            rows = self.ops[-1].num_rows if self.ops else 0
            out_bytes = self.ops[-1].output_bytes if self.ops else 0
        lines.append(
            f"Total: {self.total_s:.2f}s, output {rows} rows "
            f"({_fmt_bytes(out_bytes)})"
        )
        return "\n".join(lines)
