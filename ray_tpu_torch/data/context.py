"""DataContext: per-driver execution configuration for Data pipelines.

ray parity: python/ray/data/context.py (DataContext.get_current() — the
ambient settings object every Dataset execution reads) — trimmed to the
knobs this executor honors: in-flight task window, per-operator memory
budget for streaming backpressure, ordering, and block sizing.
"""

from __future__ import annotations

import threading
from typing import Optional

# Default per-operator in-flight byte budget: matches the reference's
# default object-store-fraction heuristic scaled to one operator
# (streaming_executor_state.py budgets operator outqueues against the
# object store; a quarter GiB per op is its observed default envelope).
DEFAULT_OP_MEMORY_BUDGET = 256 * 1024 * 1024

DEFAULT_TARGET_MAX_BLOCK_SIZE = 128 * 1024 * 1024


class DataContext:
    _lock = threading.Lock()
    _current: Optional["DataContext"] = None

    def __init__(self):
        # max concurrently running tasks per map/read operator
        self.max_in_flight_tasks = 8
        # estimated in-flight output bytes an operator may hold before new
        # task admission blocks (memory-budget backpressure)
        self.op_memory_budget = DEFAULT_OP_MEMORY_BUDGET
        # seed estimate for a task's output before any task of the
        # operator has completed
        self.target_max_block_size = DEFAULT_TARGET_MAX_BLOCK_SIZE
        self.preserve_order = True
        # record per-operator stats during execution (Dataset.stats())
        self.enable_stats = True

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = DataContext()
            return cls._current

    @classmethod
    def _set_current(cls, ctx: "DataContext"):
        with cls._lock:
            cls._current = ctx
