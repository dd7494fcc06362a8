"""Trial state machine (ray parity: python/ray/tune/experiment/trial.py)."""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(
        self,
        trainable_name: str,
        config: Optional[Dict] = None,
        trial_id: Optional[str] = None,
        experiment_dir: Optional[str] = None,
        resources: Optional[Dict[str, float]] = None,
        evaluated_params: Optional[str] = None,
        max_failures: int = 0,
    ):
        self.trainable_name = trainable_name
        self.config = dict(config or {})
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.experiment_dir = experiment_dir
        self.resources = dict(resources or {"CPU": 1.0})
        self.evaluated_params = evaluated_params or ""
        self.max_failures = max_failures

        self.status = Trial.PENDING
        self.last_result: Dict[str, Any] = {}
        self.metric_history: List[Dict[str, Any]] = []
        self.error_msg: Optional[str] = None
        self.num_failures = 0
        # Latest checkpoint payload (object-store dict) for restore/exploit.
        self.checkpoint: Optional[Dict] = None
        self.checkpoint_iter: int = 0
        self.restore_pending: bool = False
        # Bumped on every actor (re)start; detects restarts that happen
        # underneath an in-flight result (PBT exploit).
        self.generation: int = 0

    @property
    def experiment_tag(self) -> str:
        tag = self.trial_id
        if self.evaluated_params:
            tag += "_" + self.evaluated_params
        return tag

    @property
    def local_path(self) -> Optional[str]:
        if not self.experiment_dir:
            return None
        path = os.path.join(
            self.experiment_dir, f"{self.trainable_name}_{self.experiment_tag}"
        )
        return path

    def is_finished(self) -> bool:
        return self.status in (Trial.TERMINATED, Trial.ERROR)

    def __repr__(self):
        return f"Trial({self.trainable_name}_{self.trial_id}, {self.status})"
