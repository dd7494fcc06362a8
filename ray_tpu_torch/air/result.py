"""Result (ray parity: python/ray/air/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_dataframe: Any = None
    best_checkpoints: List = field(default_factory=list)

    @property
    def config(self):
        return (self.metrics or {}).get("config")
