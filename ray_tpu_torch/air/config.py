"""AIR configs (ray parity: python/ray/air/config.py:93,526,577,707).

ScalingConfig's device: one CUDA card per worker, the reference's model.
``use_gpu=True`` (the default: the port's entry points run on the card
unless the caller asks for the CPU) leases ``{"GPU": 1}`` for each worker;
``use_gpu=False`` runs the gang on CPUs (gloo). The TPU fields
(``use_tpu``, ``chips_per_worker``, ``topology``) are not fields here, so
passing one raises ``TypeError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True  # one CUDA card per worker
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    trainer_resources: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    def as_placement_group_bundles(self) -> List[Dict[str, float]]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False
    callbacks: Optional[list] = None
