"""Scheduling strategy objects (ray parity: python/ray/util/scheduling_strategies.py:15,41,135)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: Optional[bool] = None,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = bool(
            placement_group_capture_child_tasks
        )


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    """Match nodes by label (used for TPU slice targeting)."""

    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}
