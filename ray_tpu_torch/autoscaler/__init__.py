"""Autoscaler: demand-driven node launch/teardown.

ray parity: python/ray/autoscaler/_private/{autoscaler.py:166
StandardAutoscaler, resource_demand_scheduler.py:101, load_metrics.py:63,
monitor.py:126} with pluggable NodeProvider (node_provider.py:13). Node
types advertise ``"GPU"``; a group type is a whole group of hosts (the
scaling granularity a Queued-Resources API provisions), and the included
FakeGpuNodeProvider launches local raylet processes advertising a node
type's resources so autoscaler end-to-end runs without cloud APIs (analog
of fake_multi_node/node_provider.py:237).
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    FakeGpuNodeProvider,
    FakeQueuedResourceAPI,
    GkeQueuedResourceAPI,
    GpuGroupProvider,
    MockProvider,
    NodeProvider,
    QueuedResourceAPI,
)

__all__ = [
    "StandardAutoscaler",
    "NodeProvider",
    "MockProvider",
    "FakeGpuNodeProvider",
    "QueuedResourceAPI",
    "FakeQueuedResourceAPI",
    "GkeQueuedResourceAPI",
    "GpuGroupProvider",
]
