"""Placement groups: gang-scheduling API.

ray parity: python/ray/util/placement_group.py:34 (PlacementGroup,
placement_group(), remove_placement_group, placement_group_table). Bundles
reserve resources on nodes via the GCS's 2-phase prepare/commit; STRICT_PACK
is the TPU-slice gang-scheduling primitive (all bundles on one host/slice).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import JobID, PlacementGroupID
from ray_tpu_torch._private.worker import global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, id_hex: str, bundles: List[Dict[str, float]]):
        self.id_hex = id_hex
        self.bundle_specs = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self) -> "PlacementGroupReadyRef":
        return PlacementGroupReadyRef(self)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        cw = global_worker.core_worker
        table = cw.io.run(
            cw.gcs.request(
                "wait_placement_group",
                {"pg_id": self.id_hex, "timeout": timeout_seconds},
            )
        )
        return bool(table and table["state"] == "CREATED")

    def __reduce__(self):
        return (PlacementGroup, (self.id_hex, self.bundle_specs))


class PlacementGroupReadyRef:
    """Awaitable/`get`-able readiness handle (stands in for pg.ready())."""

    def __init__(self, pg: PlacementGroup):
        self._pg = pg

    def get(self, timeout: Optional[float] = None):
        if not self._pg.wait(timeout or 30.0):
            raise TimeoutError(f"placement group {self._pg.id_hex} not ready")
        return self._pg


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    global_worker.check_connected()
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy}; must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle: {b}")
    cw = global_worker.core_worker
    pg_id = PlacementGroupID.of(JobID(cw.job_id)).hex()
    cw.io.run(
        cw.gcs.request(
            "create_placement_group",
            {
                "pg_id": pg_id,
                "bundles": [dict(b) for b in bundles],
                "strategy": strategy,
                "name": name,
                "job_id": cw.job_id,
                "lifetime": lifetime,
            },
        )
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup):
    global_worker.check_connected()
    cw = global_worker.core_worker
    cw.io.run(cw.gcs.request("remove_placement_group", {"pg_id": pg.id_hex}))


def placement_group_table(pg: Optional[PlacementGroup] = None):
    global_worker.check_connected()
    cw = global_worker.core_worker
    return cw.io.run(
        cw.gcs.request("pg_table", {"pg_id": pg.id_hex if pg else None})
    )
