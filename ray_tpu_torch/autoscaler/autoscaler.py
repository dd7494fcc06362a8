"""StandardAutoscaler: bin-pack pending demand onto node types.

ray parity: autoscaler/_private/autoscaler.py:166 StandardAutoscaler +
resource_demand_scheduler.py:101 (bin-packing of task/actor/PG demand
onto available_node_types) + load_metrics.py. One `update()` is one
reconciliation: read load from the GCS, launch nodes for unmet demand
(respecting per-type max_workers and min_workers floors), and terminate
nodes idle longer than idle_timeout_s.

Config shape (the available_node_types subset of ray's cluster YAML):

    {
      "gpu_node": {"resources": {"GPU": 8, "CPU": 96},
                     "min_workers": 0, "max_workers": 4},
      ...
    }

Group types add ``"hosts": N``: one launched unit is a WHOLE group of
N hosts, each advertising ``resources`` (scale-up granularity is the
group — a Queued-Resources API provisions no half group). Bundles
bin-pack per HOST: a {"GPU": 8} bundle fits one host of a 2 x 8-card
group, but {"GPU": 16} fits no single host and is infeasible on that
type even though the group's aggregate is 16.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


def _fits(bundle: Dict[str, float], capacity: Dict[str, float]) -> bool:
    return all(capacity.get(k, 0.0) >= v for k, v in bundle.items())


def _consume(bundle: Dict[str, float], capacity: Dict[str, float]):
    for k, v in bundle.items():
        capacity[k] = capacity.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(
        self,
        provider,
        node_types: Dict[str, dict],
        *,
        gcs_address: Optional[str] = None,
        idle_timeout_s: float = 60.0,
        node_boot_grace_s: float = 120.0,
    ):
        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        # How long a launched node's config capacity counts toward demand
        # before it must have registered a raylet (prevents both relaunch
        # storms while booting AND permanent phantom capacity from nodes
        # the provider cannot correlate to raylets).
        self.node_boot_grace_s = node_boot_grace_s
        self._gcs_address = gcs_address
        self._launch_times: Dict[str, float] = {}
        self._io = None
        self._conn = None

    # -- load source ---------------------------------------------------
    def _load_metrics(self) -> dict:
        if self._gcs_address is None:
            return {"nodes": [], "pending_demand": []}
        from ray_tpu_torch._private.rpcio import EventLoopThread, connect

        if self._io is None:
            self._io = EventLoopThread("autoscaler-io")
        if self._conn is None or self._conn.closed:
            host, port = self._gcs_address.rsplit(":", 1)
            self._conn = self._io.run(connect(host, int(port)))
        return self._io.run(self._conn.request("get_load_metrics", {}))

    # -- reconciliation ------------------------------------------------
    def update(self, load: Optional[dict] = None) -> dict:
        """One reconciliation pass; returns {"launched": {type: n},
        "terminated": [ids]} for observability/tests."""
        load = load if load is not None else self._load_metrics()
        running = self.provider.non_terminated_nodes()  # id -> type
        counts: Dict[str, int] = {}
        for t in running.values():
            counts[t] = counts.get(t, 0) + 1

        launched: Dict[str, int] = {}
        now = time.monotonic()
        # Provider nodes we did not launch this process-lifetime (restart,
        # min-floor races) must not default to age 0 forever: stamp unseen
        # ids ONCE at first sight so their grace window actually elapses.
        for nid in running:
            self._launch_times.setdefault(nid, now)
        # min_workers floors first.
        for node_type, spec in self.node_types.items():
            floor = spec.get("min_workers", 0)
            have = counts.get(node_type, 0)
            if have < floor:
                n = floor - have
                for new_id in self.provider.create_node(node_type, n):
                    self._launch_times[new_id] = now
                counts[node_type] = floor
                launched[node_type] = launched.get(node_type, 0) + n

        # Unmet demand: subtract what live nodes can still absorb, then
        # bin-pack the remainder onto node types (first-fit by type order).
        free: List[Dict[str, float]] = [
            dict(n["resources_available"]) for n in load.get("nodes", [])
        ]
        # Capacity of launched-but-not-yet-registered nodes counts too
        # (else every update re-launches for the same demand) — but only
        # within the boot grace window, so unmatched nodes don't become
        # permanent phantom capacity.
        for nid, t in running.items():
            if t not in self.node_types:
                continue
            spec = self.node_types[t]
            expected = int(spec.get("hosts", 1))
            matched = len(self._find_load_nodes(nid, load))
            age = now - self._launch_times.get(nid, now)
            if matched < expected and age <= self.node_boot_grace_s:
                # multi-host groups boot staggered: count bins only for
                # the hosts still missing, or one early-registering host
                # would erase its siblings' capacity and trigger a
                # duplicate (billed!) group launch
                for _ in range(expected - matched):
                    free.append(dict(spec.get("resources", {})))

        # First-fit each bundle onto existing/just-launched capacity;
        # launch a new node only when nothing absorbs it. Demand arrives
        # aggregated by shape with counts.
        for shaped in load.get("pending_demand", []):
            bundle0 = shaped.get("bundle", shaped)
            count = int(shaped.get("count", 1)) if isinstance(shaped, dict) \
                and "bundle" in shaped else 1
            for _ in range(min(count, 1000)):
                bundle = dict(bundle0)
                placed = False
                for cap in free:
                    if _fits(bundle, cap):
                        _consume(bundle, cap)
                        placed = True
                        break
                if placed:
                    continue
                chosen = None
                for node_type, spec in self.node_types.items():
                    if counts.get(node_type, 0) >= spec.get("max_workers", 2**31):
                        continue
                    if _fits(bundle, dict(spec.get("resources", {}))):
                        chosen = node_type
                        break
                if chosen is None:
                    logger.warning(
                        "demand %s fits no launchable node type", bundle
                    )
                    break  # same shape won't fit on later iterations either
                for new_id in self.provider.create_node(chosen, 1):
                    self._launch_times[new_id] = now
                counts[chosen] = counts.get(chosen, 0) + 1
                launched[chosen] = launched.get(chosen, 0) + 1
                # The new unit absorbs this and possibly later bundles.
                # A group type contributes one capacity bin PER HOST.
                spec = self.node_types[chosen]
                hosts = [dict(spec.get("resources", {}))
                         for _ in range(int(spec.get("hosts", 1)))]
                _consume(bundle, hosts[0])
                free.extend(hosts)

        # Scale down: provider nodes whose raylet has been idle past the
        # timeout, never below min_workers. Requires the provider to
        # correlate its nodes to raylets (raylet_node_id); providers that
        # can't are never scaled down from here.
        terminated: List[str] = []
        for nid, node_type in list(running.items()):
            spec = self.node_types.get(node_type, {})
            if counts.get(node_type, 0) <= spec.get("min_workers", 0):
                continue
            nodes = self._find_load_nodes(nid, load)
            # a multi-host group terminates whole: only when every
            # EXPECTED host has registered AND been idle past the timeout
            # (a partially-booted group's early host idling while its
            # gang peers provision must not kill the group mid-boot)
            if nodes and len(nodes) >= int(spec.get("hosts", 1)) and all(
                n.get("idle_s", 0.0) > self.idle_timeout_s for n in nodes
            ):
                self.provider.terminate_node(nid)
                self._launch_times.pop(nid, None)
                counts[node_type] -= 1
                terminated.append(nid)
        return {"launched": launched, "terminated": terminated}

    def _registered(self, provider_id: str, load: dict) -> bool:
        return bool(self._find_load_nodes(provider_id, load))

    def _find_load_nodes(self, provider_id: str, load: dict) -> List[dict]:
        """Match a provider unit to its registered raylet(s). Providers
        implementing ``raylet_node_ids`` (groups) or ``raylet_node_id``
        match exactly; others return [] — such nodes count as booting
        only within the grace window and are never auto-terminated."""
        many = getattr(self.provider, "raylet_node_ids", None)
        if many is not None:
            ids = [i for i in (many(provider_id) or []) if i]
        else:
            one = getattr(self.provider, "raylet_node_id",
                          lambda _: None)(provider_id)
            ids = [one] if one else []
        by_id = {n["node_id"]: n for n in load.get("nodes", [])}
        return [by_id[i] for i in ids if i in by_id]

    def run_loop(self, interval_s: float = 5.0, stop_event=None):
        """Monitor loop (ray: monitor.py Monitor)."""
        while stop_event is None or not stop_event.is_set():
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")
            time.sleep(interval_s)
