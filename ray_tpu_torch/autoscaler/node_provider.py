"""Node providers: the cloud-side of the autoscaler.

ray parity: python/ray/autoscaler/node_provider.py:13 NodeProvider
(create_node/terminate_node/non_terminated_nodes) + the fake local
provider (autoscaler/_private/fake_multi_node/node_provider.py:237) that
backs autoscaler tests without a cloud.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional


class NodeProvider:
    """Minimal provider contract. ``node_type`` names an entry of the
    cluster config's available_node_types."""

    def create_node(self, node_type: str, count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> Dict[str, str]:
        """node_id -> node_type."""
        raise NotImplementedError


class MockProvider(NodeProvider):
    """In-memory provider for unit tests (ray: autoscaler_test_utils
    MockProvider)."""

    def __init__(self):
        self._nodes: Dict[str, str] = {}
        self.create_calls: List[tuple] = []
        self.terminate_calls: List[str] = []

    def create_node(self, node_type: str, count: int) -> List[str]:
        self.create_calls.append((node_type, count))
        out = []
        for _ in range(count):
            nid = f"mock-{uuid.uuid4().hex[:8]}"
            self._nodes[nid] = node_type
            out.append(nid)
        return out

    def terminate_node(self, node_id: str) -> None:
        self.terminate_calls.append(node_id)
        self._nodes.pop(node_id, None)

    def non_terminated_nodes(self) -> Dict[str, str]:
        return dict(self._nodes)


class FakeGpuNodeProvider(NodeProvider):
    """Launches real local raylet processes advertising a GPU node type's
    resources — autoscaler end-to-end without a cloud API (on a host with
    cards, the launched node's workers use them).

    Each created node is a NodeProcesses worker joining the given GCS,
    with the node type's resources (e.g. {"GPU": 8, "CPU": 96} for an
    8-card H100 host) and a gpu-group label carrying the type name.
    """

    def __init__(self, gcs_host: str, gcs_port: int, session_dir: str,
                 node_types: Dict[str, dict]):
        self.gcs_host = gcs_host
        self.gcs_port = gcs_port
        self.session_dir = session_dir
        self.node_types = node_types
        self._nodes: Dict[str, tuple] = {}  # provider_id -> (type, NodeProcesses)
        self._lock = threading.Lock()

    def create_node(self, node_type: str, count: int) -> List[str]:
        from ray_tpu_torch._private.node import NodeProcesses

        spec = self.node_types[node_type]
        out = []
        for _ in range(count):
            node = NodeProcesses(
                head=False,
                gcs_host=self.gcs_host,
                gcs_port=self.gcs_port,
                session_dir=self.session_dir,
                resources=dict(spec.get("resources", {})),
                labels={"gpu-group": node_type},
            )
            pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
            with self._lock:
                self._nodes[pid] = (node_type, node)
            out.append(pid)
        return out

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            entry = self._nodes.pop(node_id, None)
        if entry is not None:
            entry[1].shutdown()

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            return {nid: t for nid, (t, _) in self._nodes.items()}

    def raylet_node_id(self, provider_id: str) -> Optional[str]:
        entry = self._nodes.get(provider_id)
        return entry[1].node_id if entry else None

    def shutdown(self):
        for nid in list(self._nodes):
            self.terminate_node(nid)


# ---------------------------------------------------------------------------
# GPU-group provider: group-granular provisioning over a Queued-Resources API
# ---------------------------------------------------------------------------

class QueuedResourceAPI:
    """Contract for a Queued-Resources control plane (the GCP
    ``queuedResources`` surface): one request provisions a WHOLE group of
    hosts (accelerator_type + topology) that come up together and are
    deleted together, as a multi-host GPU unit joined by one fabric is.

    ray parity: python/ray/autoscaler/batching_node_provider.py — the
    provider batches by group because the API has no smaller granularity.
    """

    def create(self, name: str, accelerator_type: str, topology: str,
               num_hosts: int) -> str:
        """Submit a provisioning request; returns a request id."""
        raise NotImplementedError

    def status(self, request_id: str) -> dict:
        """{"state": "PROVISIONING"|"ACTIVE"|"FAILED", "hosts": [...]}
        where hosts are opaque per-host handles once ACTIVE."""
        raise NotImplementedError

    def delete(self, request_id: str) -> None:
        raise NotImplementedError


class FakeQueuedResourceAPI(QueuedResourceAPI):
    """Backs GpuGroupProvider without a cloud: 'provisioning' a group
    launches one local raylet per host advertising that host's GPU
    resources, so autoscaler + placement tests run the real multi-host
    join path (analog of ray's fake_multi_node provider)."""

    def __init__(self, gcs_host: str, gcs_port: int, session_dir: str,
                 resources_per_host: Optional[Dict[str, dict]] = None):
        self.gcs_host = gcs_host
        self.gcs_port = gcs_port
        self.session_dir = session_dir
        # accelerator_type -> per-host resources override
        self.resources_per_host = resources_per_host or {}
        self._requests: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def create(self, name, accelerator_type, topology, num_hosts):
        from ray_tpu_torch._private.node import NodeProcesses

        rid = f"qr-{uuid.uuid4().hex[:8]}"
        res = dict(self.resources_per_host.get(
            accelerator_type, {"GPU": 8.0, "CPU": 8.0}
        ))
        hosts = []
        for i in range(num_hosts):
            node = NodeProcesses(
                head=False,
                gcs_host=self.gcs_host,
                gcs_port=self.gcs_port,
                session_dir=self.session_dir,
                resources=res,
                labels={
                    "gpu-group": name,
                    "gpu-accelerator": accelerator_type,
                    "gpu-topology": topology,
                    "gpu-worker-index": str(i),
                },
            )
            hosts.append(node)
        with self._lock:
            self._requests[rid] = {"state": "ACTIVE", "hosts": hosts,
                                   "name": name}
        return rid

    def status(self, request_id):
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                return {"state": "FAILED", "hosts": []}
            return {"state": req["state"], "hosts": list(req["hosts"])}

    def delete(self, request_id):
        with self._lock:
            req = self._requests.pop(request_id, None)
        for node in (req or {}).get("hosts", []):
            try:
                node.shutdown()
            except Exception:
                pass


class GkeQueuedResourceAPI(QueuedResourceAPI):
    """The reference's Queued-Resources REST surface
    (``https://tpu.googleapis.com/v2/.../queuedResources``), its request
    shapes kept as they are: the one queued provisioning API the
    reference speaks. Without a ``token_provider`` a call raises a clear
    error before any request; with network egress and
    application-default credentials it provisions groups."""

    def __init__(self, project: str, zone: str, runtime_version: str =
                 "tpu-ubuntu2204-base", token_provider=None):
        self.project = project
        self.zone = zone
        self.runtime_version = runtime_version
        self.token_provider = token_provider
        self.base = (f"https://tpu.googleapis.com/v2/projects/{project}"
                     f"/locations/{zone}/queuedResources")

    def _call(self, method: str, url: str, body: Optional[dict] = None):
        import json as _json
        import urllib.request

        if self.token_provider is None:
            raise RuntimeError(
                "GkeQueuedResourceAPI needs a token_provider (e.g. "
                "google.auth default credentials) and network egress; "
                "use FakeQueuedResourceAPI for offline clusters"
            )
        req = urllib.request.Request(
            url, method=method,
            data=_json.dumps(body).encode() if body is not None else None,
            headers={"Authorization": f"Bearer {self.token_provider()}",
                     "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return _json.loads(resp.read() or b"{}")

    _ACCEL_GEN = {"v5litepod": "V5LITE_POD", "v5p": "V5P", "v4": "V4",
                  "v6e": "V6E", "v3": "V3", "v2": "V2"}

    def create(self, name, accelerator_type, topology, num_hosts):
        # acceleratorType and acceleratorConfig are mutually exclusive in
        # the v2 API; a topology request must go through acceleratorConfig
        # (with its required generation enum), otherwise name the type.
        node = {"runtimeVersion": self.runtime_version}
        gen = self._ACCEL_GEN.get(accelerator_type.split("-")[0])
        if topology and gen:
            node["acceleratorConfig"] = {"type": gen, "topology": topology}
        else:
            node["acceleratorType"] = accelerator_type
        body = {
            "tpu": {"nodeSpec": [{
                "parent": f"projects/{self.project}/locations/{self.zone}",
                "nodeId": name,
                "node": node,
            }]},
        }
        self._call("POST", f"{self.base}?queuedResourceId={name}", body)
        return name

    def status(self, request_id):
        out = self._call("GET", f"{self.base}/{request_id}")
        state = (out.get("state") or {}).get("state", "PROVISIONING")
        mapped = {"ACTIVE": "ACTIVE", "FAILED": "FAILED",
                  "SUSPENDED": "FAILED"}.get(state, "PROVISIONING")
        return {"state": mapped, "hosts": out.get("tpu", {}).get(
            "nodeSpec", [])}

    def delete(self, request_id):
        self._call("DELETE", f"{self.base}/{request_id}")


class GpuGroupProvider(NodeProvider):
    """Group-granular GPU provider: one provider node == one WHOLE group
    of hosts provisioned through a Queued-Resources API. ``node_types``
    entries describe groups:

        {"h100_x2": {"accelerator_type": "h100-16", "topology": "2x8",
                     "hosts": 2,
                     "resources": {"GPU": 8.0, "CPU": 96.0},  # per host
                     "min_workers": 0, "max_workers": 2}}

    Pair with StandardAutoscaler (which bin-packs per host but launches
    per group) and any QueuedResourceAPI implementation.
    """

    def __init__(self, api: QueuedResourceAPI, node_types: Dict[str, dict],
                 status_ttl_s: float = 2.0):
        self.api = api
        self.node_types = node_types
        self._groups: Dict[str, dict] = {}  # provider id -> {type, request}
        # status cache: one autoscaler update() touches each group up to
        # 3 times (non_terminated_nodes, registration check, scale-down);
        # against a real REST API each uncached call is a blocking GET
        self._status_ttl_s = status_ttl_s
        self._status_cache: Dict[str, tuple] = {}  # id -> (ts, status)
        self._lock = threading.Lock()

    def _status(self, provider_id: str, request_id: str) -> dict:
        import time as _time

        now = _time.monotonic()
        with self._lock:
            hit = self._status_cache.get(provider_id)
            if hit is not None and now - hit[0] <= self._status_ttl_s:
                return hit[1]
        st = self.api.status(request_id)
        with self._lock:
            self._status_cache[provider_id] = (now, st)
        return st

    def create_node(self, node_type: str, count: int) -> List[str]:
        spec = self.node_types[node_type]
        out = []
        for _ in range(count):
            name = f"{node_type}-{uuid.uuid4().hex[:6]}"
            rid = self.api.create(
                name,
                spec.get("accelerator_type", node_type),
                spec.get("topology", ""),
                int(spec.get("hosts", 1)),
            )
            with self._lock:
                self._groups[name] = {"type": node_type, "request": rid}
            out.append(name)
        return out

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            entry = self._groups.pop(node_id, None)
            self._status_cache.pop(node_id, None)
        if entry is not None:
            self.api.delete(entry["request"])

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            entries = dict(self._groups)
        out = {}
        for name, entry in entries.items():
            st = self._status(name, entry["request"])
            if st["state"] == "FAILED":
                with self._lock:
                    self._groups.pop(name, None)
                    self._status_cache.pop(name, None)
                continue
            out[name] = entry["type"]
        return out

    def raylet_node_ids(self, provider_id: str) -> List[str]:
        with self._lock:
            entry = self._groups.get(provider_id)
        if entry is None:
            return []
        st = self._status(provider_id, entry["request"])
        out = []
        for h in st.get("hosts", []):
            # FakeQueuedResourceAPI hosts are NodeProcesses objects; real
            # QR APIs return plain dicts
            nid = (h.get("node_id") if isinstance(h, dict)
                   else getattr(h, "node_id", None))
            out.append(nid)
        return out

    def shutdown(self):
        for nid in list(self._groups):
            self.terminate_node(nid)
