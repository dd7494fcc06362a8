"""Multi-node-on-one-host test cluster.

ray parity: python/ray/cluster_utils.py:99 Cluster — N raylets (separate
processes, separate shm stores) sharing one GCS, so scheduling/spillback/
fault-tolerance tests exercise real multi-node semantics on one machine
(ray: cluster_utils.py add_node:165, remove_node:238).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ray_tpu_torch._private.node import NodeProcesses


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.head: Optional[NodeProcesses] = None
        self.workers: list = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        return self.head.address

    def add_node(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> NodeProcesses:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        if self.head is None:
            self.head = NodeProcesses(head=True, resources=res or None, labels=labels)
            return self.head
        node = NodeProcesses(
            head=False,
            gcs_port=self.head.gcs_port,
            session_dir=self.head.session_dir,
            resources=res or None,
            labels=labels,
        )
        self.workers.append(node)
        return node

    def remove_node(self, node: NodeProcesses, graceful: bool = False):
        node.kill_raylet(graceful=graceful)
        if node in self.workers:
            self.workers.remove(node)

    def wait_for_nodes(self, timeout: float = 30.0):
        from ray_tpu_torch._private.rpcio import EventLoopThread, connect

        expected = 1 + len(self.workers)
        io = EventLoopThread("cluster-wait")
        try:
            conn = io.run(connect("127.0.0.1", self.head.gcs_port))
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                nodes = io.run(conn.request("get_nodes", {}))
                if sum(1 for n in nodes if n["alive"]) >= expected:
                    io.run(conn.close())
                    return
                time.sleep(0.1)
            raise TimeoutError(f"cluster did not reach {expected} nodes")
        finally:
            io.stop()

    def shutdown(self):
        for w in self.workers:
            w.shutdown()
        if self.head is not None:
            self.head.shutdown()
        self.workers = []
        self.head = None
