"""The port's counterpart of ``tests/test_node_agent.py`` (1 case),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

Per-node dashboard agent tests.

Analog of ray: dashboard/tests (each raylet spawns an agent process
serving node-local HTTP: stats, logs, worker stacks; its port registers
in the GCS KV).
"""

import time

import pytest
import requests

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401


def _agent_port():
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    deadline = time.time() + 30
    while time.time() < deadline:
        blob = cw.io.run(cw.gcs.request(
            "kv_get", {"ns": b"node_agents", "key": cw.node_id.encode()}
        ))
        if blob:
            return int(blob.decode())
        time.sleep(0.25)
    raise TimeoutError("agent never registered its port")


def test_agent_serves_node_local_surfaces(port_regular):
    # run something so there is a worker and a log
    @ray_tpu_torch.remote
    def hello():
        print("AGENT-LOG-LINE")
        return 1

    assert ray_tpu_torch.get(hello.remote(), timeout=60) == 1
    port = _agent_port()
    base = f"http://127.0.0.1:{port}/api/v0"

    stats = requests.get(f"{base}/node", timeout=30).json()
    assert "node_id" in stats or stats  # raylet's node_stats payload

    logs = requests.get(f"{base}/logs", timeout=30).json()
    names = [entry["file"] for entry in logs]
    assert any(n.startswith("worker-") for n in names)

    worker_log = next(n for n in names if n.startswith("worker-"))
    tail = requests.get(f"{base}/logs/tail",
                        params={"file": worker_log, "lines": 50},
                        timeout=30).json()
    assert "lines" in tail

    stacks = requests.get(f"{base}/stacks", timeout=30).json()
    assert "workers" in stacks

    # path traversal is rejected
    r = requests.get(f"{base}/logs/tail", params={"file": "../secret"},
                     timeout=30)
    assert r.status_code == 400
