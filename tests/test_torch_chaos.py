"""The port's counterpart of ``tests/test_chaos.py`` (2 cases),
through ``ray_tpu_torch`` with the reference's expected values: every case
is carried under its own name.

The reference's description:

Node-death chaos: kill a raylet mid-workload, the job survives.

Reference parity: ray python/ray/tests/test_chaos.py + NodeKillerActor
(_private/test_utils.py:1400 kills raylets, graceful or not) — here the
Cluster fixture's remove_node(graceful=False) is the killer.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.rpcio import RpcError
from ray_tpu_torch._private.worker import (ActorDiedError, GetTimeoutError,
                                     WorkerDiedError)

from tests.torch_fixtures import port_cluster  # noqa: F401

# Errors a caller may legitimately see while the cluster heals: transport
# loss/deadline (RpcError covers ConnectionLost + RpcTimeoutError), the
# actor's death/restart window, get() deadlines, and the worker's generic
# task-failure surface (RuntimeError — "task submission failed: ...",
# which ActorDiedError/WorkerDiedError also subclass). Anything else — an
# AssertionError, a TypeError in the test body — must propagate instead of
# being swallowed by the retry loop.
TRANSIENT_CHAOS_ERRORS = (RpcError, GetTimeoutError, ActorDiedError,
                          WorkerDiedError, TimeoutError, RuntimeError)


@ray_tpu_torch.remote(max_retries=4)
def slow_echo(x, delay=0.2):
    time.sleep(delay)
    return x


@pytest.mark.chaos
def test_node_death_tasks_retry_elsewhere(port_cluster):
    """Tasks in flight on a killed node are retried on survivors."""
    cluster = port_cluster
    cluster.add_node(num_cpus=2)  # head
    node_b = cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    refs = [slow_echo.options(scheduling_strategy="SPREAD").remote(i)
            for i in range(16)]
    time.sleep(0.4)  # let some tasks land on node B
    cluster.remove_node(node_b, graceful=False)
    got = ray_tpu_torch.get(refs, timeout=120)
    assert got == list(range(16))


@pytest.mark.chaos
def test_node_death_actor_restarts_elsewhere(port_cluster):
    """A restartable actor on a killed node comes back on another node and
    serves calls again (max_restarts + max_task_retries)."""
    cluster = port_cluster
    cluster.add_node(num_cpus=2)  # head: no "spot" resource
    node_b = cluster.add_node(num_cpus=2, resources={"spot": 1.0})
    node_c = cluster.add_node(num_cpus=2, resources={"spot": 1.0})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote(max_restarts=2, max_task_retries=4, num_cpus=1,
                    resources={"spot": 1})
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

        def where(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    c = Counter.remote()
    assert ray_tpu_torch.get(c.bump.remote(), timeout=60) == 1
    home = ray_tpu_torch.get(c.where.remote(), timeout=60)
    victim = node_b if home == node_b.node_id else node_c
    assert home == victim.node_id
    cluster.remove_node(victim, graceful=False)

    # calls retry while the GCS restarts the actor on the surviving
    # spot-capable node; state is fresh (restart, not migration)
    deadline = time.monotonic() + 90
    value = None
    while time.monotonic() < deadline:
        try:
            value = ray_tpu_torch.get(c.bump.remote(), timeout=30)
            break
        except TRANSIENT_CHAOS_ERRORS:
            time.sleep(1.0)
    assert value is not None and value >= 1, value
    new_home = ray_tpu_torch.get(c.where.remote(), timeout=30)
    assert new_home != victim.node_id
