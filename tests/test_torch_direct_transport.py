"""The port's counterpart of ``tests/test_direct_transport.py`` (3 cases),
through ``ray_tpu_torch`` on the port's own clusters
(``tests/torch_fixtures.py``) with the reference's expected values: every
case is carried under its own name.

The reference's description:

Direct task push over worker leases (ray parity:
src/ray/core_worker/transport/direct_task_transport.cc).
"""

import time

import ray_tpu_torch

from tests.torch_fixtures import port_regular_fn, port_cluster  # noqa: F401


def _stats(port):
    from ray_tpu_torch._private.rpcio import EventLoopThread, connect

    io = EventLoopThread("probe")
    try:
        c = io.run(connect("127.0.0.1", port, retries=2))
        st = io.run(c.request("node_stats", {}))
        io.run(c.close())
        return st
    finally:
        io.stop()


def test_lease_lifecycle_and_resource_return(port_regular_fn):
    """A task burst leases workers (reserving CPUs); after the linger
    expires the leases return — resources and idle workers come back."""
    from ray_tpu_torch._private.worker import global_worker

    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get([f.remote(i) for i in range(40)], timeout=60) == [
        i * 2 for i in range(40)
    ]
    port = global_worker.node.raylet_port

    # linger (0.5s default) holds the lease briefly, then it returns
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = _stats(port)
        avail = st["resources_available"].get("CPU", 0)
        total = st["resources_total"].get("CPU", 0)
        if avail == total and st["num_idle_workers"] >= 1:
            break
        time.sleep(0.5)
    else:
        raise AssertionError(f"leases never returned: {st}")


def test_direct_falls_back_for_special_strategies(port_regular_fn):
    """SPREAD / affinity / PG strategies stay raylet-routed (placement
    decisions are the raylet's), while DEFAULT tasks push direct —
    results must be identical either way."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    @ray_tpu_torch.remote
    def whoami():
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    me = ray_tpu_torch.get(whoami.remote(), timeout=60)  # direct path
    pinned = ray_tpu_torch.get(
        whoami.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=me, soft=False
            )
        ).remote(),
        timeout=60,
    )  # raylet path
    spread = ray_tpu_torch.get(
        whoami.options(scheduling_strategy="SPREAD").remote(), timeout=60
    )
    assert me == pinned == spread


def test_direct_disabled_flag(port_cluster, monkeypatch):
    """RAY_TPU_TORCH_direct_task_leases=0 forces the legacy raylet path for
    everything — the compatibility escape hatch must keep working."""
    monkeypatch.setenv("RAY_TPU_TORCH_direct_task_leases", "0")
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster.address)

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get([f.remote(i) for i in range(10)], timeout=60) == [
        i + 1 for i in range(10)
    ]
