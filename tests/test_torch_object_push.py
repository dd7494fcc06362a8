"""The port's counterpart of ``tests/test_object_push.py`` (3 cases), through
``ray_tpu_torch`` on the port's own clusters (``tests/torch_fixtures.py``)
with the reference's expected values: every case is carried under its own
name.

The reference's description:

Object push / broadcast plane tests.

Analog of ray: push_manager tests (src/ray/object_manager/test/) and the
release broadcast benchmark shape — explicit pushes land copies on chosen
nodes, broadcast covers the cluster via tree fan-out, and duplicate
pushes dedup instead of re-sending.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.util.transfer import broadcast_object, push_object

from tests.torch_fixtures import port_cluster  # noqa: F401


def _locations(ref):
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    return set(cw.io.run(cw.gcs.request(
        "get_object_locations",
        {"object_id": ref.binary(), "wait": False},
    )) or [])


@pytest.fixture
def three_node_cluster(port_cluster):
    cluster = port_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=1)
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    yield cluster


def test_push_lands_copy(three_node_cluster):
    nodes = [n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]]
    assert len(nodes) == 3
    arr = np.random.default_rng(0).bytes(2 * 1024 * 1024)  # multi-chunk
    ref = ray_tpu_torch.put(arr)
    me = ray_tpu_torch.get_runtime_context().get_node_id()
    target = next(n for n in nodes if n != me)
    assert push_object(ref, [target]) == 1
    locs = _locations(ref)
    assert target in locs and me in locs


def test_push_dedup_and_repeat(three_node_cluster):
    nodes = [n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]]
    me = ray_tpu_torch.get_runtime_context().get_node_id()
    target = next(n for n in nodes if n != me)
    ref = ray_tpu_torch.put(b"y" * 300_000)
    # two pushes of the same object to the same peer: second is a no-op
    # ("have") — both succeed
    assert push_object(ref, [target]) == 1
    assert push_object(ref, [target]) == 1
    assert target in _locations(ref)


def test_broadcast_covers_cluster(three_node_cluster):
    nodes = {n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]}
    arr = np.arange(500_000, dtype=np.uint8)
    ref = ray_tpu_torch.put(arr.tobytes())
    n = broadcast_object(ref)
    assert n == 2  # two targets beyond the holder
    assert _locations(ref) == nodes
    # consumers on every node read the local copy (no pull needed);
    # the arg ref materializes from each node's own store
    @ray_tpu_torch.remote
    def consume(r):
        return len(r)

    sizes = ray_tpu_torch.get(
        [consume.options(resources={}).remote(ref) for _ in range(3)],
        timeout=60,
    )
    assert sizes == [500_000] * 3
