"""The port's autoscaler (``ray_tpu_torch.autoscaler``): the cases of
``tests/test_autoscaler.py``. The unit cases run the port's
``StandardAutoscaler`` and the reference's on the same loads, the port's
node types advertising ``"GPU"`` where the reference's advertise ``"TPU"``,
and hold the port's launches and terminations to the reference's. The
end-to-end cases start the port's own cluster: ``FakeGpuNodeProvider``
launches a raylet of a GPU node type for an infeasible task and tears it
down idle; ``GpuGroupProvider`` over ``FakeQueuedResourceAPI`` launches one
whole group of 4 hosts for a pending placement group, one bundle a host.
"""

import copy
import time

import pytest

import ray_tpu_torch
from ray_tpu.autoscaler import MockProvider as RefMockProvider
from ray_tpu.autoscaler import StandardAutoscaler as RefAutoscaler
from ray_tpu.autoscaler import TpuPodProvider
from ray_tpu_torch.autoscaler import (FakeGpuNodeProvider, GpuGroupProvider,
                                      MockProvider, StandardAutoscaler)

NODE_TYPES = {
    "gpu_8": {"resources": {"GPU": 8.0, "CPU": 8.0},
              "min_workers": 0, "max_workers": 2},
    "cpu_worker": {"resources": {"CPU": 4.0},
                   "min_workers": 0, "max_workers": 3},
}

GROUP_TYPES = {
    # one unit = a group of 4 hosts x {GPU: 4, CPU: 8}
    "gpu_group_16": {"accelerator_type": "h100-16", "topology": "4x4",
                     "hosts": 4, "resources": {"GPU": 4.0, "CPU": 8.0},
                     "min_workers": 0, "max_workers": 2},
}


def _as_tpu(obj):
    """``obj`` with every "GPU" key named "TPU": the reference's form of a
    node-type table or a load."""
    if isinstance(obj, dict):
        return {("TPU" if k == "GPU" else k): _as_tpu(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_tpu(v) for v in obj]
    return obj


def _both(node_types, loads, provider=None, ref_provider=None):
    """The port's and the reference's ``update`` outputs, load by load,
    and the two providers; the reference sees the loads in its names."""
    port = StandardAutoscaler(provider or MockProvider(),
                              copy.deepcopy(node_types))
    ref = RefAutoscaler(ref_provider or RefMockProvider(),
                        _as_tpu(node_types))
    got = [port.update(load=copy.deepcopy(load)) for load in loads]
    want = [ref.update(load=_as_tpu(load)) for load in loads]
    for g, w in zip(got, want):
        assert g["launched"] == w["launched"]
        assert len(g["terminated"]) == len(w["terminated"])
    return got, port.provider, ref.provider


def test_scale_up_for_demand_unit():
    outs, provider, ref = _both(NODE_TYPES, [{
        "nodes": [],
        "pending_demand": [{"GPU": 4.0}, {"GPU": 4.0}, {"CPU": 2.0}],
    }])
    out = outs[0]
    assert out["launched"].get("gpu_8") == 1
    # the CPU bundle fit the node's CPUs; no cpu_worker needed
    assert "cpu_worker" not in out["launched"]
    assert len(provider.non_terminated_nodes()) == 1
    assert len(ref.non_terminated_nodes()) == 1


def test_max_workers_cap_and_min_workers_floor():
    types = {"gpu_8": {"resources": {"GPU": 8.0}, "min_workers": 1,
                       "max_workers": 2}}
    outs, provider, ref = _both(types, [
        {"nodes": [], "pending_demand": []},
        {"nodes": [], "pending_demand": [{"GPU": 8.0} for _ in range(5)]},
    ])
    assert outs[0]["launched"] == {"gpu_8": 1}  # min_workers floor
    # demand for 5 whole nodes: capped at max_workers=2 in all
    assert len(provider.non_terminated_nodes()) == 2
    assert len(ref.non_terminated_nodes()) == 2


def test_no_relaunch_for_pending_nodes():
    load = {"nodes": [], "pending_demand": [{"GPU": 8.0}]}
    # the launched node is still booting (absent from load["nodes"]): its
    # capacity must count, no relaunch
    _, provider, ref = _both(NODE_TYPES, [load, load])
    assert len(provider.non_terminated_nodes()) == 1
    assert len(ref.non_terminated_nodes()) == 1


class _RecordingQR:
    """QueuedResourceAPI double that records calls without provisioning."""

    def __init__(self):
        self.created = []
        self.deleted = []

    def create(self, name, accelerator_type, topology, num_hosts):
        self.created.append((name, accelerator_type, topology, num_hosts))
        return name

    def status(self, request_id):
        return {"state": "ACTIVE", "hosts": []}

    def delete(self, request_id):
        self.deleted.append(request_id)


def _group_run(demand):
    api, ref_api = _RecordingQR(), _RecordingQR()
    outs, _, _ = _both(
        GROUP_TYPES, [{"nodes": [], "pending_demand": demand}],
        provider=GpuGroupProvider(api, copy.deepcopy(GROUP_TYPES)),
        ref_provider=TpuPodProvider(ref_api, _as_tpu(GROUP_TYPES)))
    assert [c[1:] for c in api.created] == [c[1:] for c in ref_api.created]
    return outs[0], api


def test_group_granularity_unit():
    """Scale-up granularity is a whole group: 4 x {GPU: 4} bundles need
    exactly ONE group of 4 hosts, a 5th bundle tips to a second group, and
    a {GPU: 16} bundle fits no single host."""
    out, api = _group_run([{"bundle": {"GPU": 4.0}, "count": 4}])
    assert out["launched"] == {"gpu_group_16": 1}
    assert len(api.created) == 1
    name, acc, topo, hosts = api.created[0]
    assert (acc, topo, hosts) == ("h100-16", "4x4", 4)

    out, _ = _group_run([{"bundle": {"GPU": 4.0}, "count": 5}])
    assert out["launched"] == {"gpu_group_16": 2}

    out, _ = _group_run([{"GPU": 16.0}])
    assert out["launched"] == {}


@pytest.fixture
def port_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_autoscaler_e2e_fake_gpu_node(port_cluster):
    """Infeasible GPU task -> the autoscaler launches a raylet of the GPU
    node type -> the task runs there; the idle node is torn down after
    the timeout."""
    cluster = port_cluster
    cluster.add_node(num_cpus=2)  # head: no GPU
    ray_tpu_torch.init(address=cluster.address)

    provider = FakeGpuNodeProvider(
        "127.0.0.1", cluster.head.gcs_port, cluster.head.session_dir,
        NODE_TYPES,
    )
    scaler = StandardAutoscaler(
        provider, NODE_TYPES, gcs_address=cluster.address,
        idle_timeout_s=3.0,
    )
    try:
        @ray_tpu_torch.remote(num_gpus=8)
        def on_gpu():
            import ray_tpu_torch as rt

            return rt.get_runtime_context().get_node_id()

        ref = on_gpu.remote()
        deadline = time.monotonic() + 60
        launched = {}
        while time.monotonic() < deadline and not launched:
            time.sleep(1.0)
            launched = scaler.update()["launched"]
        assert launched.get("gpu_8") == 1
        gpu_node = ray_tpu_torch.get(ref, timeout=120)
        head_node = ray_tpu_torch.get_runtime_context().get_node_id()
        assert gpu_node != head_node
        labels = {n["node_id"]: n.get("labels", {})
                  for n in ray_tpu_torch.nodes()}
        assert labels[gpu_node].get("gpu-group") == "gpu_8"

        deadline = time.monotonic() + 90
        terminated = []
        while time.monotonic() < deadline and not terminated:
            time.sleep(1.5)
            terminated = scaler.update()["terminated"]
        assert terminated, "the idle GPU node was not scaled down"
        assert provider.non_terminated_nodes() == {}
    finally:
        provider.shutdown()


def test_autoscaler_e2e_gpu_group_pg(port_cluster):
    """Pending GPU placement-group demand launches ONE fake group of 4
    hosts (4 raylets join together) and the PG packs its bundles onto the
    group's hosts, one a host."""
    from ray_tpu_torch.autoscaler import FakeQueuedResourceAPI
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util.placement_group import placement_group

    cluster = port_cluster
    cluster.add_node(num_cpus=2)  # head: no GPU
    ray_tpu_torch.init(address=cluster.address)

    api = FakeQueuedResourceAPI(
        "127.0.0.1", cluster.head.gcs_port, cluster.head.session_dir,
        resources_per_host={"h100-16": {"GPU": 4.0, "CPU": 8.0}},
    )
    provider = GpuGroupProvider(api, GROUP_TYPES)
    scaler = StandardAutoscaler(
        provider, GROUP_TYPES, gcs_address=cluster.address,
        idle_timeout_s=3600.0,
    )
    try:
        pg = placement_group([{"GPU": 4.0}] * 4, strategy="PACK")

        deadline = time.monotonic() + 60
        launched = {}
        while time.monotonic() < deadline and not launched:
            time.sleep(1.0)
            launched = scaler.update()["launched"]
        assert launched.get("gpu_group_16") == 1, launched

        assert pg.wait(timeout_seconds=120), "PG not ready on the new group"

        table = state_api.list_placement_groups()
        mine = [t for t in table if t["placement_group_id"] == pg.id_hex]
        assert mine and mine[0]["state"] == "CREATED"
        bundle_nodes = mine[0]["bundle_nodes"]
        assert len(bundle_nodes) == 4
        labels = {n["node_id"]: n.get("labels", {})
                  for n in ray_tpu_torch.nodes()}
        groups = {labels[nid].get("gpu-group") for nid in bundle_nodes}
        assert len(groups) == 1 and None not in groups, groups
        assert len(set(bundle_nodes)) == 4  # one bundle per host

        # a PG-scheduled task runs on the group (num_cpus=0: the bundles
        # reserve only GPU)
        @ray_tpu_torch.remote(num_gpus=1, num_cpus=0)
        def where():
            import ray_tpu_torch as rt

            return rt.get_runtime_context().get_node_id()

        node = ray_tpu_torch.get(
            where.options(scheduling_strategy=None, placement_group=pg,
                          placement_group_bundle_index=0).remote(),
            timeout=180,
        )
        assert node in bundle_nodes
    finally:
        provider.shutdown()
