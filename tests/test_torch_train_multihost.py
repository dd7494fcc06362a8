"""The port's Train across nodes: the cases of
``tests/test_train_multihost.py`` on two raylets of the port's ``Cluster``,
each advertising logical GPUs. ``TorchTrainer`` forms a gloo process group
over workers on both nodes: 2 workers ``SPREAD`` (one a node, a flat
data-parallel group), and 4 workers, 2 a node, over
``create_hybrid_mesh({"fsdp": 2}, {"data": 2})`` built from each rank's
node in the train context, whose dcn rows must each hold the ranks of one
node. Both train the reference's toy linear regression (the global batch
split over the ranks, the loss normalised by the global batch, gradients
summed over the group) and their losses are held against the reference's
``_single_process_reference`` (JAX, one process, the full batch) at its
``rtol=1e-4, atol=1e-5``. The loops are defined inside the tests, so they
travel to the port's workers by value.
"""

import numpy as np
import pytest

import ray_tpu_torch
from tests.test_train_multihost import _single_process_reference


@pytest.fixture
def two_nodes():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def _make_loop(hybrid):
    def loop(config):
        import numpy as np
        import torch
        import torch.distributed as dist

        import ray_tpu_torch as rt
        from ray_tpu_torch import parallel, train

        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        if hybrid:
            nodes = world // ctx.get_local_world_size()
            mesh = parallel.create_hybrid_mesh(
                {"fsdp": ctx.get_local_world_size()}, {"data": nodes})
            index, count = parallel.shard_index(mesh, ("data", "fsdp"))
            layout = mesh.mesh.tolist()
        else:
            index, count, layout = rank, world, None
        assert count == world
        n, d = 64, 8
        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
        y = X @ torch.arange(d, dtype=torch.float32)
        per = n // world
        Xs, ys = X[index * per:(index + 1) * per], y[index * per:
                                                     (index + 1) * per]
        w = torch.zeros(d, requires_grad=True)
        losses = []
        for _ in range(config["steps"]):
            # normalised by the GLOBAL batch: the summed gradient is the
            # full-batch mean's
            loss = ((Xs @ w - ys) ** 2).sum() / n
            (g,) = torch.autograd.grad(loss, w)
            part = torch.stack([loss.detach(), *g])
            dist.all_reduce(part)
            with torch.no_grad():
                w -= 0.1 * part[1:]
            losses.append(float(part[0]))
        nodes_of = [None] * world
        dist.all_gather_object(nodes_of,
                               rt.get_runtime_context().get_node_id())
        train.report({"losses": losses, "final_loss": losses[-1],
                      "world": world, "layout": layout,
                      "nodes_of": nodes_of})
    return loop


def _fit(cluster, workers, gpus_per_node, hybrid):
    cluster.add_node(num_cpus=2, resources={"GPU": float(gpus_per_node)})
    cluster.add_node(num_cpus=2, resources={"GPU": float(gpus_per_node)})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(address=cluster.address)
    from ray_tpu_torch import train

    steps = 10
    trainer = train.TorchTrainer(
        _make_loop(hybrid), train_loop_config={"steps": steps},
        torch_config=train.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(
            num_workers=workers, use_gpu=False,
            resources_per_worker={"CPU": 0.5, "GPU": 1.0},
            placement_strategy="SPREAD"),
    )
    result = trainer.fit()
    assert result.error is None, f"multi-node training failed: {result.error}"
    m = result.metrics
    assert m["world"] == workers
    assert len(set(m["nodes_of"])) == 2  # the gang spans both nodes
    ref = _single_process_reference(steps)
    np.testing.assert_allclose(m["losses"], ref, rtol=1e-4, atol=1e-5)
    return m, ref


def test_two_process_hybrid_mesh(two_nodes):
    """DP over the dcn axis + FSDP within a node over 4 workers on 2
    raylets; the loss trajectory matches the single-process full batch, and
    each dcn row of the mesh holds the ranks of one node."""
    m, _ = _fit(two_nodes, 4, 2, hybrid=True)
    layout = np.asarray(m["layout"])
    assert layout.shape == (2, 2)
    for row in layout:
        assert len({m["nodes_of"][r] for r in row}) == 1, (layout,
                                                           m["nodes_of"])
    assert {m["nodes_of"][r] for r in layout[0]} != \
        {m["nodes_of"][r] for r in layout[1]}


def test_two_raylet_distributed_mesh(two_nodes):
    m, ref = _fit(two_nodes, 2, 1, hybrid=False)
    # it learned something across the two processes
    assert m["final_loss"] < ref[0] * 0.1
