"""The port's ``util.collective`` and meshes: the cases of
``tests/test_collective.py`` (analog of ray:
python/ray/util/collective/tests/) through ``ray_tpu_torch``.

- ``test_collective_store_backend`` is the reference's case as it stands.
- The reference's ``test_collective_xla_backend`` runs its default backend,
  "xla", on a ``jax.distributed`` gang. The port's default backend is
  "nccl": one ``torch.distributed`` call per op on the gang's process
  group. Here the group is gloo (the CPU box has no card; the card runs it
  in ``chip_smoke.py`` phase 36), the inputs and expected values are the
  reference's, and each result must equal the store backend's on the same
  inputs. Torch tensors reduce in place on that backend; the store backend
  returns numpy for a tensor input, as the reference's ``_to_numpy`` does
  for a ``jax.Array`` (``test_store_backend_returns_numpy_for_a_tensor``).
- ``test_mesh_and_ingraph_collectives`` and ``test_fsdp_param_sharding``
  run over torch's "fake" process group of 8 ranks (the reference's 8
  virtual CPU devices). ``compiled_allreduce``'s values are held against
  the reference's by ``tests/test_torch_parallel.py::
  test_collectives_match_jax`` at worlds 4 and 2 (real gloo
  ranks); a fake group moves no data, so here it is checked to build.
  FSDP2 shards whole modules on dim 0, so the port's "spec" is the
  placement of the big parameter's own unit, and the small parameter
  falls to the root unit instead of being replicated (the layout the
  reference's ``shard_params_fsdp`` docstring and the port's describe).
"""

import socket

import numpy as np
import pytest
import torch

import ray_tpu_torch

from tests.torch_fixtures import port_regular  # noqa: F401

pytestmark = pytest.mark.collective


@ray_tpu_torch.remote
class CollectiveWorker:
    def _rt_init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend, group_name)
        return rank

    def do_allreduce(self, value, group_name):
        from ray_tpu_torch.util import collective as col

        arr = np.full((4,), float(value))
        out = col.allreduce(arr, group_name)
        return out

    def do_allgather(self, value, group_name):
        from ray_tpu_torch.util import collective as col

        return col.allgather(np.full((2,), float(value)), group_name)

    def do_broadcast(self, value, group_name):
        from ray_tpu_torch.util import collective as col

        arr = np.full((3,), float(value))
        return col.broadcast(arr, src_rank=0, group_name=group_name)

    def do_reducescatter(self, value, group_name):
        from ray_tpu_torch.util import collective as col

        arr = np.full((4, 2), float(value))
        return col.reducescatter(arr, group_name)

    def do_barrier(self, group_name):
        from ray_tpu_torch.util import collective as col

        col.barrier(group_name)
        return True


def test_collective_store_backend(port_regular):
    from ray_tpu_torch.util import collective as col

    workers = [CollectiveWorker.remote() for _ in range(2)]
    col.create_collective_group(workers, 2, [0, 1], backend="store",
                                group_name="g1")
    outs = ray_tpu_torch.get(
        [w.do_allreduce.remote(i + 1, "g1") for i, w in enumerate(workers)],
        timeout=60,
    )
    for out in outs:
        np.testing.assert_allclose(out, np.full((4,), 3.0))
    gathered = ray_tpu_torch.get(
        [w.do_allgather.remote(i + 1, "g1") for i, w in enumerate(workers)],
        timeout=60,
    )
    for g in gathered:
        assert len(g) == 2
        np.testing.assert_allclose(g[0], np.full((2,), 1.0))
        np.testing.assert_allclose(g[1], np.full((2,), 2.0))
    bc = ray_tpu_torch.get(
        [w.do_broadcast.remote(i + 10, "g1") for i, w in enumerate(workers)],
        timeout=60,
    )
    np.testing.assert_allclose(bc[0], np.full((3,), 10.0))
    np.testing.assert_allclose(bc[1], np.full((3,), 10.0))
    rs = ray_tpu_torch.get(
        [w.do_reducescatter.remote(i + 1, "g1") for i, w in enumerate(workers)],
        timeout=60,
    )
    np.testing.assert_allclose(rs[0], np.full((2, 2), 3.0))
    np.testing.assert_allclose(rs[1], np.full((2, 2), 3.0))
    assert all(
        ray_tpu_torch.get([w.do_barrier.remote("g1") for w in workers],
                          timeout=60)
    )


@ray_tpu_torch.remote
class NcclCollectiveWorker:
    """A rank of a torch.distributed gang: the "nccl" backend's path (a
    gloo process group on the CPU), beside a store group on the same
    actors for the comparison."""

    def setup(self, init_method, world_size, rank):
        import torch.distributed as dist

        from ray_tpu_torch.util import collective as col

        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world_size, rank=rank)
        col.init_collective_group(world_size, rank, backend="nccl",
                                  group_name="xg")
        return rank

    def _rt_init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend, group_name)
        return rank

    def do_ops(self, rank, group):
        import numpy as np
        import torch

        from ray_tpu_torch.util import collective as col

        out = {}
        out["ar"] = col.allreduce(np.full((4,), float(rank + 1)), group)
        out["ag"] = col.allgather(np.full((2,), float(rank + 1)), group)
        out["bc"] = col.broadcast(np.full((3,), float(rank + 10)),
                                  src_rank=0, group_name=group)
        out["rs"] = col.reducescatter(
            np.arange(8, dtype=np.float32).reshape(4, 2) * (rank + 1), group)
        col.barrier(group)
        # a torch tensor: reduced in place on the process group's backend,
        # returned as numpy by the store backend
        t = torch.full((4,), float(rank + 1))
        res = col.allreduce(t, group)
        out["tensor_in_place"] = res is t
        out["tensor_type"] = type(res).__name__
        out["tensor"] = np.asarray(res)
        return out

    def teardown(self):
        import torch.distributed as dist

        dist.destroy_process_group()
        return True


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_collective_nccl_backend(port_regular):
    """backend="nccl" (the port's default, the reference's "xla"): each op
    is one torch.distributed collective on the gang's process group; its
    results are the reference's expected values and the store backend's."""
    from ray_tpu_torch.util import collective as col

    init = f"tcp://127.0.0.1:{_free_port()}"
    workers = [NcclCollectiveWorker.remote() for _ in range(2)]
    ray_tpu_torch.get(
        [w.setup.remote(init, 2, i) for i, w in enumerate(workers)],
        timeout=120)
    col.create_collective_group(workers, 2, [0, 1], backend="store",
                                group_name="sg")
    try:
        outs = ray_tpu_torch.get(
            [w.do_ops.remote(i, "xg") for i, w in enumerate(workers)],
            timeout=120)
        store = ray_tpu_torch.get(
            [w.do_ops.remote(i, "sg") for i, w in enumerate(workers)],
            timeout=120)
    finally:
        ray_tpu_torch.get([w.teardown.remote() for w in workers], timeout=60)
    for out in outs:
        np.testing.assert_allclose(out["ar"], np.full((4,), 3.0))
        np.testing.assert_allclose(out["ag"][0], np.full((2,), 1.0))
        np.testing.assert_allclose(out["ag"][1], np.full((2,), 2.0))
        np.testing.assert_allclose(out["bc"], np.full((3,), 10.0))
        assert out["tensor_in_place"] and out["tensor_type"] == "Tensor"
        np.testing.assert_allclose(out["tensor"], np.full((4,), 3.0))
    reduced = np.arange(8, dtype=np.float32).reshape(4, 2) * 3
    np.testing.assert_allclose(outs[0]["rs"], reduced[:2])
    np.testing.assert_allclose(outs[1]["rs"], reduced[2:])
    for nccl, st in zip(outs, store):
        for key in ("ar", "bc", "rs", "tensor"):
            np.testing.assert_array_equal(np.asarray(nccl[key]),
                                          np.asarray(st[key]))
        for a, b in zip(nccl["ag"], st["ag"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert st["tensor_type"] == "ndarray" and not st["tensor_in_place"]


def test_store_backend_returns_numpy_for_a_tensor(port_regular):
    """The store path hands back numpy for a tensor input (the reference's
    ``_to_numpy`` does so for a ``jax.Array``): callers copy the result
    back to their device."""
    from ray_tpu.util.collective import collective as ref
    from ray_tpu_torch.util.collective import collective as port

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = port._to_numpy(t)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref._to_numpy(t.numpy()))
    g = port._Group("solo", 1, 0, "store")
    port._groups["solo"] = g
    try:
        out = port.allreduce(t, "solo")
    finally:
        port._groups.pop("solo", None)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, t.numpy())
    # numpy has no bfloat16: a bf16 tensor crosses as float32, exactly
    b = torch.tensor([1.5, -2.25, 3.0e3], dtype=torch.bfloat16)
    got = port._to_numpy(b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, b.float().numpy())


@pytest.fixture
def fake_world():
    """A process group of 8 ranks in this process (rank 0): torch's "fake"
    backend, whose collectives move no data."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_and_ingraph_collectives(fake_world):
    from ray_tpu_torch import parallel

    mesh = parallel.create_mesh({"data": 4, "model": 2})
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {
        "data": 4, "model": 2}

    mesh2 = parallel.auto_mesh(model=2)
    shape2 = dict(zip(mesh2.mesh_dim_names, mesh2.mesh.shape))
    assert shape2["model"] == 2 and shape2["data"] == 4

    # the allreduce over the data axis builds on that axis's group
    ar = parallel.compiled_allreduce(mesh, "data")
    assert callable(ar)
    assert mesh.get_group("data").size() == 4


def test_fsdp_param_sharding(fake_world):
    from torch.distributed.tensor import DTensor, Shard

    from ray_tpu_torch import parallel

    mesh = parallel.create_mesh({"data": 2, "fsdp": 4})

    class Big(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1024, 256))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.big = Big()
            self.small = torch.nn.Parameter(torch.zeros(4))

    model = parallel.shard_params_fsdp(Model(), mesh)
    big = model.big.w
    assert isinstance(big, DTensor)
    assert big.device_mesh.mesh_dim_names == ("data", "fsdp")
    assert big.placements[-1] == Shard(0)
    assert tuple(big.full_tensor().shape) == (1024, 256)
    # the big parameter's module is an FSDP unit of its own; the small one
    # is the root's
    assert type(model.big).__name__.startswith("FSDP")
    assert type(model).__name__.startswith("FSDP")
