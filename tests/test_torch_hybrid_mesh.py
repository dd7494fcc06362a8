"""The port's two-level meshes (``parallel.create_hybrid_mesh``): the cases
of ``tests/test_hybrid_mesh.py``. In the port a slice is a node: the dcn
axes span nodes and each of their rows holds the ranks of one node, the
ici axes live within it; on one node, contiguous blocks of ranks stand for
the nodes, as the reference carves a single process's devices.

- Layout and validation run in this process over a "fake" process group
  of 8 ranks (torch's in-process stand-in: every rank builds the same
  ``DeviceMesh`` from the same rank array, so rank 0's mesh is everyone's),
  held to the reference's mesh over the 8 virtual CPU devices of
  ``tests/conftest.py``: the same axes, sizes and positions, and the same
  errors ("appear in both levels", "needs N devices", "spans N").
- ``tests/torch_hybrid_mesh_ranks.py`` runs as 4 gloo processes: GPT-2
  ``small_test`` in f32 from the JAX weights (``convert.params_from_jax``)
  under FSDP2/HSDP on ``create_hybrid_mesh({"fsdp": 2}, {"data": 2})``,
  one step's loss held against the JAX package's loss on its hybrid mesh
  of the same axes and global batch within 1e-4 (the reference's own limit
  between its flat and hybrid meshes); a psum over the dcn axis gives the
  number of nodes (2), over the contiguous blocks and over rank
  descriptors that put the ranks on 2 nodes interleaved, whose dcn rows
  then hold one node's ranks each.
"""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh_utils import _slice_groups as ref_slice_groups
from ray_tpu_torch import parallel
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel.mesh_utils import RankDevice, _slice_groups

from tests.torch_ranks import REPO, Worlds

RANKS = REPO / "tests" / "torch_hybrid_mesh_ranks.py"
GB, T = 8, 32
CASES = [{"name": f"hybrid_{d}", "ici": {"fsdp": 2}, "dcn": {"data": 2},
          "devices": d} for d in ("default", "interleaved")]


@pytest.fixture(scope="module")
def fake_world():
    """A process group of 8 ranks in this process (rank 0): torch's "fake"
    backend, whose collectives move no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ranks(jax_mesh):
    """The reference mesh's device ids in its shape."""
    return np.vectorize(lambda d: d.id)(np.asarray(jax_mesh.devices))


def test_hybrid_mesh_shape_and_axis_order(fake_world):
    mesh = parallel.create_hybrid_mesh({"fsdp": 4}, {"data": 2})
    ref = jpar.create_hybrid_mesh({"fsdp": 4}, {"data": 2})
    # dcn axes outermost: collectives over "data" cross nodes
    assert mesh.mesh_dim_names == ("data", "fsdp") == ref.axis_names
    assert tuple(mesh.mesh.shape) == (2, 4)
    rows = mesh.mesh.numpy()
    # each dcn row is one virtual node = one contiguous block of ranks
    assert list(rows[0]) == sorted(rows[0]) and \
        list(rows[1]) == sorted(rows[1])
    assert rows[0].max() < rows[1].min()
    np.testing.assert_array_equal(rows, _ranks(ref))


def test_hybrid_mesh_validation(fake_world):
    for mod in (parallel, jpar):
        with pytest.raises(ValueError, match="both levels"):
            mod.create_hybrid_mesh({"data": 2}, {"data": 2})
        with pytest.raises(ValueError, match="needs"):
            mod.create_hybrid_mesh({"fsdp": 8}, {"data": 2})


def test_hybrid_mesh_multi_ici_axes(fake_world):
    mesh = parallel.create_hybrid_mesh({"fsdp": 2, "model": 2}, {"data": 2})
    ref = jpar.create_hybrid_mesh({"fsdp": 2, "model": 2}, {"data": 2})
    assert mesh.mesh_dim_names == ("data", "fsdp", "model") == \
        ref.axis_names
    assert tuple(mesh.mesh.shape) == (2, 2, 2)
    np.testing.assert_array_equal(mesh.mesh.numpy(), _ranks(ref))


@pytest.fixture(scope="module")
def worlds():
    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32)
    jax_params = jgpt2.init_params(cfg, jax.random.PRNGKey(0))[1]
    weights = params_from_jax(jax.tree.map(np.asarray, jax_params))
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                            size=(GB, T + 1), dtype=np.int64)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    arrays = {4: {**batch, **{f"w/{k}": v.numpy()
                              for k, v in weights.items()}}}
    with tempfile.TemporaryDirectory() as tmp:
        w = Worlds(tmp, {4: CASES}, arrays, script=RANKS, timeout_s=240)
        try:
            yield w, batch
        finally:
            w.close()


def _jax_hybrid_loss(batch):
    """The JAX package's first-step loss on its hybrid mesh
    {"data": 2} x {"fsdp": 2} over 4 of the virtual devices."""
    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32)
    model, params, tx, opt_state = jgpt2.make_train_state(
        cfg, jax.random.PRNGKey(0))
    step = jgpt2.build_train_step(model, tx, donate=False)
    mesh = jpar.create_hybrid_mesh({"fsdp": 2}, {"data": 2},
                                   devices=jax.devices()[:4])
    params, opt_state = jgpt2.shard_train_state(params, opt_state, mesh,
                                                fsdp=True)
    jbatch = jgpt2.shard_batch({k: jnp.asarray(v.astype(np.int32))
                                for k, v in batch.items()}, mesh)
    _, _, loss = step(params, opt_state, jbatch)
    return float(loss)


def test_hybrid_dp_fsdp_loss_parity(worlds):
    """DP over the dcn axis + FSDP within a node computes the JAX
    package's loss: axis placement changes which wire a collective rides,
    never the math."""
    w, batch = worlds
    want = _jax_hybrid_loss(batch)
    for case in CASES:
        outs = w.result(4, case["name"])
        for res in outs:
            assert json.loads(str(res["names"])) == ["data", "fsdp"]
            assert abs(float(res["loss"]) - want) < 1e-4, \
                (case["name"], float(res["loss"]), want)


def test_hybrid_mesh_collective_crosses_slices(worlds):
    """A psum over the dcn axis reduces across nodes: the number of nodes
    when each contributes 1."""
    w, _ = worlds
    contiguous = w.result(4, "hybrid_default")
    interleaved = w.result(4, "hybrid_interleaved")
    for res in contiguous + interleaved:
        assert bool((res["dcn_psum"] == 2.0).all())
    np.testing.assert_array_equal(contiguous[0]["ranks"], [[0, 1], [2, 3]])
    # ranks on nodes r % 2: each dcn row holds one node's ranks
    np.testing.assert_array_equal(interleaved[0]["ranks"], [[0, 2], [1, 3]])
    for outs in (contiguous, interleaved):  # every rank's mesh is one
        for res in outs:
            np.testing.assert_array_equal(res["ranks"], outs[0]["ranks"])


class _FakeGpuRank:
    """The reference's stand-in device (id, slice_index, process_index)."""

    def __init__(self, id_, slice_index, process_index=0):
        self.id = id_
        self.slice_index = slice_index
        self.process_index = process_index


def test_slice_index_grouping_on_fake_hardware():
    """Ranks carrying ``slice_index`` group BY SLICE (not by position):
    interleaved enumeration still puts each dcn row on one slice, as the
    reference groups its devices."""
    devs = [RankDevice(i, slice_index=i % 2) for i in range(8)]
    groups, virtual = _slice_groups(devs, n_ici=4)
    assert not virtual
    assert [d.slice_index for d in groups[0]] == [0, 0, 0, 0]
    assert [d.slice_index for d in groups[1]] == [1, 1, 1, 1]
    ref_groups, ref_virtual = ref_slice_groups(
        [_FakeGpuRank(i, i % 2) for i in range(8)], n_ici=4)
    assert ref_virtual == virtual
    assert [[d.id for d in g] for g in groups] == \
        [[d.id for d in g] for g in ref_groups]
    # no slice known: the ranks' nodes group them
    by_node = [RankDevice(i, process_index=i // 4) for i in range(8)]
    groups, virtual = _slice_groups(by_node, n_ici=4)
    assert not virtual and [[d.rank for d in g] for g in groups] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_hybrid_mesh_surplus_real_slices_raise(fake_world):
    """More nodes than the dcn extent raise (a node left out of the mesh
    would hold no part of it); an explicit ``devices=`` subset is the
    sanctioned way."""
    devs = [RankDevice(i, slice_index=i // 2) for i in range(8)]  # 4 slices
    with pytest.raises(ValueError, match="spans 4"):
        parallel.create_hybrid_mesh({"fsdp": 2}, {"data": 2}, devices=devs)
    mesh = parallel.create_hybrid_mesh({"fsdp": 2}, {"data": 2},
                                       devices=devs[:4])
    assert tuple(mesh.mesh.shape) == (2, 2)
    np.testing.assert_array_equal(mesh.mesh.numpy(), [[0, 1], [2, 3]])
    ref_devs = [_FakeGpuRank(i, i // 2) for i in range(8)]
    with pytest.raises(ValueError, match="spans 4"):
        jpar.create_hybrid_mesh({"fsdp": 2}, {"data": 2}, devices=ref_devs)
