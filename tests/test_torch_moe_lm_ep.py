"""The port's expert-parallel MoE LM (``MoELMConfig(ep_axis=...)`` and
``shard_train_state_ep``) against ``ray_tpu``'s, over gloo on the CPU.

``tests/torch_model_parallel_ranks.py`` runs as 4 gloo processes
(``tests/torch_ranks.py``), in the background while this process computes
the JAX side on the 8 virtual CPU devices of ``tests/conftest.py``.

- ``shard_train_state_ep`` at {"data": 2, "ep": 2}, ``small_test`` (4
  experts, an MoE FFN in every block, capacity factor 1.25, so tokens drop)
  from the bridged weights, 3 AdamW steps of ``build_train_step`` on a
  global batch of 8 x 16: each step's loss, lm and aux within 1e-4 of the
  reference's GSPMD step (``shard_train_state_ep``) and of its local step
  (``tests/test_moe_lm.py``'s GSPMD-vs-local check, there at 1e-3: routing
  and capacity are the global batch's), and each rank's parameters (its
  experts' slice of ``wi``/``wo``) after the steps within 1e-4 of the
  reference's (the ``c_attn`` key-bias exception of
  ``tests/test_torch_parallel.py``).
- ``MoELMConfig(ep_axis="ep")`` with ``shard_experts`` (each rank its
  experts, its block of the batch over (data, ep), routing on its own
  tokens): each rank's logits and MoE blocks' aux within 1e-5 against the
  reference's model under ``shard_map``: its own ``ep_axis`` path at
  {"data": 4, "ep": 1}; at {"data": 2, "ep": 2}, where that path cannot
  run (flax refuses a sharded expert axis: pinned below), the local model
  on each shard's tokens, which is what routing per shard computes.
- ``ops.moe.moe_ffn_ep_global`` at {"data": 2, "ep": 2}, capacity factor
  0.75 and 1.25: each rank's output and aux within 1e-5 of the local
  ``moe_ffn`` on the global batch, and each expert owner's FFN rows n_ep
  times the most tokens any rank keeps for one expert (counted in numpy
  from the routing), below n_ep times the global capacity.
- In this process: global routing at a world of one is the local routing,
  the expert rows it runs, and the config and the unbound forward.
"""

import functools
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import moe_lm as jlm
from ray_tpu.parallel.collectives import shard_map_norep
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import moe_lm as tlm
from ray_tpu_torch.models.convert import moe_lm_params_from_jax
from ray_tpu_torch.ops import moe as tmoe
from tests.test_torch_ring_attention import assert_params
from tests.torch_ranks import Worlds

STEPS, E = 3, 4
AXES = {"data": 2, "ep": 2}


def _cfg(**kw):
    return jlm.MoELMConfig.small_test(**kw)


def _batch():
    b = jgpt2.synthetic_batch(jax.random.PRNGKey(1), 8, 16, 128)
    return {k: np.asarray(v).astype(np.int64) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_state():
    return jlm.make_train_state(_cfg(), jax.random.PRNGKey(0))


def _to_torch(tree):
    return {k: v.numpy() for k, v in moe_lm_params_from_jax(
        jax.tree.map(np.asarray, tree), moe_every=1).items()}


EP_AXIS_MESHES = [("moe_ep_axis", AXES),
                  ("moe_ep_axis_4x1", {"data": 4, "ep": 1})]
ROW_CFS = [0.75, 1.25]
CASES = [{"kind": "moe_ep", "name": "moe_ep", "axes": AXES, "steps": STEPS}] \
    + [{"kind": "moe_ep_axis", "name": n, "axes": a}
       for n, a in EP_AXIS_MESHES] \
    + [{"kind": "moe_rows", "name": f"moe_rows_{cf}", "axes": AXES,
        "capacity_factor": cf} for cf in ROW_CFS]


def _arrays():
    weights = _to_torch(_jax_state()[1])
    out = {f"{n}/ids": _batch()["input_ids"] for n, _ in EP_AXIS_MESHES}
    for name in ("moe_ep", *(n for n, _ in EP_AXIS_MESHES)):
        out.update({f"{name}/mw/{k}": v for k, v in weights.items()})
    out.update({f"moe_ep/batch/{k}": v for k, v in _batch().items()})
    params, x = _row_inputs()
    for cf in ROW_CFS:
        out[f"moe_rows_{cf}/x"] = x
        out.update({f"moe_rows_{cf}/params/{k}": v
                    for k, v in params.items()})
    return out


def _row_inputs():
    """Router, experts (8 of them) and a global batch of 4 x 32 tokens."""
    g = torch.Generator().manual_seed(11)
    params = tmoe.init_moe_params(g, 16, 32, 8, device="cpu")
    x = torch.randn((128, 16), generator=g)
    return {k: v.numpy() for k, v in params.items()}, x.numpy()


@pytest.fixture(scope="module")
def worlds():
    with tempfile.TemporaryDirectory() as tmp:
        w = Worlds(tmp, {4: CASES}, {4: _arrays()})
        try:
            yield w
        finally:
            w.close()


def _run(step, params, opt_state, batch):
    rows = []
    for _ in range(STEPS):
        params, opt_state, loss, lm, aux = step(params, opt_state, batch)
        rows.append([float(loss), float(lm), float(aux)])
    return np.asarray(rows), params


@functools.lru_cache(maxsize=None)
def _jax_runs():
    batch = {k: jnp.asarray(v.astype(np.int32)) for k, v in _batch().items()}
    model, params, tx, opt = _jax_state()
    local, _ = _run(jlm.build_train_step(model, tx, donate=False), params,
                    opt, batch)
    mesh = jpar.create_mesh(AXES, devices=jax.devices()[:4])
    model2, params2, tx2, opt2 = jlm.make_train_state(_cfg(),
                                                      jax.random.PRNGKey(0))
    params2, opt2, place = jlm.shard_train_state_ep(params2, opt2, mesh)
    gspmd, after = _run(jlm.build_train_step(model2, tx2, donate=False),
                        params2, opt2, place(batch))
    return local, gspmd, _to_torch(after)


def test_shard_train_state_ep_matches_the_gspmd_and_local_steps(worlds):
    local, gspmd, _ = _jax_runs()
    np.testing.assert_allclose(gspmd, local, rtol=0, atol=1e-3)
    for res in worlds.result(4, "moe_ep"):
        np.testing.assert_allclose(res["metrics"], gspmd, rtol=0, atol=1e-4)
        np.testing.assert_allclose(res["metrics"], local, rtol=0, atol=1e-4)
        assert res["metrics"][-1, 0] < res["metrics"][0, 0]


def test_shard_train_state_ep_params_match_jax(worlds):
    _, _, params = _jax_runs()
    start = _to_torch(_jax_state()[1])
    for r, res in enumerate(worlds.result(4, "moe_ep")):
        e = r % 2  # rank = data index * 2 + ep index
        part = slice(e * E // 2, (e + 1) * E // 2)
        want = {k: v[part] if k.endswith((".wi", ".wo")) else v
                for k, v in params.items()}
        assert res["p/h.0.wi"].shape == (E // 2, 32, 128)
        assert_params(res, want)
        moved = max(np.abs(res[f"p/{k}"] - (v[part] if k.endswith(
            (".wi", ".wo")) else v)).max() for k, v in start.items())
        assert moved > STEPS * 3e-4 / 2


@pytest.mark.parametrize("cf", ROW_CFS)
def test_global_ep_runs_the_kept_rows_only(worlds, cf):
    params, x = _row_inputs()
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    x = torch.from_numpy(x)
    out, aux = tmoe.moe_ffn(params, x, cf)
    # the routing in numpy: each rank's block's count for each expert, its
    # exclusive prefix, and what the global capacity lets it keep
    expert = np.argmax(np.asarray(x @ params["router"]), axis=1)
    counts = np.stack([np.bincount(block, minlength=8)
                       for block in expert.reshape(4, -1)])
    capacity = tmoe.expert_capacity(128, 8, cf)
    before = np.cumsum(counts, axis=0) - counts
    kept = np.minimum(counts, np.clip(capacity - before, 0, None))
    assert kept.sum() < 128  # tokens drop at both factors
    n_ep, e_local = 2, 4
    for r, res in enumerate(worlds.result(4, f"moe_rows_{cf}")):
        np.testing.assert_allclose(res["out"], out[r * 32:(r + 1) * 32],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["aux"], float(aux), rtol=1e-5)
        assert res["rows"].tolist() == [e_local * n_ep * kept.max()]
        assert kept.max() < capacity


def _shard_map_forward(cfg, axes, ep_specs):
    """The reference's model under ``shard_map`` over a mesh of ``axes``,
    the batch split over (data, ep); with ``ep_specs`` the experts split
    over ep, else every parameter replicated. (logits, each shard's MoE
    blocks' aux), or flax's error."""
    model = jlm.MoELM(cfg)
    params = _jax_state()[1]
    mesh = jpar.create_mesh(axes, devices=jax.devices()[:4])
    specs = jax.tree_util.tree_map_with_path(
        lambda path, _: P("ep") if ep_specs
        and path[-1].key in ("wi", "wo") else P(), params)

    def fwd(p, ids):
        logits, aux = model.apply({"params": p}, ids, mutable=["aux_loss"])
        terms = [aux["aux_loss"][f"h_{i}"]["moe"][0]
                 for i in range(cfg.n_layer)]
        return logits, jnp.stack(terms)[None]

    shards = P(("data", "ep"))
    fn = shard_map_norep(fwd, mesh=mesh, in_specs=(specs, shards),
                         out_specs=(shards, shards))
    logits, aux = jax.jit(fn)(params, jnp.asarray(
        _batch()["input_ids"].astype(np.int32)))
    return np.asarray(logits), np.asarray(aux)


@functools.lru_cache(maxsize=None)
def _jax_ep_axis(axes_items):
    axes = dict(axes_items)
    if axes["ep"] == 1:  # the reference's own ep_axis path runs at ep 1
        return _shard_map_forward(_cfg(ep_axis="ep"), axes, True)
    # at ep 2 it cannot (see below): routing per shard over all E experts
    # is the local model on each shard's tokens
    return _shard_map_forward(_cfg(), axes, False)


@pytest.mark.parametrize("name,axes", EP_AXIS_MESHES)
def test_ep_axis_forward_matches_the_reference_shard_map_model(worlds, name,
                                                               axes):
    logits, aux = _jax_ep_axis(tuple(axes.items()))
    b = logits.shape[0] // 4
    for r, res in enumerate(worlds.result(4, name)):
        np.testing.assert_allclose(res["logits"], logits[r * b:(r + 1) * b],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["aux"], aux[r], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_experts", [E, E // 2])
def test_reference_ep_axis_cannot_shard_its_experts(num_experts):
    """The difference the port pins (ROADMAP queue 3): the reference's MoE
    block declares its router (D, num_experts) and its experts
    (num_experts, ...) from one ``num_experts``, so under ``shard_map`` with
    the experts split over an ep axis of 2 flax refuses one or the other:
    the global count for the expert shards, the local count for the
    replicated router. The port's config keeps the global count and
    ``shard_experts`` cuts each rank's slice."""
    from flax.errors import ScopeParamShapeError

    with pytest.raises(ScopeParamShapeError):
        _shard_map_forward(_cfg(ep_axis="ep", num_experts=num_experts),
                           AXES, True)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_global_routing_at_a_world_of_one_is_local_routing(world_of_one, cf,
                                                            monkeypatch):
    g = torch.Generator().manual_seed(3)
    params = tmoe.init_moe_params(g, 16, 32, 8, device="cpu")
    x = torch.randn((64, 16), generator=g)
    C = tmoe.expert_capacity(64, 8, cf)
    logits = x @ params["router"]
    expert, slot, keep, gate, aux = tmoe.route(logits, C)
    g_expert, g_slot, local, g_keep, g_gate, g_aux, kept = \
        tmoe.route_global(logits, C, world_of_one)
    for a, b in ((expert, g_expert), (slot, g_slot), (slot, local),
                 (keep, g_keep), (gate, g_gate)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(aux, g_aux, rtol=1e-6, atol=0)
    counts = torch.bincount(expert, minlength=8)
    torch.testing.assert_close(kept, counts.clamp(max=C)[None])
    out, aux = tmoe.moe_ffn(params, x, cf)
    rows, ffn = [], tmoe.expert_ffn
    monkeypatch.setattr(tmoe, "expert_ffn", lambda wi, wo, h: (
        rows.append(h.shape[0] * h.shape[1]), ffn(wi, wo, h))[1])
    g_out, g_aux = tmoe.moe_ffn_ep_global(params, x, world_of_one,
                                          world_of_one, cf)
    torch.testing.assert_close(out, g_out, rtol=0, atol=0)
    assert rows == [8 * int(counts.clamp(max=C).max())]


def test_ep_axis_config_builds_and_needs_its_experts_sharded(world_of_one):
    cfg = tlm.MoELMConfig.small_test(ep_axis="ep")
    assert cfg.ep_axis == "ep"
    model = tlm.init_params(cfg, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="shard_experts"):
        model(ids)
    mesh = tpar.create_mesh({"data": 1, "ep": 1})
    full = tlm.shard_experts(model, mesh)
    assert len(full) == 2 * cfg.n_layer
    logits, aux = model(ids)
    assert logits.shape == (1, 8, cfg.vocab_size) and len(aux) == 2
    two = SimpleNamespace(mesh_dim_names=("ep",), size=lambda i: 2,
                          get_local_rank=lambda axis: 0,
                          get_group=lambda axis: None)
    odd = tlm.init_params(tlm.MoELMConfig.small_test(num_experts=3),
                          device="cpu")
    with pytest.raises(ValueError, match="3 experts do not split over 2"):
        tlm.shard_experts(odd, two, "ep")
