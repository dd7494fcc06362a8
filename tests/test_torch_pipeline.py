"""The port's pipeline parallelism (``ray_tpu_torch.parallel.pipeline`` and
GPT-2's pipelined step) against ``ray_tpu``'s, over gloo on the CPU.

``tests/torch_model_parallel_ranks.py`` runs as 4 gloo processes
(``tests/torch_ranks.py``), in the background while this process computes
the JAX side on the 8 virtual CPU devices of ``tests/conftest.py``.

- ``build_pipeline_fn`` over 4 stages of tanh(x @ w + b) on 6 microbatches,
  from the same numpy weights as the reference's pipeline: its output
  against the reference's and the sequential stages within 1e-5, each
  rank's stage gradients of sum(y * wt) against the sequential ones within
  1e-4 (``tests/test_pipeline.py``'s limits). With the outputs replicated
  by ``torch.distributed.nn``'s all-reduce, whose backward sums the
  cotangent over the ranks, the gradients come out 4x: the test that holds
  ``psum_replicated``'s identity backward in place.
- GPT-2's pipelined step (``make_pipeline_train_state``,
  ``shard_pipeline_state``, ``build_train_step_pp``, 2 microbatches) at
  {"data": 2, "pipeline": 2}, ``small_test(n_layer=4)`` in f32, from the
  reference's own pipeline tree bridged by ``pipeline_params_from_jax``:
  losses and each rank's parameters after 3 AdamW steps within 1e-4 of the
  reference's step (the ``c_attn`` key-bias exception of
  ``tests/test_torch_parallel.py``), and a masked batch whose valid tokens
  differ across the data shards: the loss within 1e-4 of the reference's,
  which is the plain model's masked loss.
- In this process: the bridge of the reference's stacked tree, the
  stacking of stage parameters, a rank keeping only its stage, and the
  pipelined step at a world of one equal to the plain step.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.pipeline import build_pipeline_fn, pipeline_apply
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import (params_from_jax,
                                          pipeline_params_from_jax)
from tests.test_torch_ring_attention import assert_params
from tests.torch_ranks import Worlds

S, M, D = 4, 6, 16
LR, STEPS, GB, T = 3e-4, 3, 4, 32
PP_MODEL = {"n_layer": 4}


def _stage_inputs():
    rng = np.random.default_rng(40)
    return {"w": (rng.standard_normal((S, D, D)) / np.sqrt(D)
                  ).astype(np.float32),
            "b": (rng.standard_normal((S, D)) * 0.1).astype(np.float32),
            "mb": rng.standard_normal((M, 8, D)).astype(np.float32),
            "wt": rng.standard_normal((M, 8, D)).astype(np.float32)}


def _batch(masked=False):
    ids = np.random.default_rng(5).integers(0, 512, size=(GB, T + 1),
                                            dtype=np.int64)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    if masked:
        # valid tokens differ across the data shards (rows 0-1 vs 2-3)
        mask = np.ones((GB, T), np.float32)
        mask[:2, 8:] = 0.0
        mask[2:, 24:] = 0.0
        batch["mask"] = mask
    return batch


def _pp_config():
    return jgpt2.GPT2Config.small_test(dtype=jnp.float32, **PP_MODEL)


@functools.lru_cache(maxsize=None)
def _jax_pp_state():
    return jgpt2.make_pipeline_train_state(_pp_config(),
                                           jax.random.PRNGKey(0),
                                           n_stages=2)


def _bridge(pp_params):
    return {k: v.numpy() for k, v in pipeline_params_from_jax(
        jax.tree.map(np.asarray, pp_params)).items()}


CASES = [{"kind": "pipeline", "name": "pipeline", "axes": {"pipeline": S}},
         {"kind": "pipeline", "name": "pipeline_sum_backward",
          "axes": {"pipeline": S}, "sum_backward": True},
         {"kind": "gpt2_pp", "name": "gpt2_pp",
          "axes": {"data": 2, "pipeline": 2}, "model": PP_MODEL,
          "microbatches": 2, "steps": STEPS},
         {"kind": "gpt2_pp", "name": "gpt2_pp_masked",
          "axes": {"data": 2, "pipeline": 2}, "model": PP_MODEL,
          "microbatches": 2, "steps": 1}]


def _arrays():
    out = {}
    for name in ("pipeline", "pipeline_sum_backward"):
        out.update({f"{name}/{k}": v for k, v in _stage_inputs().items()})
    weights = _bridge(_jax_pp_state()[0])
    for name, masked in (("gpt2_pp", False), ("gpt2_pp_masked", True)):
        out.update({f"{name}/batch/{k}": v
                    for k, v in _batch(masked).items()})
        out.update({f"{name}/pp/{k}": v for k, v in weights.items()})
    return out


@pytest.fixture(scope="module")
def worlds():
    with tempfile.TemporaryDirectory() as tmp:
        w = Worlds(tmp, {4: CASES}, {4: _arrays()})
        try:
            yield w
        finally:
            w.close()


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@functools.lru_cache(maxsize=None)
def _jax_pipeline():
    x = {k: jnp.asarray(v) for k, v in _stage_inputs().items()}
    stacked = {"w": x["w"], "b": x["b"]}
    mesh = jpar.create_mesh({"pipeline": S}, devices=jax.devices()[:S])
    y_pp = build_pipeline_fn(_jax_stage, mesh)(stacked, x["mb"])

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    def seq(stacked):
        y = x["mb"]
        for s in range(S):
            y = _jax_stage(jax.tree.map(lambda p: p[s], stacked), y)
        return y

    def pp_loss(stacked):
        def local(stacked, mb):
            own = jax.tree.map(lambda p: p[0], stacked)
            return pipeline_apply(_jax_stage, own, mb, axis_name="pipeline")

        y = shard_map(local, mesh=mesh,
                      in_specs=(PartitionSpec("pipeline"), PartitionSpec()),
                      out_specs=PartitionSpec())(stacked, x["mb"])
        return (y * x["wt"]).sum()

    g_seq = jax.grad(lambda p: (seq(p) * x["wt"]).sum())(stacked)
    g_pp = jax.grad(pp_loss)(stacked)
    return (np.asarray(y_pp), np.asarray(seq(stacked)),
            {k: np.asarray(v) for k, v in g_seq.items()},
            {k: np.asarray(v) for k, v in g_pp.items()})


def test_pipeline_forward_matches_jax_and_sequential(worlds):
    y_pp, y_seq, _, _ = _jax_pipeline()
    np.testing.assert_allclose(y_pp, y_seq, atol=1e-5, rtol=1e-5)
    for res in worlds.result(4, "pipeline"):  # replicated on every rank
        np.testing.assert_allclose(res["y"], y_seq, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(res["y"], y_pp, atol=1e-5, rtol=1e-5)


def test_pipeline_grads_match_sequential(worlds):
    _, _, g_seq, g_pp = _jax_pipeline()
    for s, res in enumerate(worlds.result(4, "pipeline")):
        for name in ("w", "b"):
            np.testing.assert_allclose(res[f"g{name}"], g_seq[name][s],
                                       atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(res[f"g{name}"], g_pp[name][s],
                                       atol=1e-4, rtol=1e-4)


def test_pipeline_grads_catch_a_summing_backward(worlds):
    """The guard bites: an all-reduce whose backward sums the cotangent
    multiplies every stage's gradient by the axis size."""
    _, _, g_seq, _ = _jax_pipeline()
    for s, res in enumerate(worlds.result(4, "pipeline_sum_backward")):
        np.testing.assert_allclose(res["gw"], S * g_seq["w"][s], atol=4e-4,
                                   rtol=1e-4)
        assert not np.allclose(res["gw"], g_seq["w"][s], atol=1e-4,
                               rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_pp_run(masked, steps):
    pp_params, tx, opt_state = _jax_pp_state()
    mesh = jpar.create_mesh({"data": 2, "pipeline": 2},
                            devices=jax.devices()[:4])
    pp_params, opt_state = jgpt2.shard_pipeline_state(pp_params, opt_state,
                                                      mesh)
    step = jgpt2.build_train_step_pp(_pp_config(), tx, mesh,
                                     n_microbatches=2, donate=False)
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in _batch(masked).items()}
    losses = []
    for _ in range(steps):
        pp_params, opt_state, loss = step(pp_params, opt_state, batch)
        losses.append(float(loss))
    return np.asarray(losses), _bridge(pp_params)


def test_gpt2_pp_step_matches_jax_at_data_2_pipeline_2(worlds):
    losses, params = _jax_pp_run(False, STEPS)
    start = _bridge(_jax_pp_state()[0])
    for s, res in enumerate(worlds.result(4, "gpt2_pp")):
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-4)
        stage = (s % 2)  # rank = data index * 2 + pipeline index
        mine = {k for k in params if k.startswith("embed.")
                or k.startswith(f"stages.{stage}.")}
        assert {k[2:] for k in res if k.startswith("p/")} == mine
        assert_params(res, {k: params[k] for k in mine})
        moved = max(np.abs(res[f"p/{k}"] - start[k]).max() for k in mine)
        assert moved > STEPS * LR / 2


def test_gpt2_pp_masked_batch_matches_jax_and_the_plain_loss(worlds):
    (loss,), _ = _jax_pp_run(True, 1)
    model, params, _, _ = jgpt2.make_train_state(_pp_config(),
                                                 jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                            else v) for k, v in _batch(True).items()}
    plain = float(jgpt2.loss_fn(params, model, batch))
    np.testing.assert_allclose(loss, plain, rtol=0, atol=1e-4)
    for res in worlds.result(4, "gpt2_pp_masked"):
        np.testing.assert_allclose(res["losses"][0], loss, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_pipeline_bridge_carries_the_reference_tree():
    """``pipeline_params_from_jax``: block j of stage s is the stacked
    leaves at [s, j], and equals block s*per+j of the same seed's plain
    tree (the reference's PP state comes from the same init)."""
    cfg = _pp_config()
    sd = pipeline_params_from_jax(jax.tree.map(np.asarray,
                                               _jax_pp_state()[0]))
    flat = params_from_jax(jax.tree.map(np.asarray, jgpt2.init_params(
        cfg, jax.random.PRNGKey(0))[1]))
    for s in range(2):
        for j in range(2):
            for name, t in flat.items():
                prefix = f"h.{s * 2 + j}."
                if name.startswith(prefix):
                    torch.testing.assert_close(
                        sd[f"stages.{s}.{j}." + name[len(prefix):]], t,
                        rtol=0, atol=0)
    for name in ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias"):
        torch.testing.assert_close(sd[f"embed.{name}"], flat[name], rtol=0,
                                   atol=0)
    pp = tgpt2.GPT2Pipeline(tgpt2.GPT2Config.small_test(
        dtype=torch.float32, **PP_MODEL), 2)
    pp.load_state_dict(sd)  # every name, every shape
    del sd["embed.ln_f.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        pp.load_state_dict(sd)


def test_stack_stage_params_over_dicts_and_modules():
    blocks = [torch.nn.Linear(3, 2) for _ in range(4)]
    stacked = tpar.stack_stage_params([blocks[:2], blocks[2:]])
    assert stacked["weight"].shape == (2, 2, 2, 3)  # (stage, layer, ...)
    torch.testing.assert_close(stacked["bias"][1, 1], blocks[3].bias.detach())
    by_module = tpar.stack_stage_params(blocks)
    assert by_module["weight"].shape == (4, 2, 3)
    by_dict = tpar.stack_stage_params([b.state_dict() for b in blocks])
    torch.testing.assert_close(by_dict["bias"], by_module["bias"])
    with pytest.raises(ValueError, match="different parameter names"):
        tpar.stack_stage_params([{"a": torch.zeros(1)},
                                 {"b": torch.zeros(1)}])


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("loss_chunks", [0, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_pp_step_at_a_world_of_one_is_the_plain_step(world_of_one, masked,
                                                     loss_chunks):
    """One stage, 2 microbatches: the losses and parameters of 3 steps
    within 1e-6 of ``build_train_step``'s on the whole batch, with the
    loss in chunks or not."""
    cfg = tgpt2.GPT2Config.small_test(dtype=torch.float32,
                                      attention="flash",
                                      loss_chunks=loss_chunks, **PP_MODEL)
    batch = {k: torch.from_numpy(v) for k, v in _batch(masked).items()}
    gen = lambda: torch.Generator().manual_seed(4)
    model, opt = tgpt2.make_train_state(cfg, gen(), device="cpu")
    step = tgpt2.build_train_step(model, opt)
    pp, pp_opt = tgpt2.make_pipeline_train_state(cfg, gen(), n_stages=1,
                                                 device="cpu")
    mesh = tpar.create_mesh({"data": 1, "pipeline": 1})
    pp, pp_opt = tgpt2.shard_pipeline_state(pp, pp_opt, mesh)
    pp_step = tgpt2.build_train_step_pp(pp, pp_opt, mesh, n_microbatches=2)
    for _ in range(3):
        model, opt, loss = step(model, opt, batch)
        pp, pp_opt, pp_loss = pp_step(pp, pp_opt, batch)
        torch.testing.assert_close(pp_loss, loss, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(pp.stages[0][3].mlp.c_fc.weight,
                               model.h[3].mlp.c_fc.weight, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(pp.embed["wte"].weight, model.wte.weight,
                               atol=1e-6, rtol=1e-6)


def test_shard_pipeline_state_keeps_one_stage(world_of_one):
    cfg = tgpt2.GPT2Config.small_test(dtype=torch.float32, **PP_MODEL)
    pp, opt = tgpt2.make_pipeline_train_state(cfg, n_stages=2, device="cpu")
    mesh = tpar.create_mesh({"pipeline": 1})
    with pytest.raises(ValueError, match="2 stages over a pipeline axis of 1"):
        tgpt2.shard_pipeline_state(pp, opt, mesh)
    with pytest.raises(ValueError, match="shard_pipeline_state"):
        tgpt2.build_train_step_pp(pp, opt, mesh, n_microbatches=1)
    with pytest.raises(ValueError, match="not divisible"):
        tgpt2.GPT2Pipeline(cfg, 3)
    # rank 0 of two: stage 1's blocks and their optimizer entries go
    pp.stages[1] = torch.nn.ModuleList()
    tgpt2._keep_params(opt, set(pp.parameters()))
    held = [p for g in opt.param_groups for p in g["params"]]
    assert len(held) == len(list(pp.parameters()))
    assert not any(n.startswith("stages.1.") for n, _ in
                   pp.named_parameters())
