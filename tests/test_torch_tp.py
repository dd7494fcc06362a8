"""The port's tensor parallelism (GPT-2's and Llama's Megatron layout)
against ``ray_tpu``'s, over gloo on the CPU.

``tests/torch_model_parallel_ranks.py`` runs as 4 and as 2 gloo processes
(``tests/torch_ranks.py``), in the background while this process computes
the JAX side on the 8 virtual CPU devices of ``tests/conftest.py``.

- The sharding plans against the reference's shardings, translated
  explicitly: a Flax kernel is (in, out) and a torch weight (out, in), so
  the reference's ``P(None, "model")`` kernel is the port's "col" (dim 0
  split), ``P("model", None)`` is "row", a ``P("model")`` bias is "col",
  ``P()`` is "rep"; GPT-2's fused ``c_attn`` is "col_qkv" (each of q, k, v
  split on its own, so a rank holds whole heads), where the reference's
  GSPMD layout splits the 3C columns contiguously and lets XLA reshard.
- GPT-2's TP step (``shard_train_state_tp``, ``build_train_step(mesh=)``)
  at {"data": 2, "model": 2}, ``small_test`` in f32 from the bridged
  weights, against the reference's ``shard_train_state_tp`` step on the
  same mesh and global batch: losses and each rank's parameter slices
  after 3 AdamW steps within 1e-4 (the ``c_attn`` key-bias exception of
  ``tests/test_torch_parallel.py``).
- Llama's TP at model 2 (``shard_params_tp``, ``apply_tp_plan``,
  ``shard_kv_caches_tp`` through ``generate``): the logits within 1e-5 of
  the reference's unsharded forward (``tests/test_models.py``'s placed
  forward, there at 2e-2 in bf16) and the greedy tokens equal to the
  reference's ``generate``; a rank holds n_kv_head / 2 KV heads; a GQA
  config with 1 KV head is refused over 2 ranks.
- In this process: ``tp_shard_state_dict`` against the parameters a placed
  model keeps, and ``logical_to_physical``.
"""

import functools
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh_utils import logical_to_physical as jl2p
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (llama_params_from_jax,
                                          params_from_jax,
                                          tp_shard_state_dict)
from ray_tpu_torch.parallel.mesh_utils import tp_slice
from tests.test_torch_ring_attention import assert_params
from tests.torch_ranks import Worlds

LR, STEPS, GB, T = 3e-4, 3, 8, 32
NEW_TOKENS = 4


def _global_batch():
    ids = np.random.default_rng(11).integers(0, 512, size=(GB, T + 1),
                                             dtype=np.int64)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _ids():
    return np.random.default_rng(12).integers(0, 256, size=(2, 8),
                                              dtype=np.int64)


def _gpt2_cfg():
    return jgpt2.GPT2Config.small_test(dtype=jnp.float32)


def _llama_cfg(**kw):
    return jllama.LlamaConfig.small_test(dtype=jnp.float32, **kw)


@functools.lru_cache(maxsize=None)
def _gpt2_state():
    return jgpt2.make_train_state(_gpt2_cfg(), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _llama_state():
    return jllama.init_params(_llama_cfg(), jax.random.PRNGKey(0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree, convert=params_from_jax):
    return {k: v.numpy() for k, v in convert(_np_tree(tree)).items()}


CASES = {4: [{"kind": "gpt2_tp", "name": "gpt2_tp",
              "axes": {"data": 2, "model": 2}, "model": {},
              "steps": STEPS}],
         2: [{"kind": "llama_tp", "name": "llama_tp", "axes": {"model": 2},
              "new_tokens": NEW_TOKENS}]}


def _arrays():
    gpt2_w = _to_torch(_gpt2_state()[1])
    llama_w = _to_torch(_llama_state()[1], llama_params_from_jax)
    return {4: {**{f"gpt2_tp/batch/{k}": v
                   for k, v in _global_batch().items()},
                **{f"gpt2_tp/w/{k}": v for k, v in gpt2_w.items()}},
            2: {"llama_tp/ids": _ids(),
                **{f"llama_tp/lw/{k}": v for k, v in llama_w.items()}}}


@pytest.fixture(scope="module")
def worlds():
    with tempfile.TemporaryDirectory() as tmp:
        w = Worlds(tmp, CASES, _arrays())
        try:
            yield w
        finally:
            w.close()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def _torch_name(path):
    """A Flax leaf path as the port's parameter name."""
    keys = [p.key for p in path]
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}[keys[-1]]
    parts = [f"h.{k[2:]}" if k.startswith("h_") else k for k in keys[:-1]]
    return ".".join(parts + [leaf])


def _port_placement(spec, leaf):
    """The reference's spec of a leaf as the port's placement."""
    spec = tuple(spec)
    if spec in ((), (None,), (None, None)):
        return "rep"
    if leaf == "kernel":
        return {(None, "model"): "col", ("model", None): "row"}[spec]
    return {("model",): "col"}[spec]


def _reference_plan(shardings):
    return {_torch_name(path): _port_placement(sh.spec, path[-1].key)
            for path, sh in jax.tree_util.tree_leaves_with_path(shardings)}


def test_gpt2_tp_plan_translates_the_reference_specs():
    mesh = jpar.create_mesh({"data": 4, "model": 2}, devices=jax.devices())
    _, params, _, _ = _gpt2_state()
    want = _reference_plan(jgpt2.shard_params_tp(params, mesh))
    model = tgpt2.init_params(tgpt2.GPT2Config.small_test(), device="cpu")
    got = tgpt2.shard_params_tp(model)
    assert set(got) == set(want)
    for name, placement in want.items():
        if ".c_attn." in name:  # whole heads of each of q, k and v
            assert placement == "col" and got[name] == "col_qkv", name
        else:
            assert got[name] == placement, name
    assert got["h.0.mlp.c_proj.bias"] == "rep"
    assert got["wte.weight"] == got["h.0.ln_1.weight"] == "rep"


def test_llama_tp_plan_translates_the_reference_specs():
    mesh = jpar.create_mesh({"model": 2}, devices=jax.devices()[:2])
    want = _reference_plan(jllama.shard_params_tp(_llama_state()[1], mesh))
    model = tllama.init_params(tllama.LlamaConfig.small_test(), device="cpu")
    got = tllama.shard_params_tp(model)
    assert got == want
    assert got["h.1.attn.q_proj.weight"] == "col"
    assert got["h.1.mlp.down_proj.weight"] == "row"
    assert got["lm_head.weight"] == got["embed.weight"] == "rep"


def _stub_mesh(n, index):
    """Stands for a (model,) DeviceMesh of n ranks seen from rank index."""
    return SimpleNamespace(mesh_dim_names=("model",), size=lambda i: n,
                           get_local_rank=lambda axis: index,
                           get_group=lambda axis: None)


@pytest.mark.parametrize("index", [0, 1])
def test_placed_model_keeps_its_slice_of_the_state_dict(index):
    model = tgpt2.init_params(tgpt2.GPT2Config.small_test(), device="cpu")
    full = {k: v.clone() for k, v in model.state_dict().items()}
    plan = tgpt2.shard_params_tp(model, _stub_mesh(2, index))
    tpar.apply_tp_plan(model, plan, _stub_mesh(2, index))
    want = tp_shard_state_dict(full, plan, index, 2)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0)
    # c_attn: rank index's heads of each of q, k and v
    w, C = full["h.0.attn.c_attn.weight"], 64
    part = slice(index * C // 2, (index + 1) * C // 2)
    torch.testing.assert_close(
        model.h[0].attn.c_attn.weight,
        torch.cat([w[part], w[C:][part], w[2 * C:][part]]))
    assert model.h[0].attn.c_attn.tp_mode == "col"
    assert model.h[0].mlp.c_proj.tp_mode == "row"
    assert model.h[0].mlp.c_proj.bias.shape == (64,)  # replicated


def test_tp_refuses_what_does_not_split():
    gqa = tllama.init_params(tllama.LlamaConfig.small_test(n_kv_head=1),
                             device="cpu")
    with pytest.raises(ValueError, match="n_kv_head=1"):
        tllama.shard_params_tp(gqa, _stub_mesh(2, 0))
    model = tgpt2.init_params(tgpt2.GPT2Config.small_test(), device="cpu")
    with pytest.raises(ValueError, match="n_head=4"):
        tgpt2.shard_params_tp(model, _stub_mesh(8, 0))
    with pytest.raises(ValueError, match="every parameter"):
        tpar.apply_tp_plan(model, {"wte.weight": "rep"}, _stub_mesh(2, 0))
    with pytest.raises(ValueError, match="unknown tensor-parallel"):
        tp_slice(torch.zeros(4), "diagonal", 0, 2)


def test_logical_to_physical_matches_the_reference():
    rules = {"batch": "data", "embed": None, "heads": "model"}
    for axes in (("batch", "embed"), ("batch", None, "heads"), ()):
        assert tpar.logical_to_physical(axes, rules) == tuple(
            jl2p(axes, rules))


# ---------------------------------------------------------------------------
# over gloo
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tp_run():
    model, params, tx, opt_state = jgpt2.make_train_state(
        _gpt2_cfg(), jax.random.PRNGKey(0))
    mesh = jpar.create_mesh({"data": 2, "model": 2},
                            devices=jax.devices()[:4])
    params, opt_state = jgpt2.shard_train_state_tp(params, opt_state, mesh)
    step = jgpt2.build_train_step(model, tx, donate=False)
    batch = jgpt2.shard_batch({k: jnp.asarray(v.astype(np.int32))
                               for k, v in _global_batch().items()}, mesh)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    assert "model" in str(params["h_0"]["attn"]["c_attn"]["kernel"]
                          .sharding.spec)
    return np.asarray(losses), _to_torch(params)


def test_gpt2_tp_step_matches_jax_at_data_2_model_2(worlds):
    losses, params = _jax_tp_run()
    model = tgpt2.init_params(tgpt2.GPT2Config.small_test(), device="cpu")
    plan = tgpt2.shard_params_tp(model)
    start = _to_torch(_gpt2_state()[1])
    for r, res in enumerate(worlds.result(4, "gpt2_tp")):
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-4)
        index = r % 2  # rank = data index * 2 + model index
        want = {k: v.numpy() for k, v in tp_shard_state_dict(
            {k: torch.from_numpy(v) for k, v in params.items()}, plan,
            index, 2).items()}
        # a rank's c_attn bias slice is q|k|v parts too: its key part is
        # the middle third, as the exception takes it
        assert_params(res, want)
        assert res["p/h.0.attn.c_attn.weight"].shape == (96, 64)
        moved = max(np.abs(res[f"p/{k}"] - tp_slice(
            torch.from_numpy(v), plan[k], index, 2).numpy()).max()
            for k, v in start.items())
        assert moved > STEPS * LR / 2


@functools.lru_cache(maxsize=None)
def _jax_llama():
    model, params = _llama_state()
    ids = jnp.asarray(_ids().astype(np.int32))
    logits, _ = model.apply({"params": params}, ids)
    tokens = jllama.generate(model, params, ids, NEW_TOKENS)
    return np.asarray(logits), np.asarray(tokens)


def test_llama_tp_logits_match_jax_at_model_2(worlds):
    logits, _ = _jax_llama()
    for res in worlds.result(2, "llama_tp"):
        np.testing.assert_allclose(res["logits"], logits, rtol=1e-5,
                                   atol=1e-5)
        assert int(res["k_proj_rows"]) == 1 * 16  # 2 KV heads of 16, over 2


def test_llama_tp_generate_through_split_caches_matches_jax(worlds):
    _, tokens = _jax_llama()
    for res in worlds.result(2, "llama_tp"):
        np.testing.assert_array_equal(res["tokens"], tokens)


def test_llama_tp_refuses_gqa_that_does_not_split(worlds):
    for res in worlds.result(2, "llama_tp"):
        assert bool(res["gqa_refused"])


# ---------------------------------------------------------------------------
# chip_smoke.py phase 27's runs, at small size on the CPU
# ---------------------------------------------------------------------------

def test_chip_runs_of_the_parallel_steps_at_small_size_on_the_cpu():
    """``tools/parallel_runs.py``, which ``chip_smoke.py`` phase 27 runs at
    full width over NCCL, at ``small_test`` size over gloo in a world of
    one: every GPT-2 step (SP, PP with 2 microbatches, TP) within 1e-5 of
    the plain step's losses from the same seed, the EP MoE LM within 1e-5
    of ``moe_runs.train``'s, and Llama's TP tokens equal to the plain
    ``generate``'s, its prefill's and decode steps' launches read apart.
    No kernel launches on the CPU."""
    from ray_tpu_torch.models import moe_lm as tlm
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.tools import moe_runs, parallel_runs

    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    before = {n: getattr(tattn, f"{n}_launches") for n in names}
    cfg = tgpt2.GPT2Config.small_test(dtype=torch.float32,
                                      attention="flash", loss_chunks=4)
    batch = tgpt2.synthetic_batch(1, 4, 32, cfg.vocab_size, device="cpu")
    model, opt = tgpt2.make_train_state(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
    step = tgpt2.build_train_step(model, opt)
    plain = [float(step(model, opt, batch)[2]) for _ in range(3)]
    mcfg = tlm.MoELMConfig.small_test()
    mbatch = tgpt2.synthetic_batch(2, 4, 16, mcfg.vocab_size, device="cpu")
    moe_plain = moe_runs.train(mcfg, mbatch, 3, "cpu")["losses"]
    lcfg = tllama.LlamaConfig.small_test(dtype=torch.float32)
    ids = torch.from_numpy(_ids())
    lmodel = tllama.init_params(lcfg, device="cpu")
    want = tllama.generate(lmodel, ids, NEW_TOKENS)
    with parallel_runs.world_of_one("gloo"):
        for kind in ("sp", "pp", "tp"):
            run = parallel_runs.gpt2_steps(kind, cfg, batch, 3, "cpu",
                                           microbatches=2)
            np.testing.assert_allclose(run["losses"], plain, rtol=0,
                                       atol=1e-5, err_msg=kind)
            assert len(run["step_ms"]) == 3
        run = parallel_runs.moe_ep_steps(mcfg, mbatch, 3, "cpu")
        np.testing.assert_allclose(run["losses"], moe_plain, rtol=0,
                                   atol=1e-5)
        read = lambda: {n: getattr(tattn, f"{n}_launches") for n in names}
        got = parallel_runs.llama_tp_generate(lmodel, ids, NEW_TOKENS,
                                              (lambda: None, read))
        assert torch.equal(got["tokens"], want)
        # the prefill and the decode steps read apart, as on the card
        for part in ("launches", "prefill_launches", "decode_launches"):
            assert got[part] == before
    assert read() == before
