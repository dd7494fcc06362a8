"""The port's Switch-MoE LM against ``ray_tpu.models.moe_lm`` on the same
weights.

Flax parameters from ``init_params(PRNGKey(0))`` at ``small_test`` (every
block an MoE block) and at ``small_test(n_layer=4, moe_every=2)`` (dense and
MoE blocks alternating) cross through ``moe_lm_params_from_jax``; token ids
come from a numpy seed. f32 throughout; the port's attention runs the
kernels' plain versions (CPU tensors), the reference's
``jax.nn.dot_product_attention``. Tolerances: logits atol 1e-5, rtol 1e-5;
(loss, lm, aux) atol = rtol = 1e-5; gradients atol 1e-5, rtol 1e-4, as
GPT-2's (``tests/test_torch_train.py``); parameters after AdamW steps atol
2e-5, except the key slice of each ``c_attn`` bias, whose true gradient is
exactly zero, within 2 lr per step (see ``tests/test_torch_train.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import moe_lm as jlm
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import moe_lm as tlm
from ray_tpu_torch.models.convert import (
    moe_lm_opt_state_from_jax,
    moe_lm_params_from_jax,
)
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.tools import moe_runs

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"all_moe": {}, "alternating": dict(n_layer=4, moe_every=2)}
LR = 3e-4


def _models(**kw):
    jcfg = jlm.MoELMConfig.small_test(**kw)
    tcfg = tlm.MoELMConfig.small_test(**kw)
    jmodel, jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tmodel = tlm.MoELM(tcfg)
    tmodel.load_state_dict(_bridge(jparams, tcfg))
    return jmodel, jparams, tmodel


def _bridge(tree, cfg):
    return moe_lm_params_from_jax(jax.tree.map(np.asarray, tree),
                                  cfg.moe_every)


def _batch(seed, bs=4, seq=16, vocab=128):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(bs, seq + 1))
    jbatch = {"input_ids": jnp.asarray(ids[:, :-1], jnp.int32),
              "labels": jnp.asarray(ids[:, 1:], jnp.int32)}
    tbatch = {"input_ids": torch.from_numpy(ids[:, :-1].copy()),
              "labels": torch.from_numpy(ids[:, 1:].copy())}
    return jbatch, tbatch


def _close_trees(got, want, atol, rtol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_logits_and_aux_match_flax(kw):
    jmodel, jparams, tmodel = _models(**kw)
    jbatch, tbatch = _batch(1)
    jlogits, aux_vars = jmodel.apply({"params": jparams},
                                     jbatch["input_ids"],
                                     mutable=["aux_loss"])
    with torch.no_grad():
        tlogits, taux = tmodel(tbatch["input_ids"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    jaux = jax.tree.leaves(aux_vars["aux_loss"])
    assert len(taux) == len(jaux) == sum(map(tmodel.config.is_moe,
                                             range(tmodel.config.n_layer)))
    # Flax's leaves come in the order of the block names, h_0 < h_1 < ...
    np.testing.assert_allclose([float(a) for a in taux],
                               [float(a) for a in jaux], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_loss_and_grads_match_flax(kw):
    jmodel, jparams, tmodel = _models(**kw)
    jbatch, tbatch = _batch(2)
    (jloss, (jlm_, jaux)), jgrads = jax.value_and_grad(
        jlm.loss_fn, has_aux=True)(jparams, jmodel, jbatch, 0.01)
    tloss, (tlm_, taux) = tlm.loss_fn(tmodel, tbatch, 0.01)
    tloss.backward()
    np.testing.assert_allclose(
        torch.stack([tloss, tlm_, taux]).detach().numpy(),
        [float(jloss), float(jlm_), float(jaux)], atol=1e-5, rtol=1e-5)
    _close_trees({n: p.grad for n, p in tmodel.named_parameters()},
                 _bridge(jgrads, tmodel.config), atol=1e-5, rtol=1e-4)


def _jax_steps(jmodel, jparams, jbatch, n, opt_state=None):
    tx = optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1)
    step = jlm.build_train_step(jmodel, tx, donate=False)
    opt_state = tx.init(jparams) if opt_state is None else opt_state
    for _ in range(n):
        jparams, opt_state, *_ = step(jparams, opt_state, jbatch)
    return jparams, opt_state


def _port_steps(tmodel, optimizer, tbatch, n):
    step = tlm.build_train_step(tmodel, optimizer)
    out = []
    for _ in range(n):
        tmodel, optimizer, *values = step(tmodel, optimizer, tbatch)
        out.append([float(v) for v in values])
    return out


def _assert_params_after_steps(tmodel, jparams, steps):
    want = _bridge(jparams, tmodel.config)
    got = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    C = tmodel.config.n_embd
    for name, p in tmodel.named_parameters():
        if name.endswith("attn.c_attn.bias"):
            assert float(p.grad[C:2 * C].abs().max()) < 1e-6, name
            diff = (got[name] - want[name])[C:2 * C].abs().max()
            assert float(diff) <= 2 * LR * steps, name
            got[name][C:2 * C] = want[name][C:2 * C]
    _close_trees(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_params_after_3_adamw_steps_match_optax(kw):
    jmodel, jparams, tmodel = _models(**kw)
    jbatch, tbatch = _batch(3)
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, 3)
    optimizer = tgpt2.make_optimizer(tmodel, LR)
    values = _port_steps(tmodel, optimizer, tbatch, 3)
    assert all(len(v) == 3 and np.isfinite(v).all() for v in values)
    _assert_params_after_steps(tmodel, jparams, 3)


def test_opt_state_bridge_resumes_a_jax_state():
    """Two JAX steps, then parameters and AdamW moments cross into the port;
    one more step on each side gives the same parameters."""
    kw = CONFIGS["alternating"]
    jmodel, jparams, tmodel = _models(**kw)
    jbatch, tbatch = _batch(4)
    jparams, opt_state = _jax_steps(jmodel, jparams, jbatch, 2)
    tmodel.load_state_dict(_bridge(jparams, tmodel.config))
    optimizer = tgpt2.make_optimizer(tmodel, LR)
    moe_lm_opt_state_from_jax(jax.tree.map(np.asarray, opt_state), tmodel,
                              optimizer)
    wi = optimizer.state[tmodel.h[1].wi]
    assert float(wi["step"]) == 2.0
    np.testing.assert_array_equal(wi["exp_avg"].numpy(),
                                  np.asarray(opt_state[0].mu["h_1"]["wi"]))
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, 1, opt_state)
    _port_steps(tmodel, optimizer, tbatch, 1)
    _assert_params_after_steps(tmodel, jparams, 1)


def test_aux_is_zero_without_an_moe_block():
    kw = dict(n_layer=2, moe_every=3)
    jmodel, jparams, tmodel = _models(**kw)
    assert not any(isinstance(b, tlm.MoEBlock) for b in tmodel.h)
    jbatch, tbatch = _batch(5)
    _, (jlm_, jaux) = jlm.loss_fn(jparams, jmodel, jbatch, 0.01)
    with torch.no_grad():
        loss, (lm, aux) = tlm.loss_fn(tmodel, tbatch, 0.01)
    assert float(jaux) == 0.0 and float(aux) == 0.0
    assert float(loss) == float(lm)
    np.testing.assert_allclose(float(lm), float(jlm_), atol=1e-5, rtol=1e-5)


def test_index_dispatch_gives_the_one_hot_loss_to_the_bit():
    """The LM through ``moe_ffn`` and through the reference's one-hot
    einsums (``moe_runs.one_hot_dispatch``): the same loss, lm and aux to
    the bit."""
    _, _, tmodel = _models(**CONFIGS["alternating"], capacity_factor=0.5)
    _, tbatch = _batch(6)
    with torch.no_grad():
        index = tlm.loss_fn(tmodel, tbatch, 0.01)
        with moe_runs.one_hot_dispatch():
            one_hot = tlm.loss_fn(tmodel, tbatch, 0.01)
    assert tmoe.moe_ffn is not tmoe.moe_ffn_dense
    assert float(index[0]) == float(one_hot[0])
    assert float(index[1][1]) == float(one_hot[1][1])


def test_forward_and_param_structure():
    """``tests/test_moe_lm.py::test_forward_and_param_structure`` on the
    port, with its init's scales."""
    cfg = tlm.MoELMConfig.small_test()
    model = tlm.init_params(cfg, device="cpu")
    logits, aux = model(torch.zeros((2, 8), dtype=torch.long))
    assert logits.shape == (2, 8, cfg.vocab_size) and len(aux) == 2
    for i in range(cfg.n_layer):
        blk = model.h[i]
        assert blk.wi.shape == (cfg.num_experts, cfg.n_embd, 4 * cfg.n_embd)
        assert blk.wo.shape == (cfg.num_experts, 4 * cfg.n_embd, cfg.n_embd)
        assert blk.router.shape == (cfg.n_embd, cfg.num_experts)
    D = cfg.n_embd
    with torch.no_grad():
        wide = tlm.init_params(tlm.MoELMConfig.small_test(n_embd=256,
                                                          n_head=4),
                               device="cpu")
        assert abs(float(wide.h[0].wi.std()) - 256 ** -0.5) < 0.005
        assert abs(float(wide.h[0].wo.std()) - 1024 ** -0.5) < 0.002
        assert abs(float(wide.h[0].router.std()) - 256 ** -0.5) < 0.01
        assert float(model.h[0].ln_2.weight.min()) == 1.0
        assert float(model.h[0].attn.c_attn.bias.abs().max()) == 0.0
    assert D == 32 and all(p.dtype == torch.float32
                           for p in model.parameters())
    full = tlm.MoELMConfig()
    with torch.device("meta"):
        n = sum(p.numel() for p in tlm.MoELM(full).parameters())
    assert n == 322_634_496 and full.dtype == torch.bfloat16
    assert [full.is_moe(i) for i in range(4)] == [False, True, False, True]


def test_training_reduces_loss_and_reports_aux():
    """``tests/test_moe_lm.py::test_training_reduces_loss_and_reports_aux``
    on the port: 12 AdamW steps at lr 1e-2 on one batch."""
    cfg = tlm.MoELMConfig.small_test()
    model, optimizer = tlm.make_train_state(cfg, learning_rate=1e-2,
                                            device="cpu")
    assert optimizer.defaults["betas"] == (0.9, 0.95)
    assert optimizer.defaults["weight_decay"] == 0.1
    step = tlm.build_train_step(model, optimizer)
    _, batch = _batch(1, vocab=cfg.vocab_size)
    losses, auxes = [], []
    for _ in range(12):
        model, optimizer, loss, lm, aux = step(model, optimizer, batch)
        losses.append(float(loss))
        auxes.append(float(aux))
        assert not (loss.requires_grad or lm.requires_grad
                    or aux.requires_grad)
    assert losses[-1] < losses[0] * 0.9, losses
    assert all(np.isfinite(a) and a > 0.1 for a in auxes)


def test_capacity_drops_route_through_residual():
    """``tests/test_moe_lm.py::test_capacity_drops_route_through_residual``
    on the port: at capacity factor 0.05 most tokens drop and ride the
    residual, and the step's loss is finite (and the reference's)."""
    kw = dict(capacity_factor=0.05)
    jmodel, jparams, tmodel = _models(**kw)
    jbatch, tbatch = _batch(7)
    shares = moe_runs.drop_shares(tmodel, tbatch)
    assert len(shares) == 2 and min(shares) > 0.5
    (jloss, _), _ = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jparams, jmodel, jbatch, 0.01)
    optimizer = tgpt2.make_optimizer(tmodel, LR)
    (loss, _, _), = _port_steps(tmodel, optimizer, tbatch, 1)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jloss), atol=1e-5, rtol=1e-5)


def test_ep_axis_make_train_state_and_donate_raise(monkeypatch):
    assert tlm.MoELMConfig.small_test(ep_axis="ep").ep_axis == "ep"
    with pytest.raises(ValueError, match="multiple of n_head"):
        tlm.MoELMConfig.small_test(n_embd=30, n_head=4)
    model, optimizer = tlm.make_train_state(tlm.MoELMConfig.small_test(),
                                            device="cpu")
    with pytest.raises(ValueError, match="in place"):
        tlm.build_train_step(model, optimizer, donate=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.make_train_state(tlm.MoELMConfig.small_test())


def test_chip_runs_drive_the_paths_at_small_size_on_the_cpu():
    """``tools/moe_runs.py``, which ``chip_smoke.py`` runs at full width on
    the card, at ``small_test`` size on the CPU: no kernel launches here
    (CPU tensors take the plain versions), the one-hot yardstick's first
    loss and drop shares equal the index form's, and the two attention
    paths agree to the bit."""
    from ray_tpu_torch.tools import train_runs

    cfg = tlm.MoELMConfig.small_test(n_layer=4, moe_every=2)
    batch = tgpt2.synthetic_batch(0, 4, 32, cfg.vocab_size, device="cpu")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    before = {n: getattr(tattn, f"{n}_launches") for n in names}
    counted = []
    run = moe_runs.train(cfg, batch, 3, "cpu", 1e-2,
                         counts=(lambda: counted.append("zero"),
                                 lambda: counted.append("read") or 7))
    assert counted == ["zero", "read"] and run["launches"] == 7
    assert len(run["losses"]) == len(run["aux"]) == len(run["step_ms"]) == 3
    assert run["losses"][-1] < run["losses"][0]
    assert len(run["drop_shares"]["start"]) == 2
    with moe_runs.one_hot_dispatch():
        yard = moe_runs.train(cfg, batch, 1, "cpu", 1e-2)
    assert yard["losses"][0] == run["losses"][0]
    assert yard["drop_shares"]["start"] == run["drop_shares"]["start"]
    loss, grads = moe_runs.step_grads(cfg, batch, "cpu")
    with train_runs.plain_attention():
        plain_loss, plain_grads = moe_runs.step_grads(cfg, batch, "cpu")
    assert loss == plain_loss
    assert train_runs.grad_rel_errs(grads, plain_grads)["worst"] < 1e-5
    assert {n: getattr(tattn, f"{n}_launches") for n in names} == before


def test_port_import_walk_covers_the_moe_modules():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``, so the MoE modules are among the files it
    holds to importing neither JAX nor ``ray_tpu``."""
    names = {f.relative_to(REPO).as_posix()
             for f in (REPO / "ray_tpu_torch").rglob("*.py")}
    assert {"ray_tpu_torch/ops/moe.py", "ray_tpu_torch/models/moe_lm.py",
            "ray_tpu_torch/tools/moe_runs.py"} <= names
