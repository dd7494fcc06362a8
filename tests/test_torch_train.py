"""The port's GPT-2 training step against ``ray_tpu.models.gpt2``.

All on ``small_test`` in f32, with the JAX parameters (``init_params``,
PRNGKey(0)) carried across by ``params_from_jax`` and one batch of numpy
token ids fed to both. JAX's "flash" attention takes its scan path on the
CPU; the port's takes its plain forward and backward. Tolerances: loss
atol = rtol = 1e-5 and gradients atol 1e-5 / rtol 1e-4 (f32 sums taken in
another order through two layers); parameters after AdamW steps atol 2e-5.

One slice is held apart, and the tests say so where they do it: the key
part of each ``c_attn`` bias. Its true gradient is exactly 0 (adding b_k
shifts every score of a row by q . b_k, which the softmax ignores), so both
frameworks compute rounding noise of ~1e-9 there, and Adam, which moves
each weight by about lr * sign(g) in its first steps, turns that noise into
+-lr = 3e-4 per step with a sign of its own on each side. There the tests
check that the port's gradient is below 1e-6 and that the parameters stay
within 2 lr per step of JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import opt_state_from_jax, params_from_jax

B, T = 2, 32


def _batch(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, size=(B, T + 1), dtype=np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    if masked:
        batch["mask"] = (rng.random((B, T)) > 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.astype(np.float32 if k == "mask"
                                          else np.int64))
             for k, v in batch.items()})


def _models(**cfg):
    jcfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32, **cfg)
    jmodel, jparams = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    tmodel = tgpt2.GPT2(tgpt2.GPT2Config.small_test(dtype=torch.float32,
                                                    **cfg))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        jparams)))
    return jmodel, jparams, tmodel


def _jax_value_and_grad(jmodel, jparams, jbatch):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jgpt2.loss_fn(p, jmodel, b)))(jparams, jbatch)
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _port_value_and_grad(tmodel, tbatch):
    tmodel.zero_grad(set_to_none=True)
    loss = tgpt2.loss_fn(tmodel, tbatch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in tmodel.named_parameters()}


LR = 3e-4  # make_optimizer's default, on both sides


def _assert_close_trees(got, want, atol, rtol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


def _assert_params_after_steps(tmodel, jparams, steps):
    """Params at atol 2e-5, but the key slice of each c_attn bias (exactly
    zero true gradient, see the module docstring) within 2 lr per step."""
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    C = tmodel.config.n_embd
    for name, p in tmodel.named_parameters():
        if name.endswith("attn.c_attn.bias"):
            assert float(p.grad[C:2 * C].abs().max()) < 1e-6, name
            diff = (got[name] - want[name])[C:2 * C].abs().max()
            assert float(diff) <= 2 * LR * steps, name
            got[name][C:2 * C] = want[name][C:2 * C]
    _assert_close_trees(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("attention", ["flash", "auto"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss_chunks", [0, 4])
def test_loss_and_grads_match_jax(loss_chunks, masked, attention):
    jmodel, jparams, tmodel = _models(attention=attention,
                                      loss_chunks=loss_chunks)
    jbatch, tbatch = _batch(1, masked)
    jloss, jgrads = _jax_value_and_grad(jmodel, jparams, jbatch)
    tloss, tgrads = _port_value_and_grad(tmodel, tbatch)
    np.testing.assert_allclose(tloss, jloss, atol=1e-5, rtol=1e-5)
    _assert_close_trees(tgrads, jgrads, atol=1e-5, rtol=1e-4)


def test_chunked_loss_equals_full_loss_and_checks_divisibility():
    _, _, tmodel = _models(attention="flash")
    _, tbatch = _batch(2, masked=True)
    hidden = tmodel(tbatch["input_ids"], return_hidden=True)
    full = tgpt2.fused_xent(tmodel(tbatch["input_ids"]), tbatch["labels"],
                            tbatch["mask"])
    for n in (1, 4, 8):
        chunked = tgpt2.chunked_xent_tied(hidden, tmodel.wte.weight,
                                          tbatch["labels"], tbatch["mask"],
                                          n_chunks=n)
        torch.testing.assert_close(chunked, full, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of loss_chunks"):
        tgpt2.chunked_xent_tied(hidden, tmodel.wte.weight, tbatch["labels"],
                                n_chunks=5)


def test_remat_matches_no_remat_and_jax_remat():
    jbatch, tbatch = _batch(3)
    jmodel, jparams, remat_model = _models(attention="flash", remat=True)
    _, _, plain_model = _models(attention="flash")
    jloss, jgrads = _jax_value_and_grad(jmodel, jparams, jbatch)
    rloss, rgrads = _port_value_and_grad(remat_model, tbatch)
    ploss, pgrads = _port_value_and_grad(plain_model, tbatch)
    assert rloss == ploss
    _assert_close_trees(rgrads, pgrads, atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(rloss, jloss, atol=1e-5, rtol=1e-5)
    _assert_close_trees(rgrads, jgrads, atol=1e-5, rtol=1e-4)


def _jax_steps(jmodel, jparams, jbatch, n, opt_state=None):
    tx = jgpt2.make_optimizer()
    step = jgpt2.build_train_step(jmodel, tx, donate=False)
    opt_state = tx.init(jparams) if opt_state is None else opt_state
    for _ in range(n):
        jparams, opt_state, _ = step(jparams, opt_state, jbatch)
    return jparams, opt_state


def _port_steps(tmodel, optimizer, tbatch, n):
    step = tgpt2.build_train_step(tmodel, optimizer)
    losses = []
    for _ in range(n):
        tmodel, optimizer, loss = step(tmodel, optimizer, tbatch)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("steps", [1, 3])
def test_params_after_steps_match_jax(steps):
    jmodel, jparams, tmodel = _models(attention="flash", loss_chunks=4)
    jbatch, tbatch = _batch(4)
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, steps)
    _port_steps(tmodel, tgpt2.make_optimizer(tmodel), tbatch, steps)
    _assert_params_after_steps(tmodel, jparams, steps)


def test_opt_state_from_jax_resumes():
    """Two JAX steps, then params and AdamW moments cross into the port;
    one more step on each side gives the same params."""
    jmodel, jparams, tmodel = _models(attention="flash")
    jbatch, tbatch = _batch(5)
    jparams, opt_state = _jax_steps(jmodel, jparams, jbatch, 2)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        jparams)))
    optimizer = tgpt2.make_optimizer(tmodel)
    opt_state_from_jax(jax.tree.map(np.asarray, opt_state), tmodel,
                       optimizer)
    wte = optimizer.state[tmodel.wte.weight]
    assert float(wte["step"]) == 2.0
    np.testing.assert_array_equal(
        wte["exp_avg_sq"].numpy(),
        np.asarray(opt_state[0].nu["wte"]["embedding"]))
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, 1, opt_state)
    _port_steps(tmodel, optimizer, tbatch, 1)
    _assert_params_after_steps(tmodel, jparams, 1)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        opt_state_from_jax((optax.EmptyState(),), tmodel, optimizer)


def test_adamw_update_matches_optax_and_decays_every_leaf():
    """Two updates on random numpy params and grads: torch AdamW over every
    parameter equals optax.adamw(b1=0.9, b2=0.95, weight_decay=0.1), and a
    LayerNorm scale and a bias with zero gradient still shrink by the
    decay."""
    _, jparams, tmodel = _models(attention="flash")
    rng = np.random.default_rng(7)
    params = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jparams)
    grads = [jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jparams)
        for _ in range(2)]
    for g in grads:
        g["h_0"]["ln_1"]["scale"][:] = 0.0
        g["h_0"]["mlp"]["c_fc"]["bias"][:] = 0.0
    tx = optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    state = tx.init(params)
    jp = params
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    tmodel.load_state_dict(params_from_jax(params))
    optimizer = tgpt2.make_optimizer(tmodel)
    named = dict(tmodel.named_parameters())
    for g in grads:
        tg = params_from_jax(g)
        for name, p in named.items():
            p.grad = tg[name]
        optimizer.step()
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    got = {n: p.detach() for n, p in named.items()}
    _assert_close_trees(got, want, atol=1e-6, rtol=1e-6)
    start = params_from_jax(params)
    for name in ("h.0.ln_1.weight", "h.0.mlp.c_fc.bias"):
        torch.testing.assert_close(got[name],
                                   start[name] * (1 - 3e-4 * 0.1) ** 2)


def test_train_step_loss_falls_and_data_parallel_raises():
    torch.manual_seed(0)
    model, optimizer = tgpt2.make_train_state(
        tgpt2.GPT2Config.small_test(attention="flash", loss_chunks=4),
        torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(optimizer, torch.optim.AdamW)
    assert optimizer.defaults["betas"] == (0.9, 0.95)
    _, tbatch = _batch(6)
    losses = _port_steps(model, optimizer, tbatch, 3)
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
    with pytest.raises(NotImplementedError, match="The Train backend"):
        tgpt2.build_train_step(model, optimizer, mesh=object())
    with pytest.raises(NotImplementedError, match="The Train backend"):
        tgpt2.build_train_step(model, optimizer, ingraph_psum="chunked")
    with pytest.raises(ValueError, match="in place"):
        tgpt2.build_train_step(model, optimizer, donate=False)


def test_train_step_refuses_other_state_and_config_refuses_dropout():
    cfg = tgpt2.GPT2Config.small_test(loss_chunks=4)
    model, optimizer = tgpt2.make_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    other, other_opt = tgpt2.make_train_state(
        cfg, torch.Generator().manual_seed(1), device="cpu")
    step = tgpt2.build_train_step(model, optimizer)
    _, tbatch = _batch(7)
    for args in ((other, optimizer), (model, other_opt)):
        with pytest.raises(ValueError, match="another model"):
            step(*args, tbatch)
    assert all(p.grad is None for p in model.parameters())
    assert tgpt2.GPT2Config.small_test(dropout=0.0).dropout == 0.0
    with pytest.raises(ValueError, match="no dropout"):
        tgpt2.GPT2Config.small_test(dropout=0.1)
