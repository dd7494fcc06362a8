"""The port's DreamerV3 on the CPU, held against the JAX package's
``ray_tpu.rllib.dreamerv3``.

The reference's nets cross through ``convert.dreamerv3_params_from_jax``
(flax's ``GRUCell`` kernels become ``GRUCell``'s ``ih``/``hh``). JAX's keys
cannot be replayed in torch, so the port's losses take JAX's own draws: the
one-hot latents of the world model's ``feat`` and imagination's arrived-at
states, and imagination's actions, read from JAX's outputs (its
``wm_loss``, ``imagine`` and ``behavior_loss`` are the closures of its
jitted train step). Given the same draws, the losses, metrics, features,
returns, gradients and a whole update must agree: forward values at rtol
1e-5, atol 1e-5 and gradients at rtol 1e-4, atol 1e-6 (f32 through 6
recurrent steps and a backward through them); after one Adam step of every
net, rtol 1e-4, atol 1e-5. Then the reference's cases of
``tests/test_rllib_dreamerv3.py`` at their seeds, bars and marks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import dreamerv3 as jdv3
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import dreamerv3 as tdv3
from ray_tpu_torch.rllib.rl_module import get_state, set_state

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-5
SMALL = dict(units=16, gru_units=12, latent_cats=3, latent_classes=4,
             horizon=5, batch_size=3, batch_length=6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _config(cls, **over):
    cfg = cls().environment("CartPole-native").debugging(seed=0)
    for k, v in {**SMALL, **over}.items():
        setattr(cfg, k, v)
    return cfg


def _bridged(jm):
    return convert.dreamerv3_params_from_jax(
        _np_tree(jm.params), _np_tree(jm.actor_params),
        _np_tree(jm.critic_params))


@pytest.fixture()
def algos():
    """(JAX DreamerV3, the port's on the CPU with the JAX weights, the JAX
    train step's closures)."""
    ja = _config(jrl.DreamerV3Config).build()
    ta = _config(trl.DreamerV3Config).learners(
        num_gpus_per_learner=0).build()
    state = _bridged(ja.module)
    ta.module.set_state(state)
    set_state(ta.critic_ema, state["critic"])
    f = ja._train_step.__wrapped__
    fns = dict(zip(f.__code__.co_freevars,
                   (c.cell_contents for c in f.__closure__)))
    b = fns["behavior_loss"]
    fns.update(zip(b.__code__.co_freevars,
                   (c.cell_contents for c in b.__closure__)))
    w = fns["wm_loss"]
    fns.update(zip(w.__code__.co_freevars,
                   (c.cell_contents for c in w.__closure__)))
    yield ja, ta, fns
    ja.stop()
    ta.stop()


def _batch(rng, B=3, L=6, obs_dim=4):
    n = rng.integers(2, L + 1, size=B)
    mask = (np.arange(L)[None] < n[:, None]).astype(np.float32)
    return {"obs": (rng.normal(size=(B, L, obs_dim)) * mask[..., None]
                    ).astype(np.float32),
            "actions": (rng.integers(0, 2, (B, L)) * mask).astype(np.int32),
            "rewards": (rng.uniform(0, 1, (B, L)) * mask).astype(np.float32),
            "continues": np.where(rng.uniform(size=(B, L)) < 0.1, 0.0,
                                  1.0).astype(np.float32),
            "mask": mask}


def _jnp(batch):
    """The batch as the reference's jitted step sees it."""
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _draws(m, z):
    """Class indices of one-hot latents z (..., C * K)."""
    z = np.asarray(z)
    return torch.from_numpy(z.reshape(*z.shape[:-1], m.C, m.K).argmax(-1))


def _grads_close(params, want_sd, what):
    for name, p in params:
        _close(p.grad, want_sd[name], GRAD_RTOL, GRAD_ATOL, f"{what} {name}")


# ---------------------------------------------------------------------------
# the nets against the JAX package
# ---------------------------------------------------------------------------

def test_bridge_covers_every_parameter(algos):
    ja, ta, _ = algos
    state = _bridged(ja.module)
    for part, net in (("wm", ta.module.wm), ("actor", ta.module.actor),
                      ("critic", ta.module.critic)):
        assert set(state[part]) == set(net.state_dict()), part
        for k, v in net.state_dict().items():
            assert tuple(state[part][k].shape) == tuple(v.shape), k


def test_every_head_and_the_gru_match_jax(algos):
    ja, ta, _ = algos
    jm, tm = ja.module, ta.module
    rng = np.random.default_rng(1)
    x = lambda *shape: rng.normal(size=shape).astype(np.float32)
    feat = x(5, jm.h_dim + jm.latent_dim)
    cases = {"encoder": x(5, 4), "posterior": x(5, jm.h_dim + SMALL["units"]),
             "prior": x(5, jm.h_dim), "decoder": feat, "reward": feat,
             "continue": feat}
    heads = {"encoder": jm.encoder, "posterior": jm.posterior,
             "prior": jm.prior, "decoder": jm.decoder,
             "reward": jm.reward_head, "continue": jm.continue_head}
    with torch.no_grad():
        for name, inp in cases.items():
            want = heads[name].apply(jm.params[name], inp)
            _close(tm.wm[name](torch.from_numpy(inp)), want, what=name)
        _close(tm.actor(torch.from_numpy(feat)),
               jm.actor.apply(jm.actor_params, feat), what="actor")
        _close(tm.critic(torch.from_numpy(feat)),
               jm.critic.apply(jm.critic_params, feat), what="critic")
        h, za = x(5, jm.h_dim), x(5, jm.latent_dim + 2)
        _close(tm.wm["gru"](torch.from_numpy(h), torch.from_numpy(za)),
               jm.gru.apply(jm.params["gru"], h, za), what="gru")


def test_latent_sampling_and_obs_step_match_jax_given_its_draws(algos):
    ja, ta, fns = algos
    jm, tm = ja.module, ta.module
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, jm.latent_dim)).astype(np.float32) * 3
    z, lg = jm.sample_latent(jax.random.PRNGKey(3), jnp.asarray(logits))
    st, t_lg, idx = tm.sample_latent(torch.from_numpy(logits),
                                     idx=_draws(tm, z))
    _close(st, z, 0, 1e-6)
    _close(t_lg, lg)
    h = rng.normal(size=(6, jm.h_dim)).astype(np.float32)
    zz = np.array(z)
    a = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    obs = rng.normal(size=(6, 4)).astype(np.float32)
    h2, z2, post_lg = fns["obs_step"](jm.params, jax.random.PRNGKey(4), h,
                                      zz, a, obs)
    with torch.no_grad():
        t_h2, t_z2, t_post, _ = tm.obs_step(
            *(torch.from_numpy(v) for v in (h, zz, a, obs)),
            idx=_draws(tm, z2))
    _close(t_h2, h2)
    _close(t_z2, z2)
    _close(t_post, post_lg)


def test_world_model_loss_and_grads_match_jax_given_its_draws(algos):
    ja, ta, fns = algos
    batch = _batch(np.random.default_rng(5))
    key = jax.random.PRNGKey(6)
    (loss, (feat, metrics)), grads = jax.value_and_grad(
        fns["wm_loss"], has_aux=True)(ja.module.params, key, _jnp(batch))
    m = ta.module
    latents = _draws(m, np.asarray(feat)[..., m.h_dim:]).transpose(0, 1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_loss, t_feat, t_metrics, draws = ta.wm_loss(tb, latents)
    assert torch.equal(draws, latents)
    _close(t_loss, loss)
    assert set(t_metrics) == set(metrics)
    for k in metrics:
        _close(t_metrics[k], metrics[k], what=k)
    _close(t_feat, feat)
    params = list(m.wm.named_parameters())
    tdv3._backward(t_loss, [p for _, p in params])
    want = convert.dreamerv3_params_from_jax(
        _np_tree(grads), _np_tree(ja.module.actor_params),
        _np_tree(ja.module.critic_params))["wm"]
    _grads_close(params, want, "wm")


@pytest.mark.parametrize("ret_range", [1.0, 2.5])
def test_behavior_loss_and_grads_match_jax_given_its_draws(algos, ret_range):
    """Imagination from the world model's states (JAX's ``feat``), its
    actions and prior draws read from JAX's ``imagine`` under the same key
    ``behavior_loss`` hands it."""
    ja, ta, fns = algos
    jm, m = ja.module, ta.module
    batch = _batch(np.random.default_rng(7))
    _, (feat, _) = fns["wm_loss"](jm.params, jax.random.PRNGKey(8),
                                  _jnp(batch))
    feat0 = np.asarray(feat).reshape(-1, feat.shape[-1])
    mask0 = batch["mask"].reshape(-1)
    key = jax.random.PRNGKey(9)
    critic_ema = jax.tree.map(jnp.copy, jm.critic_params)

    def loss(ac):
        return fns["behavior_loss"](ac["a"], ac["c"], jm.params, critic_ema,
                                    key, feat0, mask0, ret_range)

    (total, (l_a, l_c, rets)), grads = jax.value_and_grad(
        loss, has_aux=True)({"a": jm.actor_params, "c": jm.critic_params})
    feats, acts, _, feats_next = fns["imagine"](jm.params, jm.actor_params,
                                                key, feat0)
    latents = _draws(m, np.asarray(feats_next)[..., m.h_dim:])
    actions = torch.from_numpy(np.array(acts))
    t_total, t_a, t_c, t_rets, t_acts, draws = ta.behavior_loss(
        torch.from_numpy(feat0), torch.from_numpy(mask0),
        torch.tensor(ret_range), actions, latents)
    assert torch.equal(t_acts, actions) and torch.equal(draws, latents)
    for got, want, what in ((t_total, total, "total"), (t_a, l_a, "actor"),
                            (t_c, l_c, "critic"), (t_rets, rets, "rets")):
        _close(got, want, what=what)
    actor, critic = (list(m.actor.named_parameters()),
                     list(m.critic.named_parameters()))
    tdv3._backward(t_total, [p for _, p in actor + critic])
    want = convert.dreamerv3_params_from_jax(
        _np_tree(jm.params), _np_tree(grads["a"]), _np_tree(grads["c"]))
    _grads_close(actor, want["actor"], "actor")
    _grads_close(critic, want["critic"], "critic")


def test_one_update_of_every_net_matches_jax_given_its_draws(algos):
    """The whole update: the world model's Adam step, imagination on the
    stepped world model, the actor's and critic's Adam steps, the critic
    EMA and the return range, from JAX's draws under the keys its train
    step splits."""
    ja, ta, fns = algos
    jm, m = ja.module, ta.module
    batch = _batch(np.random.default_rng(10))
    rng = jax.random.PRNGKey(11)
    _, k_wm, k_im = jax.random.split(rng, 3)
    _, (feat, _) = fns["wm_loss"](jm.params, k_wm, _jnp(batch))
    copy = lambda t: jax.tree.map(jnp.copy, t)
    out = ja._train_step(copy(jm.params), copy(jm.actor_params),
                         copy(jm.critic_params), copy(ja.critic_ema),
                         copy(ja.wm_opt), copy(ja.actor_opt),
                         copy(ja.critic_opt), rng, batch, 1.0)
    wm_p, actor_p, critic_p, ema_p, *_, new_range, metrics = out
    feat0 = np.asarray(feat).reshape(-1, feat.shape[-1])
    _, acts, _, feats_next = fns["imagine"](wm_p, jm.actor_params, k_im,
                                            feat0)
    samples = tdv3.Samples(
        _draws(m, np.asarray(feat)[..., m.h_dim:]).transpose(0, 1),
        torch.from_numpy(np.array(acts)),
        _draws(m, np.asarray(feats_next)[..., m.h_dim:]))
    t_metrics, used = ta.train_step(batch, samples)
    assert all(torch.equal(a, b) for a, b in zip(used, samples))
    assert set(t_metrics) == set(metrics)
    for k in metrics:
        _close(t_metrics[k], metrics[k], what=k)
    _close(ta._ret_range, new_range)
    want = convert.dreamerv3_params_from_jax(
        _np_tree(wm_p), _np_tree(actor_p), _np_tree(critic_p))
    got = m.get_state()
    for part in want:
        for k in want[part]:
            _close(got[part][k], want[part][k], ADAM_RTOL, ADAM_ATOL,
                   f"{part} {k}")
    ema = convert.dreamerv3_params_from_jax(
        _np_tree(wm_p), _np_tree(actor_p), _np_tree(ema_p))["critic"]
    for k, v in get_state(ta.critic_ema).items():
        _close(v, ema[k], ADAM_RTOL, ADAM_ATOL, f"ema {k}")


def test_config_defaults_equal_the_reference():
    want = jrl.DreamerV3Config().to_dict()
    got = trl.DreamerV3Config().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


def test_build_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.DreamerV3Config().environment("CartPole-native").build()


def test_dreamerv3_collects_trains_and_evaluates_on_the_cpu():
    """Three small iterations: collection alone until 400 steps, then
    updates with finite losses; the state round trip and greedy
    evaluation leave the collector's latent alone."""
    algo = _config(trl.DreamerV3Config, env_steps_per_iteration=200,
                   train_steps_per_iteration=2).learners(
        num_gpus_per_learner=0).build()
    try:
        first = algo.train()
        assert first["buffer_steps"] <= 200 and "wm_loss" not in first
        algo.train()
        m = algo.train()
        for k in ("wm_loss", "recon_loss", "reward_loss", "kl_loss",
                  "actor_loss", "critic_loss", "return_range"):
            assert np.isfinite(m[k]), k
        assert m["num_env_steps_sampled_lifetime"] == 600
        state = algo.module.get_state()
        algo.module.set_state(state)
        again = algo.module.get_state()
        for part in state:
            for k in state[part]:
                np.testing.assert_array_equal(again[part][k], state[part][k])
        h = algo._h.clone()
        ev = algo.evaluate(episodes=2)["evaluation"]
        assert ev["num_episodes"] == 2
        assert torch.equal(algo._h, h)
    finally:
        algo.stop()


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_rllib_dreamerv3.py)
# ---------------------------------------------------------------------------

def test_symlog_roundtrip():
    x = torch.tensor([-100.0, -1.0, 0.0, 0.5, 10.0, 1e4])
    np.testing.assert_allclose(tdv3.symexp(tdv3.symlog(x)).numpy(),
                               x.numpy(), rtol=1e-4)
    _close(tdv3.symlog(x), jdv3.symlog(jnp.asarray(x.numpy())), 1e-6, 0)


def test_module_shapes_and_latent_sampling():
    cfg = trl.DreamerV3Config()
    m = tdv3.DreamerV3Module(obs_dim=4, num_actions=2, cfg=cfg, seed=0,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, cfg.latent_cats * cfg.latent_classes),
                         generator=gen)
    z, lg, _ = m.sample_latent(logits, gen)
    assert z.shape == (3, cfg.latent_cats * cfg.latent_classes)
    # each categorical block is one-hot in the forward value
    blocks = z.detach().numpy().reshape(3, cfg.latent_cats,
                                        cfg.latent_classes)
    np.testing.assert_allclose(blocks.sum(-1), 1.0, atol=1e-5)
    assert lg.shape == (3, cfg.latent_cats, cfg.latent_classes)


@pytest.mark.slow  # the reference's learning-threshold case: slow lane
def test_dreamerv3_learns_cartpole():
    """The world model + imagination-trained actor must clearly beat a
    random policy (~20 return) within ~7k env steps — the
    sample-efficiency contract; the tuned example holds the full
    100-return bar on a longer budget."""
    cfg = (trl.DreamerV3Config().environment("CartPole-native")
           .learners(num_gpus_per_learner=0).debugging(seed=0))
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(35):
            r = algo.train().get("episode_return_mean")
            if r is not None:
                best = max(best, r)
        assert best > 40.0, best
        # state roundtrip: params restore exactly
        state = algo.module.get_state()
        algo.module.set_state(state)
        ev = algo.evaluate(episodes=2)["evaluation"]
        assert ev["num_episodes"] == 2
    finally:
        algo.stop()
