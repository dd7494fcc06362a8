"""The port's QMIX on the CPU, held against the JAX package's
``ray_tpu.rllib.qmix``.

The reference's agent-net and mixer weights cross through
``convert.qmix_params_from_jax``; the same numpy batches, made from a
seed, go through both learners. Tolerances: f32's rtol 1e-5, atol 1e-6 on
what the starting weights give; rtol 1e-4, atol 1e-5 once Adam steps have
moved the weights. Then the reference's cases of
``tests/test_rllib_qmix.py`` at their seeds, bars and marks, with the
learner on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import qmix as jqmix
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import qmix as tqmix
from ray_tpu_torch.rllib.rl_module import get_state

RTOL, ATOL = 1e-5, 1e-6
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-5


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


def _state_close(port_state, want_sd, rtol=RTOL, atol=ATOL):
    assert set(port_state) == set(want_sd)
    for k in want_sd:
        _close(port_state[k], want_sd[k], rtol, atol, k)


KW = dict(obs_dim=3, n_agents=2, num_actions=2, state_dim=3)


def _pair(seed=0, **kw):
    kw = {**KW, **kw}
    jm = jqmix.QMixModule(seed=seed, **kw)
    tm = tqmix.QMixModule(seed=seed + 7, device="cpu", **kw)
    tm.set_state(convert.qmix_params_from_jax(_np_tree(jm.params)))
    return jm, tm


def _joint_batch(rng, n, n_agents=2, obs_dim=3, state_dim=3, num_actions=2):
    def obs_id():
        o = rng.normal(size=(n, n_agents, obs_dim)).astype(np.float32)
        ids = np.broadcast_to(np.eye(n_agents, dtype=np.float32),
                              (n, n_agents, n_agents))
        return np.concatenate([o, ids], -1)

    return {"obs": obs_id(), "next_obs": obs_id(),
            "state": rng.normal(size=(n, state_dim)).astype(np.float32),
            "next_state": rng.normal(size=(n, state_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, (n, n_agents)).astype(
                np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": rng.uniform(size=n) < 0.3}


# ---------------------------------------------------------------------------
# the nets and the learner against the JAX package
# ---------------------------------------------------------------------------

def test_bridge_covers_every_parameter():
    jm, tm = _pair()
    sd = convert.qmix_params_from_jax(_np_tree(jm.params))
    assert set(sd) == set(tm.net.state_dict())
    for k, v in tm.net.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("n_agents", [2, 3])
def test_agent_net_and_mixer_match_jax(n_agents):
    jm, tm = _pair(seed=1, n_agents=n_agents, state_dim=5)
    rng = np.random.default_rng(2)
    b = _joint_batch(rng, 16, n_agents=n_agents, state_dim=5)
    _close(tm.per_agent_q(b["obs"]), jm.per_agent_q(jm.params, b["obs"]))
    np.testing.assert_array_equal(tm.actions_greedy(b["obs"]),
                                  jm.actions_greedy(b["obs"]))
    qs = rng.normal(size=(16, n_agents)).astype(np.float32)
    want = jm.mixer.apply({"params": jm.params["mixer"]}, jnp.asarray(qs),
                          jnp.asarray(b["state"]))
    _close(tm.mixer(torch.from_numpy(qs), torch.from_numpy(b["state"])),
           want)


def test_mixer_monotonic_in_agent_qs():
    m = tqmix.QMixModule(seed=0, device="cpu", **KW)
    state = torch.eye(3)[:1]
    base = torch.tensor([[1.0, 1.0]])
    with torch.no_grad():
        q0 = m.mixer(base, state)
        for i in range(2):
            bumped = base.clone()
            bumped[0, i] += 1.0
            qi = m.mixer(bumped, state)
            assert float(qi[0]) >= float(q0[0]) - 1e-6  # dQtot/dq_a >= 0


def test_qmix_learner_update_and_target_sync_match_jax():
    """Four updates (double-Q at the team level, the global-norm clip of
    0.5, Adam) with the targets synced after the second; then the
    checkpoint contract: the target rides the optimizer state."""
    cfg = dict(lr=5e-3)
    jm, tm = _pair(seed=3)
    jl = jqmix.QMixLearner(jm, jqmix.QMIXConfig().training(**cfg))
    tl = tqmix.QMixLearner(tm, trl.QMIXConfig().training(**cfg).learners(
        num_gpus_per_learner=0))
    rng = np.random.default_rng(4)
    for update in range(4):
        batch = _joint_batch(rng, 64)
        want = jl.update(jqmix.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want) == {"loss", "mean_td_error"}
        tol = (RTOL, ATOL) if update == 0 else (ADAM_RTOL, ADAM_ATOL)
        for k in want:
            _close(got[k], want[k], *tol, k)
        if update == 1:
            jl.sync_target()
            tl.sync_target()
    _state_close(tm.get_state(),
                 convert.qmix_params_from_jax(_np_tree(jm.params)),
                 ADAM_RTOL, ADAM_ATOL)
    target = get_state(tl.target_net)
    _state_close(target, convert.qmix_params_from_jax(
        _np_tree(jl.target_params)), ADAM_RTOL, ADAM_ATOL)
    state = tl.get_optimizer_state()
    tl.update(trl.SampleBatch(_joint_batch(rng, 64)))
    tl.sync_target()
    tl.set_optimizer_state(state)
    _state_close(get_state(tl.target_net), target, 0, 0)


def test_runner_samples_what_the_reference_samples():
    """Greedy (epsilon 0) joint transitions from the same weights: the
    same obs stacks, states, actions, team rewards and dones, and the same
    episode returns; evaluation agrees too."""
    mk = {"hiddens": (16,), "embed_dim": 8, "seed": 5}
    jr = jqmix.QMixEnvRunner("TwoStepCoop", {}, dict(mk))
    tr = tqmix.QMixEnvRunner("TwoStepCoop", {}, dict(mk))
    tr.set_weights(convert.qmix_params_from_jax(
        _np_tree(jr.module.params)))
    got, want = tr.sample(9, 0.0), jr.sample(9, 0.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.get_metrics() == jr.get_metrics()
    assert tr.evaluate(3) == jr.evaluate(3)
    # exploration draws from the runner's torch.Generator: every action
    # valid, and a fully random policy visits both branches
    acts = tr.sample(64, 1.0)["actions"]
    assert set(np.unique(acts)) == {0, 1}


def test_two_step_game_payoffs():
    env = tqmix.TwoStepCoopGame({})
    obs, _ = env.reset()
    assert set(obs) == {"agent_0", "agent_1"}
    # branch B + joint (1,1) pays the optimum 8
    env.reset()
    env.step({"agent_0": 1, "agent_1": 0})
    _, rew, term, _, _ = env.step({"agent_0": 1, "agent_1": 1})
    assert rew["agent_0"] == 8.0 and term["__all__"]
    # branch A pays a flat 7
    env.reset()
    env.step({"agent_0": 0, "agent_1": 0})
    _, rew, _, _, _ = env.step({"agent_0": 0, "agent_1": 1})
    assert rew["agent_0"] == 7.0


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("second", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_two_step_game_matches_the_reference(first, second):
    envs = [tqmix.TwoStepCoopGame({}), jqmix.TwoStepCoopGame({})]
    outs = []
    for env in envs:
        obs, _ = env.reset()
        o1 = env.step({"agent_0": first, "agent_1": 1 - first})
        o2 = env.step({"agent_0": second[0], "agent_1": second[1]})
        outs.append((obs, o1, o2, env.state()))
    for a, b in zip(*outs):
        assert repr(a) == repr(b)


def test_config_defaults_equal_the_reference():
    want = jqmix.QMIXConfig().to_dict()
    got = tqmix.QMIXConfig().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


def test_build_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.QMIXConfig().environment("TwoStepCoop").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqmix.QMixModule(**KW)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_rllib_qmix.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_qmix_trains_and_acts_through_the_runtime(cluster):
    """Two iterations through a CPU runner actor: the buffer fills, the
    learner steps, and ``compute_actions`` answers for every agent (and
    refuses a partial observation)."""
    algo = (
        trl.QMIXConfig()
        .environment(tqmix.TwoStepCoopGame)
        .env_runners(num_env_runners=1, rollout_fragment_length=64)
        .training(num_steps_sampled_before_learning=64, num_epochs=2)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=3)
    ).build()
    try:
        algo.train()
        m = algo.train()
        assert m["buffer_size"] == 128 and np.isfinite(m["loss"])
        assert algo._timesteps == 128
        obs, _ = tqmix.TwoStepCoopGame({}).reset()
        acts = algo.compute_actions(obs)
        assert set(acts) == {"agent_0", "agent_1"}
        with pytest.raises(ValueError, match="every agent"):
            algo.compute_actions({"agent_0": obs["agent_0"]})
    finally:
        algo.stop()


@pytest.mark.slow
def test_qmix_solves_two_step_game(cluster):
    cfg = (
        trl.QMIXConfig()
        .environment(tqmix.TwoStepCoopGame)
        .env_runners(num_env_runners=1, rollout_fragment_length=64)
        .training(lr=5e-3, minibatch_size=64, num_epochs=8,
                  num_steps_sampled_before_learning=128,
                  target_network_update_freq=128)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=3)
    )
    algo = cfg.build()
    try:
        solved = False
        for _ in range(40):
            algo.train()
            # greedy rollout: must pick branch B then coordinate on (1,1)
            env = tqmix.TwoStepCoopGame({})
            obs, _ = env.reset()
            acts = algo.compute_actions(obs)
            obs, _, _, _, _ = env.step(acts)
            acts2 = algo.compute_actions(obs)
            _, rew, _, _, _ = env.step(acts2)
            if rew["agent_0"] == 8.0:
                solved = True
                break
        assert solved, "QMIX failed to find the coordinated optimum (8)"
    finally:
        algo.stop()
