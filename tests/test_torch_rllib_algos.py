"""The reference's RL cases, carried over to the port on the CPU.

The cases of ``tests/test_rllib.py`` (but ``test_bc_clones_expert``, which
``tests/test_torch_rllib_offline.py`` carries with the rest of offline RL)
and ``tests/test_rllib_rainbow.py`` run through
``ray_tpu_torch.rllib`` at the reference's seeds and bars, with the learner
on the CPU (``num_gpus_per_learner=0``). One port cluster serves the
module; the reference's slow marks are kept.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (
    CartPole,
    DQNConfig,
    IMPALAConfig,
    PPOConfig,
    PrioritizedReplayBuffer,
    ReplayBuffer,
    SampleBatch,
)
from ray_tpu_torch.rllib.replay_buffer import n_step_transform


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CPU learners here run tiny MLPs in this process: a pool of
    intra-op threads per test process only contends for a loaded host's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _cpu(config):
    return config.learners(num_gpus_per_learner=0)


# ---------------------------------------------------------------------------
# tests/test_rllib.py
# ---------------------------------------------------------------------------

def test_cartpole_env_contract():
    env = CartPole({"seed": 0})
    obs, info = env.reset(seed=0)
    assert obs.shape == (4,)
    obs, r, term, trunc, _ = env.step(1)
    assert r == 1.0 and not term and not trunc


def test_replay_buffers():
    rb = ReplayBuffer(capacity=8, seed=0)
    b = SampleBatch({"obs": np.arange(12, dtype=np.float32)})
    rb.add(b)
    assert len(rb) == 8  # wrapped
    s = rb.sample(4)
    assert s.count == 4

    prb = PrioritizedReplayBuffer(capacity=16, seed=0)
    prb.add(SampleBatch({"obs": np.arange(10, dtype=np.float32)}))
    s = prb.sample(5)
    assert "weights" in s and "batch_indexes" in s
    prb.update_priorities(s["batch_indexes"], np.full(5, 10.0))


def test_ppo_learns_cartpole(cluster):
    algo = _cpu(
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=256)
        .training(lr=5e-3, num_epochs=6, minibatch_size=128)
        .debugging(seed=0)
    ).build()
    best = 0.0
    for _ in range(25):
        result = algo.train()
        best = max(best, result.get("episode_return_mean", 0.0))
        if best >= 120:
            break
    algo.stop()
    assert best >= 100, f"PPO failed to learn CartPole (best={best})"


@pytest.mark.slow
def test_impala_improves(cluster):
    algo = _cpu(
        IMPALAConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=256)
        .debugging(seed=0)
    ).build()
    first, best = None, 0.0
    for _ in range(30):
        result = algo.train()
        r = result.get("episode_return_mean")
        if r is not None:
            first = first if first is not None else r
            best = max(best, r)
    algo.stop()
    assert best > first + 10, (first, best)


def test_dqn_runs_and_losses_finite(cluster):
    algo = _cpu(
        DQNConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=200)
        .training(minibatch_size=64,
                  num_steps_sampled_before_learning=200)
    ).build()
    losses = []
    for _ in range(5):
        result = algo.train()
        if "loss" in result:
            losses.append(result["loss"])
    algo.stop()
    assert losses and all(np.isfinite(l) for l in losses)


def test_algorithm_checkpoint_roundtrip(cluster):
    algo = _cpu(PPOConfig().environment("CartPole-native").env_runners(
        num_env_runners=1, rollout_fragment_length=64
    )).build()
    algo.train()
    ckpt = algo.save()
    w_before = algo.compute_single_action([0.1, 0.0, 0.02, 0.0])
    algo.stop()

    algo2 = _cpu(PPOConfig().environment("CartPole-native").env_runners(
        num_env_runners=1, rollout_fragment_length=64
    )).build()
    algo2.restore(ckpt)
    assert algo2.compute_single_action([0.1, 0.0, 0.02, 0.0]) == w_before
    # the Adam moments came back with the weights
    assert algo2.learner.optimizer.state_dict()["state"]
    algo2.stop()


@pytest.mark.slow
def test_tune_over_algorithm(cluster):
    """rllib Algorithms are Tune trainables (ray parity: Tuner("PPO"))."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPO

    grid = tune.Tuner(
        PPO,
        param_space={
            "env": "CartPole-native",
            "num_env_runners": 1,
            "rollout_fragment_length": 64,
            "num_gpus_per_learner": 0,
            "lr": tune.grid_search([5e-3, 1e-3]),
        },
        run_config=ray_tpu_torch.air.RunConfig(
            stop={"training_iteration": 2}),
        tune_config=tune.TuneConfig(metric="total_loss", mode="min"),
    ).fit()
    assert grid.num_errors == 0
    assert len(grid) == 2


def test_sac_improves(cluster):
    from ray_tpu_torch.rllib import SACConfig

    algo = _cpu(
        SACConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=200)
        .training(minibatch_size=128,
                  num_steps_sampled_before_learning=400,
                  num_epochs=8)
    ).build()
    first = None
    best = -1.0
    for _ in range(12):
        result = algo.train()
        r = result.get("episode_return_mean")
        if r is not None:
            if first is None:
                first = r
            best = max(best, r)
        if "q_loss" in result:
            assert np.isfinite(result["q_loss"])
            assert np.isfinite(result["alpha"])
    algo.stop()
    assert first is not None
    assert best > max(first, 25.0), (first, best)


@pytest.mark.slow  # the reference's slow lane
def test_multi_agent_ppo_two_policies(cluster):
    """Two policies over four agents: both improve on multi-agent
    CartPole; per-policy batches stay separate."""
    from ray_tpu_torch.rllib.multi_agent import (
        MultiAgentCartPole,
        MultiAgentPPO,
    )

    algo = MultiAgentPPO(
        MultiAgentCartPole,
        env_config={"num_agents": 4, "max_episode_steps": 200},
        policies=["even", "odd"],
        policy_mapping_fn=lambda aid: "even" if int(aid[-1]) % 2 == 0
        else "odd",
        num_env_runners=1,
        rollout_fragment_length=256,
        num_gpus_per_learner=0,
    )
    first = best = None
    for _ in range(10):
        m = algo.train()
        r = m.get("episode_return_mean")
        if r is not None:
            first = r if first is None else first
            best = r if best is None else max(best, r)
        for pid in ("even", "odd"):
            if pid in m:
                assert np.isfinite(m[pid]["total_loss"]), m
    algo.stop()
    assert first is not None and best is not None
    assert best > first, (first, best)
    w_even = algo.get_policy_state("even")
    w_odd = algo.get_policy_state("odd")
    assert [w.sum() for w in w_even.values()] != \
        [w.sum() for w in w_odd.values()]


@pytest.mark.slow
def test_appo_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import APPOConfig

    algo = _cpu(
        APPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=256)
        .debugging(seed=0)
    ).build()
    best = 0.0
    for _ in range(25):
        result = algo.train()
        best = max(best, result.get("episode_return_mean", 0.0))
        if best >= 120:
            break
    algo.stop()
    assert best >= 100, f"APPO failed to learn CartPole (best={best})"


@pytest.mark.slow
def test_runner_death_recovers(cluster):
    """Killing an env-runner actor mid-training is absorbed: the algorithm
    replaces it and keeps training (ray parity: FaultTolerantActorManager,
    rllib/utils/actor_manager.py:189)."""
    algo = _cpu(
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=64)
        .training(num_epochs=2)
        .debugging(seed=0)
    ).build()
    algo.train()
    victim = algo.runners[0]
    ray_tpu_torch.kill(victim)
    result = algo.train()  # must not raise; runner gets replaced
    assert result["num_env_steps_sampled_lifetime"] >= 2 * 2 * 64
    assert algo.runners[0] is not victim
    algo.stop()


# ---------------------------------------------------------------------------
# tests/test_rllib_rainbow.py
# ---------------------------------------------------------------------------

def _frag(rewards, dones, trunc=None):
    n = len(rewards)
    return SampleBatch({
        "obs": np.arange(n, dtype=np.float32)[:, None],
        "next_obs": np.arange(1, n + 1, dtype=np.float32)[:, None],
        "rewards": np.asarray(rewards, np.float32),
        "actions": np.zeros(n, np.int64),
        "dones": np.asarray(dones, bool),
        "truncateds": np.asarray(trunc if trunc is not None else [False] * n,
                                 bool),
    })


def test_n_step_accumulates_and_respects_done():
    b = _frag([1, 1, 1, 1, 1], [0, 0, 1, 0, 0])
    o = n_step_transform(b, 3, 0.9)
    assert o["rewards"][0] == pytest.approx(2.71)
    assert bool(o["dones"][0]) is True
    assert o["next_obs"][0, 0] == 3.0
    assert o["nstep_discount"][0] == pytest.approx(0.9 ** 3)
    assert o["rewards"][3] == pytest.approx(1.9)
    assert bool(o["dones"][3]) is False
    assert o["nstep_discount"][3] == pytest.approx(0.81)


def test_n_step_truncation_stops_window_but_bootstraps():
    b = _frag([1, 1, 1], [0, 0, 0], trunc=[0, 1, 0])
    o = n_step_transform(b, 3, 0.5)
    assert o["rewards"][0] == pytest.approx(1.5)
    assert bool(o["dones"][0]) is False
    assert o["next_obs"][0, 0] == 2.0


def test_n_step_1_is_identity():
    b = _frag([1, 2, 3], [0, 0, 1])
    o = n_step_transform(b, 1, 0.9)
    assert o is b


def test_per_priorities_shift_sampling():
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, beta=0.4, seed=0)
    buf.add(_frag([0.0] * 32, [False] * 32))
    buf.update_priorities(np.array([5]), np.array([1000.0]))
    batch = buf.sample(256)
    frac = float((batch["batch_indexes"] == 5).mean())
    assert frac > 0.5, frac
    w = batch["weights"][batch["batch_indexes"] == 5]
    assert w.max() <= 1.0 and w.min() < 0.2


def test_dueling_module_identity():
    from ray_tpu_torch.rllib.rl_module import RLModule

    m = RLModule((4,), 3, dueling=True, seed=0, device="cpu")
    obs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    q, v = m.forward(obs)
    assert q.shape == (8, 3) and v.shape == (8,)
    assert np.allclose(q.numpy().mean(-1), v.numpy(), atol=1e-5)


def test_rainbow_dqn_trains_one_iteration(cluster):
    cfg = _cpu(
        DQNConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=100)
        .training(
            minibatch_size=32,
            num_epochs=2,
            num_steps_sampled_before_learning=64,
            n_step=3,
            double_q=True,
            dueling=True,
            prioritized_replay=True,
        )
    )
    algo = cfg.build()
    try:
        for _ in range(3):
            metrics = algo.train()
        assert np.isfinite(metrics.get("loss", 0.0))
        assert algo.buffer._max_prio != 1.0
        a = algo.compute_single_action(np.zeros(4, np.float32))
        assert 0 <= int(a) < 2
        a = algo.compute_single_action(np.zeros(4, np.float32), explore=True)
        assert 0 <= int(a) < 2
    finally:
        algo.stop()
