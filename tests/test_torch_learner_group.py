"""The port's counterpart of ``tests/test_learner_group.py`` (4 cases, all
slow as in the reference), through ``ray_tpu_torch.rllib`` with the
reference's expected values: every case is carried under its own name, on
``port_regular`` where the reference takes ``ray_start_regular``.

Two translations. The port's learner defaults to a card
(``num_gpus_per_learner=1``, ROADMAP queue 3, difference 13), so these CPU
cases ask for ``num_gpus_per_learner=0``. The reference compares
``jax.tree.leaves`` of the replicas' parameters; the port's weights are
``{state-dict name: numpy}``, compared name by name at the reference's
``atol=1e-6``.

The reference's description:

LearnerGroup (multi-learner DDP) tests.

Analog of ray: rllib/core/learner/tests/test_learner_group.py — N learner
actors shard the batch, gradients mean-allreduce in lockstep, replicas
stay bit-identical, and multi-learner training matches single-learner
learning on CartPole.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig

from tests.torch_fixtures import port_regular  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny MLPs: a pool of intra-op threads per test process only contends
    for a loaded host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_weights(a, b):
    assert sorted(a) == sorted(b) and a
    for name in a:
        np.testing.assert_allclose(np.asarray(a[name]), np.asarray(b[name]),
                                   atol=1e-6, err_msg=name)


@pytest.mark.slow
def test_replicas_stay_in_sync(port_regular):
    """After updates, every learner replica holds identical params (they
    all applied the same averaged gradients from the same init)."""
    algo = (
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=128)
        .learners(num_learners=2, num_gpus_per_learner=0)
        .training(lr=5e-3, num_epochs=2, minibatch_size=64)
        .debugging(seed=0)
        .build()
    )
    algo.train()
    algo.train()
    from ray_tpu_torch.rllib.learner_group import LearnerGroup

    assert isinstance(algo.learner, LearnerGroup)
    w0, w1 = ray_tpu_torch.get(
        [w.get_weights.remote() for w in algo.learner.workers], timeout=60
    )
    _assert_same_weights(w0, w1)
    algo.stop()


@pytest.mark.slow
def test_ppo_two_learners_matches_single(port_regular):
    """CartPole learning with 2 DDP learners reaches the single-learner
    bar (the VERDICT's acceptance: multi-learner matches 1-learner)."""
    algo = (
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=256)
        .learners(num_learners=2, num_gpus_per_learner=0)
        .training(lr=5e-3, num_epochs=6, minibatch_size=128)
        .debugging(seed=0)
        .build()
    )
    best = 0.0
    for _ in range(25):
        result = algo.train()
        best = max(best, result.get("episode_return_mean", 0.0))
        if best >= 120:
            break
    algo.stop()
    assert best >= 100, f"2-learner PPO failed to learn CartPole (best={best})"


@pytest.mark.slow
def test_impala_two_learners_improves(port_regular):
    algo = (
        IMPALAConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=2, rollout_fragment_length=256)
        .learners(num_learners=2, num_gpus_per_learner=0)
        .debugging(seed=0)
        .build()
    )
    first, best = None, 0.0
    for _ in range(30):
        result = algo.train()
        r = result.get("episode_return_mean")
        if r is not None:
            first = first if first is not None else r
            best = max(best, r)
    algo.stop()
    assert best > first + 10, (first, best)


@pytest.mark.slow
def test_checkpoint_roundtrip_with_group(port_regular):
    """save/load must round-trip through the group (weights + opt state
    fan out to every replica)."""
    algo = (
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=128)
        .learners(num_learners=2, num_gpus_per_learner=0)
        .training(num_epochs=2, minibatch_size=64)
        .debugging(seed=0)
        .build()
    )
    algo.train()
    ckpt = algo.save_checkpoint()
    w_before = algo.learner.get_weights()
    algo.train()  # drift past the checkpoint
    algo.load_checkpoint(ckpt)
    w_after = algo.learner.get_weights()
    _assert_same_weights(w_before, w_after)
    algo.stop()
