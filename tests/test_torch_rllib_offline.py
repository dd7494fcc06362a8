"""The port's offline RL (BC, MARWIL, CQL and the JSON reader/writer) on
the CPU, held against the JAX package's ``ray_tpu.rllib.offline``.

The same numpy batches, made from a seed, go through the reference's and
the port's learners; the port's module takes the reference's weights
through ``convert.rl_module_params_from_jax``. Tolerances: f32's rtol 1e-5
and atol 1e-6 on what the starting weights give; rtol 1e-4, atol 1e-5 once
Adam steps have moved the weights (their rounding piles up). Then the
reference's cases of ``tests/test_rllib.py::test_bc_clones_expert`` and
the MARWIL and CQL cases of ``tests/test_rllib_extra_algos.py``, through
``ray_tpu_torch.rllib`` with the learner on the CPU, at their seeds, bars
and marks. Beside the gated MARWIL climb on the port's recording, the
same climb on the reference's recording (made by the JAX package in a
fixture) runs ungated, and the PPO expert is held to the reference's on
shared action draws.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib import rl_module as jmodule
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import offline as toffline
from ray_tpu_torch.rllib import rl_module as tmodule

RTOL, ATOL = 1e-5, 1e-6
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny MLPs: a pool of intra-op threads per test process only contends
    for a loaded host's cores."""
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


def _pair(seed=0):
    jm = jmodule.RLModule((4,), 2, seed=seed)
    tm = tmodule.RLModule((4,), 2, seed=seed + 100, device="cpu")
    tm.set_state(convert.rl_module_params_from_jax(_np_tree(jm.params)))
    return jm, tm


def _transitions(rng, n):
    """Logged CartPole-shaped transitions with episode ends."""
    dones = rng.uniform(size=n) < 0.05
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": np.ones(n, np.float32),
            "dones": dones,
            "truncateds": np.zeros(n, bool),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32)}


def _configs(name, **training):
    jc = getattr(jrl, name)().training(**training)
    tc = getattr(trl, name)().training(**training).learners(
        num_gpus_per_learner=0)
    return jc, tc


# ---------------------------------------------------------------------------
# the JSON reader and writer
# ---------------------------------------------------------------------------

def test_json_written_by_the_port_reads_back_in_both(tmp_path):
    rng = np.random.default_rng(0)
    frags = [trl.SampleBatch(_transitions(rng, n)) for n in (5, 7)]
    path = toffline.write_json(frags, str(tmp_path / "sub" / "d.jsonl"))
    got = toffline.read_json_fragments(path)
    want = joffline.read_json_fragments(path)
    assert [f.count for f in got] == [f.count for f in want] == [5, 7]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert toffline.read_json(path).count == 12
    with pytest.raises(ValueError, match="no batches"):
        empty = tmp_path / "empty.jsonl"
        empty.write_text("\n")
        toffline.read_json_fragments(str(empty))


# ---------------------------------------------------------------------------
# learners against the JAX package
# ---------------------------------------------------------------------------

def test_bc_update_matches_jax():
    """Two updates of 2 epochs over 256 rows in minibatches of 64 (16 Adam
    steps), behind the global-norm clip of 0.5."""
    jc, tc = _configs("BCConfig", num_epochs=2, minibatch_size=64, lr=3e-3)
    jm, tm = _pair(seed=1)
    jl, tl = jrl.BCLearner(jm, jc), trl.BCLearner(tm, tc)
    rng = np.random.default_rng(2)
    for update in range(2):
        batch = _transitions(rng, 256)
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want) == {"bc_loss"}
        _close(got["bc_loss"], want["bc_loss"], ADAM_RTOL, ADAM_ATOL)
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 ADAM_RTOL, ADAM_ATOL)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_update_matches_jax(beta):
    """MARWIL's weighted cross-entropy and value regression over the
    returns-to-go of the logged rows; beta 0 is BC's weighting."""
    jc, tc = _configs("MARWILConfig", num_epochs=2, minibatch_size=64)
    jc.beta = tc.beta = beta
    jm, tm = _pair(seed=3)
    jl, tl = jrl.MARWILLearner(jm, jc), trl.MARWILLearner(tm, tc)
    rng = np.random.default_rng(4)
    for update in range(2):
        batch = _transitions(rng, 256)
        batch["returns"] = trl.sample_batch.returns_to_go(
            trl.SampleBatch(batch), 0.99)
        np.testing.assert_array_equal(
            batch["returns"],
            jrl.sample_batch.returns_to_go(jrl.SampleBatch(batch), 0.99))
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want) == {"total_loss", "policy_loss",
                                         "vf_loss"}
        for k in want:
            _close(got[k], want[k], ADAM_RTOL, ADAM_ATOL, k)
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 ADAM_RTOL, ADAM_ATOL)


def test_cql_update_and_target_sync_match_jax():
    """Three CQL updates with the target net synced after the second: the
    losses and weights track the reference's, the target follows the sync,
    and the checkpoint contract carries the target."""
    jc, tc = _configs("CQLConfig", lr=1e-3)
    jm, tm = _pair(seed=5)
    jl, tl = jrl.CQLLearner(jm, jc), trl.CQLLearner(tm, tc)
    rng = np.random.default_rng(6)
    for update in range(3):
        batch = _transitions(rng, 128)
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want) == {"total_loss", "td_loss", "cql_loss"}
        tol = (RTOL, ATOL) if update == 0 else (ADAM_RTOL, ADAM_ATOL)
        for k in want:
            _close(got[k], want[k], *tol, k)
        if update == 1:
            jl.sync_target()
            tl.sync_target()
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 ADAM_RTOL, ADAM_ATOL)
    target = tmodule.get_state(tl.target_net)
    _state_close(target, convert.rl_module_params_from_jax(
        _np_tree(jl.target_params)), ADAM_RTOL, ADAM_ATOL)
    # the target rides the optimizer state through a checkpoint
    state = tl.get_optimizer_state()
    tl.update(trl.SampleBatch(_transitions(rng, 128)))
    tl.sync_target()
    tl.set_optimizer_state(state)
    _state_close(tmodule.get_state(tl.target_net), target, 0, 0)
    tl.set_optimizer_state(None)
    _state_close(tmodule.get_state(tl.target_net), tm.get_state(), 0, 0)


@pytest.mark.parametrize("name", ["BCConfig", "MARWILConfig", "CQLConfig"])
def test_config_defaults_equal_the_reference(name):
    want = getattr(jrl, name)().to_dict()
    got = getattr(trl, name)().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


@pytest.mark.parametrize("name", ["BCConfig", "MARWILConfig", "CQLConfig"])
def test_build_raises_without_a_card_unless_the_cpu_is_asked(name,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        getattr(trl, name)().offline_data(input_="unused.jsonl").build()


# ---------------------------------------------------------------------------
# the reference's cases, through the port's runtime
# ---------------------------------------------------------------------------

_stochastic_learning = pytest.mark.skipif(
    os.environ.get("RAY_TPU_TORCH_RUN_STOCHASTIC_LEARNING") != "1",
    reason="the reference gates this learning climb behind "
           "RAY_TPU_RUN_STOCHASTIC_LEARNING; the port behind "
           "RAY_TPU_TORCH_RUN_STOCHASTIC_LEARNING",
)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _cpu(config):
    return config.learners(num_gpus_per_learner=0)


@pytest.fixture(scope="module")
def expert_dataset(cluster, tmp_path_factory):
    """A briefly-trained PPO expert's CartPole rollouts (the reference's
    fixture, with the learner on the CPU)."""
    from ray_tpu_torch.rllib import PPOConfig

    expert = _cpu(
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=512)
        .training(num_epochs=6, minibatch_size=128)
        .debugging(seed=0)
    ).build()
    for _ in range(8):
        expert.train()
    recorded = ray_tpu_torch.get(
        [expert.runners[0].sample.remote(512) for _ in range(2)],
        timeout=300,
    )
    path = toffline.write_json(
        recorded, str(tmp_path_factory.mktemp("offline") / "expert.jsonl"))
    expert.stop()
    return path


def test_bc_clones_expert(cluster, tmp_path):
    """Behavior cloning: train PPO briefly as the 'expert', record its
    rollouts, clone from the recording, and verify the clone outperforms
    a random policy (the reference's case)."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.offline import BCConfig, read_json, write_json

    expert = _cpu(
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=512)
        .training(num_epochs=6, minibatch_size=128)
    ).build()
    for _ in range(8):
        expert.train()
    batches = [expert.runners[0].sample.remote(512) for _ in range(2)]
    recorded = ray_tpu_torch.get(batches, timeout=300)
    path = write_json(recorded, str(tmp_path / "expert.jsonl"))
    expert.stop()
    assert read_json(path).count == 1024

    bc = _cpu(
        BCConfig()
        .environment("CartPole-native")
        .offline_data(input_=path)
        .training(num_epochs=20, minibatch_size=256, lr=3e-3)
    ).build()
    result = bc.train()
    assert np.isfinite(result["bc_loss"])
    score = bc.evaluate()["evaluation"]["episode_return_mean"]
    bc.stop()
    # random CartPole policy scores ~20; a clone of a trained expert
    # should be clearly better
    assert score > 50, score


def test_bc_reads_a_dataset_of_obs_and_actions(cluster, expert_dataset):
    """The ``Dataset`` input: rows of ``obs`` and ``actions`` from the
    port's Data, one fragment, f32 observations and int32 actions."""
    from ray_tpu_torch import data

    recorded = toffline.read_json(expert_dataset)
    rows = [{"obs": o, "actions": int(a)} for o, a in
            zip(recorded["obs"], recorded["actions"])]
    algo = _cpu(
        trl.BCConfig().environment("CartPole-native")
        .offline_data(input_=data.from_items(rows))
        .training(num_epochs=2, minibatch_size=256)
    ).build()
    try:
        assert algo._dataset["obs"].dtype == np.float32
        assert algo._dataset["actions"].dtype == np.int32
        np.testing.assert_array_equal(algo._dataset["obs"],
                                      recorded["obs"].astype(np.float32))
        np.testing.assert_array_equal(algo._dataset["actions"],
                                      recorded["actions"])
        assert len(algo._fragments) == 1
        assert np.isfinite(algo.train()["bc_loss"])
    finally:
        algo.stop()


@pytest.fixture(scope="module")
def reference_expert_dataset(tmp_path_factory):
    """The reference's own fixture (``tests/test_rllib_extra_algos.py``):
    its PPO expert, trained and recorded by the JAX package on a reference
    cluster beside the port's."""
    import ray_tpu
    from ray_tpu.rllib import PPOConfig

    ray_tpu.init(num_cpus=2)
    try:
        expert = (
            PPOConfig()
            .environment("CartPole-native")
            .env_runners(num_env_runners=1, rollout_fragment_length=512)
            .training(num_epochs=6, minibatch_size=128)
            .build()
        )
        for _ in range(8):
            expert.train()
        recorded = ray_tpu.get(
            [expert.runners[0].sample.remote(512) for _ in range(2)],
            timeout=300,
        )
        path = joffline.write_json(
            recorded,
            str(tmp_path_factory.mktemp("offline_ref") / "expert.jsonl"))
        expert.stop()
    finally:
        ray_tpu.shutdown()
    return path


@_stochastic_learning
def test_marwil_beats_random(cluster, expert_dataset):
    """Gated as the reference gates its CQL climb: whether the greedy
    evaluation clears 50 depends on which expert the seed's PPO run
    recorded; on this one the MARWIL climb, like the CQL one, can land
    below its bar."""
    algo = _cpu(
        trl.MARWILConfig()
        .environment("CartPole-native")
        .offline_data(input_=expert_dataset)
        .training(num_epochs=20, minibatch_size=256, lr=3e-3)
    ).build()
    for _ in range(3):
        m = algo.train()
    assert np.isfinite(m["policy_loss"])
    score = algo.evaluate()["evaluation"]["episode_return_mean"]
    algo.stop()
    assert score > 50, score


def test_marwil_beats_random_on_the_reference_recording(
        cluster, reference_expert_dataset):
    """The reference's case, ungated, on the recording that the reference's
    own case learns from: the port's MARWIL and evaluation clear the same
    bar of 50 on the same data."""
    algo = _cpu(
        trl.MARWILConfig()
        .environment("CartPole-native")
        .offline_data(input_=reference_expert_dataset)
        .training(num_epochs=20, minibatch_size=256, lr=3e-3)
    ).build()
    for _ in range(3):
        m = algo.train()
    assert np.isfinite(m["policy_loss"])
    score = algo.evaluate()["evaluation"]["episode_return_mean"]
    algo.stop()
    assert score > 50, score


def test_ppo_expert_tracks_the_reference_on_shared_draws():
    """The expert fixtures' PPO (``tests/torch_rl_seeds.py``) through both
    packages from the reference's starting weights, every exploration
    action taken from one numpy stream: the first two training fragments,
    sampled before and after one whole PPO update (24 Adam steps), hold the
    same 512 actions each in both packages. A difference in the runner,
    GAE, the loss, the clip, Adam or the weight sync would move the
    policy's probabilities far more than the ~1e-6 that f32 rounding does,
    and flip actions. (Later fragments part: once a sample's ratio lies
    within the rounding of the PPO clip's bound, one package clips it and
    the other does not; ``tests/torch_rl_seeds.py --drift 0`` shows
    where.)"""
    from tests import torch_rl_seeds

    want = torch_rl_seeds.expert("ref", 0, shared_draws=True, iterations=2)
    got = torch_rl_seeds.expert("port", 0, shared_draws=True, iterations=2)
    assert got["actions"] == want["actions"]
    assert got["iter_dones"] == want["iter_dones"] == [28, 21]


def test_marwil_beta_zero_is_bc(cluster, expert_dataset):
    """beta=0 must reduce MARWIL's policy loss to plain BC (uniform
    weights) — the documented contract of the beta knob."""
    cfg = _cpu(
        trl.MARWILConfig()
        .environment("CartPole-native")
        .offline_data(input_=expert_dataset)
        .training(num_epochs=1, minibatch_size=256)
    )
    cfg.beta = 0.0
    algo = cfg.build()
    m = algo.train()
    algo.stop()
    assert np.isfinite(m["policy_loss"])


@_stochastic_learning
def test_cql_beats_random(cluster, expert_dataset):
    algo = _cpu(
        trl.CQLConfig()
        .environment("CartPole-native")
        .offline_data(input_=expert_dataset)
    ).build()
    for _ in range(6):
        m = algo.train()
    assert np.isfinite(m["td_loss"])
    score = algo.evaluate()["evaluation"]["episode_return_mean"]
    algo.stop()
    assert score > 50, score


@pytest.mark.slow
def test_cql_regularizer_lowers_unseen_q(cluster, expert_dataset):
    """The CQL term must push logsumexp(Q) toward the logged action's Q —
    with alpha>0 the gap shrinks vs alpha=0 over the same updates."""
    gaps = {}
    for alpha in (0.0, 2.0):
        cfg = _cpu(
            trl.CQLConfig()
            .environment("CartPole-native")
            .offline_data(input_=expert_dataset)
        )
        cfg.cql_alpha = alpha
        cfg.num_epochs = 30
        algo = cfg.build()
        for _ in range(3):
            m = algo.train()
        gaps[alpha] = m["cql_loss"]
        algo.stop()
    assert gaps[2.0] < gaps[0.0], gaps


def test_cql_trains_one_iteration_with_target_syncs(cluster, expert_dataset):
    """One CQL iteration (50 minibatches, a target sync every 20): finite
    losses, the timesteps counted, the target equal to the weights as of
    the last sync (update 40), not the current ones."""
    algo = _cpu(
        trl.CQLConfig().environment("CartPole-native")
        .offline_data(input_=expert_dataset)
    ).build()
    try:
        m = algo.train()
        assert all(np.isfinite(v) for v in m.values()
                   if isinstance(v, float))
        assert algo._timesteps == 50 * 256
        assert algo._since_target_sync == 10
        target = tmodule.get_state(algo.learner.target_net)
        weights = algo.learner.get_weights()
        assert any(not np.array_equal(target[k], weights[k])
                   for k in weights)
    finally:
        algo.stop()
