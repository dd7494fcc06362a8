"""The port's R2D2 on the CPU, held against the JAX package's
``ray_tpu.rllib.r2d2``.

The reference's torso, ``OptimizedLSTMCell`` and Q head cross through
``convert.r2d2_params_from_jax`` (the cell's eight kernels become one
product of ``[x, h]``); the same numpy sequences, made from a seed, go
through both. Tolerances: f32's rtol 1e-5, atol 1e-6 on what the starting
weights give (Q values and the (c, h) carry); rtol 1e-4, atol 1e-5 once
Adam steps have moved the weights. Then the reference's cases of
``tests/test_rllib_r2d2.py`` at their seeds, bars and marks, with the
learner on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import r2d2 as jr2d2
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import r2d2 as tr2d2
from ray_tpu_torch.rllib.r2d2 import (
    MemoryChainEnv,
    R2D2Module,
    SequenceReplayBuffer,
)
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


def _pair(obs_dim=3, num_actions=2, hidden=16, seed=0):
    jm = jr2d2.R2D2Module(obs_dim, num_actions, hidden=hidden, seed=seed)
    tm = R2D2Module(obs_dim, num_actions, hidden=hidden, seed=seed + 5,
                    device="cpu")
    tm.set_state(convert.r2d2_params_from_jax(_np_tree(jm.params)))
    return jm, tm


def _sequences(rng, B, L, obs_dim=3, num_actions=2):
    n = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None] < n[:, None]).astype(np.float32)
    dones = np.ones((B, L), bool)
    dones[mask > 0] = rng.uniform(size=int(mask.sum())) < 0.2
    return {"obs": rng.normal(size=(B, L + 1, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, (B, L)).astype(np.int32),
            "rewards": (rng.normal(size=(B, L)) * mask).astype(np.float32),
            "dones": dones, "mask": mask}


# ---------------------------------------------------------------------------
# the net and the learner against the JAX package
# ---------------------------------------------------------------------------

def test_bridge_covers_every_parameter():
    jm, tm = _pair()
    sd = convert.r2d2_params_from_jax(_np_tree(jm.params))
    assert set(sd) == set(tm.net.state_dict())
    for k, v in tm.net.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_lstm_over_a_sequence_matches_jax():
    """From a nonzero carry over 6 steps: every Q value and the final
    (c, h)."""
    jm, tm = _pair(seed=1)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(4, 6, 3)).astype(np.float32)
    c0, h0 = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    (jc, jh), jq = jm.seq_q(jm.params, (jnp.asarray(c0), jnp.asarray(h0)),
                            obs)
    (c, h), q = tm.seq_q((torch.from_numpy(c0), torch.from_numpy(h0)), obs)
    _close(q, jq)
    _close(c, jc)
    _close(h, jh)


def test_lstm_one_step_with_the_carry_matches_jax():
    jm, tm = _pair(seed=3)
    rng = np.random.default_rng(4)
    jcarry, carry = jm.initial_state(), tm.initial_state()
    for t in range(4):
        obs = rng.normal(size=(1, 3)).astype(np.float32)
        jcarry, jq = jm.step_q(jm.params, jcarry, obs)
        carry, q = tm.step_q(carry, obs)
        _close(q, jq, what=f"step {t}")
        _close(carry[0], jcarry[0])
        _close(carry[1], jcarry[1])


@pytest.mark.parametrize("burn_in", [0, 2])
def test_r2d2_learner_update_and_target_sync_match_jax(burn_in):
    """Four sequence-TD updates (double-Q per step, masked loss, the
    global-norm clip, Adam) with the target synced after the second; the
    burn-in prefix leaves the loss."""
    cfg = dict(lr=2e-3, burn_in=burn_in)
    jm, tm = _pair(seed=5)
    jl = jr2d2.R2D2Learner(jm, jr2d2.R2D2Config().training(**cfg))
    tl = tr2d2.R2D2Learner(tm, trl.R2D2Config().training(**cfg).learners(
        num_gpus_per_learner=0))
    rng = np.random.default_rng(6)
    for update in range(4):
        mb = _sequences(rng, 16, 5)
        want, got = jl.update(mb), tl.update(mb)
        assert set(got) == set(want) == {"loss", "mean_td_error"}
        tol = (RTOL, ATOL) if update == 0 else (ADAM_RTOL, ADAM_ATOL)
        for k in want:
            _close(got[k], want[k], *tol, k)
        if update == 1:
            jl.sync_target()
            tl.sync_target()
    _state_close(tm.get_state(),
                 convert.r2d2_params_from_jax(_np_tree(jm.params)),
                 ADAM_RTOL, ADAM_ATOL)
    target = get_state(tl.target_net)
    _state_close(target, convert.r2d2_params_from_jax(
        _np_tree(jl.target_params)), ADAM_RTOL, ADAM_ATOL)
    state = tl.get_optimizer_state()
    tl.update(_sequences(rng, 16, 5))
    tl.sync_target()
    tl.set_optimizer_state(state)
    _state_close(get_state(tl.target_net), target, 0, 0)


def test_runner_samples_what_the_reference_samples():
    """Greedy (epsilon 0) episodes from the same weights and seeds: the
    same padded sequences, returns and evaluation."""
    mk = {"hidden": 8, "seed": 7}
    jrun = jr2d2.R2D2EnvRunner("MemoryChain", {"length": 3}, dict(mk), 4,
                               seed=7)
    trun = tr2d2.R2D2EnvRunner("MemoryChain", {"length": 3}, dict(mk), 4,
                               seed=7)
    trun.set_weights(convert.r2d2_params_from_jax(
        _np_tree(jrun.module.params)))
    got, want = trun.sample(5, 0.0), jrun.sample(5, 0.0)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert trun.get_metrics() == jrun.get_metrics()
    assert trun.evaluate(6) == jrun.evaluate(6)
    seqs = trun.sample(8, 1.0)
    assert {int(a) for s in seqs for a in s["actions"][s["mask"] > 0]} == \
        {0, 1}


def test_sequence_buffer_samples_what_the_reference_samples():
    bufs = [SequenceReplayBuffer(capacity=4, seed=3),
            jr2d2.SequenceReplayBuffer(capacity=4, seed=3)]
    for buf in bufs:
        for i in range(6):
            buf.add({"x": np.full(3, i, np.float32)})
    a, b = (buf.sample(7) for buf in bufs)
    np.testing.assert_array_equal(a["x"], b["x"])


def test_config_defaults_equal_the_reference():
    want = jr2d2.R2D2Config().to_dict()
    got = tr2d2.R2D2Config().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


def test_build_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.R2D2Config().environment("MemoryChain").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R2D2Module(3, 2)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_rllib_r2d2.py)
# ---------------------------------------------------------------------------

def test_memory_env_semantics():
    env = MemoryChainEnv({"length": 3, "seed": 0})
    obs, _ = env.reset(seed=5)
    cue = int(obs[1])
    assert obs[0] == 1.0  # cue marker set only at t=0
    obs, r, done, _, _ = env.step(0)
    assert obs[0] == 0.0 and r == 0.0 and not done
    env.step(0)
    _, r, done, _, _ = env.step(cue)
    assert done and r == 1.0


def test_memory_env_matches_the_reference():
    envs = [MemoryChainEnv({"length": 4, "seed": 1}),
            jr2d2.MemoryChainEnv({"length": 4, "seed": 1})]
    outs = []
    for env in envs:
        trace = [env.reset()[0].tolist()]
        for a in (0, 1, 1, 0):
            o, r, d, t, _ = env.step(a)
            trace.append((o.tolist(), r, d, t))
        trace.append(env.reset(seed=9)[0].tolist())
        outs.append(trace)
    assert outs[0] == outs[1]


def test_lstm_carries_state():
    m = R2D2Module(obs_dim=3, num_actions=2, hidden=16, seed=0,
                   device="cpu")
    obs = np.random.default_rng(0).normal(size=(1, 3)).astype(np.float32)
    c0 = m.initial_state()
    c1, q1 = m.step_q(c0, obs)
    c2, q2 = m.step_q(c1, obs)
    # same observation, different hidden state -> different Q
    assert not np.allclose(q1.numpy(), q2.numpy())
    # stepwise unroll == sequence unroll
    seq = np.repeat(obs[:, None, :], 2, axis=1)
    _, q_seq = m.seq_q(c0, seq)
    np.testing.assert_allclose(q_seq.numpy()[0, 0], q1.numpy()[0],
                               rtol=1e-5)
    np.testing.assert_allclose(q_seq.numpy()[0, 1], q2.numpy()[0],
                               rtol=1e-5)


def test_sequence_buffer_roundtrip():
    buf = SequenceReplayBuffer(capacity=4, seed=0)
    for i in range(6):  # overfill: ring wraps
        buf.add({"x": np.full(3, i, np.float32)})
    assert len(buf) == 4
    mb = buf.sample(8)
    assert mb["x"].shape == (8, 3)
    assert set(np.unique(mb["x"])) <= {2.0, 3.0, 4.0, 5.0}


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_r2d2_trains_through_the_runtime(cluster):
    """Three iterations through a CPU runner actor: sequences fill the
    buffer, the learner steps once it holds enough, evaluation runs."""
    algo = (
        trl.R2D2Config()
        .environment("MemoryChain", env_config={"length": 4})
        .env_runners(num_env_runners=1)
        .training(episodes_per_iteration=16, seq_len=4,
                  min_sequences_before_learning=32, num_epochs=2)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
    ).build()
    try:
        first = algo.train()
        assert "loss" not in first and first["buffer_size"] == 16
        m = algo.train()
        assert m["buffer_size"] == 32 and np.isfinite(m["loss"])
        assert algo._timesteps == 32 * 4
        score = algo.evaluate()["evaluation/episode_return_mean"]
        assert 0.0 <= score <= 1.0
    finally:
        algo.stop()


@pytest.mark.slow
def test_r2d2_solves_memory_task(cluster):
    cfg = (
        trl.R2D2Config()
        .environment("MemoryChain", env_config={"length": 4})
        .env_runners(num_env_runners=1)
        .training(lr=2e-3, minibatch_size=32, num_epochs=8,
                  episodes_per_iteration=32, seq_len=4,
                  min_sequences_before_learning=64,
                  epsilon=(1.0, 0.05, 1_500))
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        best = 0.0
        for _ in range(30):
            algo.train()
            score = algo.evaluate()["evaluation/episode_return_mean"]
            best = max(best, score)
            if best >= 0.95:
                break
        # memoryless chance is 0.5; require decisively-above-chance recall
        assert best >= 0.95, best
    finally:
        algo.stop()
