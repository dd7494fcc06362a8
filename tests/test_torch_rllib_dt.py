"""The port's Decision Transformer on the CPU, held against the JAX
package's ``ray_tpu.rllib.dt``.

The reference's flax ``DTNet`` weights cross through
``convert.dt_params_from_jax``; the same numpy windows, made from a seed,
go through both. The port attends through ``ops.attention.flash_attention``
(on CPU tensors the kernels' plain versions), the reference through
``jax.nn.dot_product_attention``: logits agree at rtol 1e-5, atol 1e-5
(two attention implementations summing in other orders); after AdamW
steps, rtol 1e-4 and atol 1e-5. Then the reference's cases of
``tests/test_rllib_dt.py`` at their seeds, bars and marks.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import dt as jdt
from ray_tpu.rllib.offline import read_json_fragments as j_read_fragments
from ray_tpu_torch.models import convert
from ray_tpu_torch.ops import attention
from ray_tpu_torch.rllib import dt as tdt
from ray_tpu_torch.rllib.offline import read_json_fragments, write_json
from ray_tpu_torch.rllib.sample_batch import SampleBatch

RTOL, ATOL = 1e-5, 1e-5
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-5
SMALL = dict(d_model=32, n_layer=2, n_head=2, max_timestep=64)


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


def _pair(obs_dim=4, num_actions=2, context_len=4, seed=0, **kw):
    kw = {**SMALL, **kw}
    jm = jdt.DTModule(obs_dim, num_actions, context_len, seed=seed, **kw)
    tm = tdt.DTModule(obs_dim, num_actions, context_len, seed=seed + 9,
                      device="cpu", **kw)
    tm.set_state(convert.dt_params_from_jax(_np_tree(jm.params)))
    return jm, tm


def _windows(rng, B, K, obs_dim=4, num_actions=2, pad_action=False):
    n = rng.integers(1, K + 1, size=B)
    mask = (np.arange(K)[None] < n[:, None]).astype(np.float32)
    actions = rng.integers(0, num_actions, (B, K)).astype(np.int32)
    if pad_action:  # acting: the current step's slot holds the -1 pad
        actions[np.arange(B), n - 1] = -1
    return {"rtg": (rng.uniform(0, 50, (B, K)) * mask).astype(np.float32),
            "obs": (rng.normal(size=(B, K, obs_dim))
                    * mask[..., None]).astype(np.float32),
            "actions": (actions * mask).astype(np.int32) if not pad_action
            else actions,
            "timesteps": (rng.integers(0, 60, (B, K)) * mask).astype(
                np.int32),
            "mask": mask}


# ---------------------------------------------------------------------------
# the net and the learner against the JAX package
# ---------------------------------------------------------------------------

def test_bridge_covers_every_parameter():
    jm, tm = _pair()
    sd = convert.dt_params_from_jax(_np_tree(jm.params))
    assert set(sd) == set(tm.net.state_dict())
    for k, v in tm.net.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("pad_action", [False, True])
def test_dtnet_forward_matches_jax(pad_action):
    """Training windows (padded tails) and acting windows (the -1 pad in
    the current action slot, embedding row 0)."""
    jm, tm = _pair(seed=1)
    w = _windows(np.random.default_rng(2), 6, 4, pad_action=pad_action)
    args = [w[k] for k in ("rtg", "obs", "actions", "timesteps")]
    want = jm.forward(jm.params, *args)
    _close(tm.forward(*args), want)


def test_dtnet_attends_through_flash_attention(monkeypatch):
    """Each layer hands ``flash_attention`` (B, H, 3K, D) causal: one
    forward per layer in a forward pass, and one backward per layer in a
    training step's backward (the launches the card's kernels get)."""
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd

    def counted_fwd(q, k, v, causal=False, sm_scale=None, k_len=None):
        calls["fwd"].append((tuple(q.shape), causal, sm_scale))
        return fwd(q, k, v, causal, sm_scale, k_len)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention_fwd", counted_fwd)
    monkeypatch.setattr(attention, "flash_attention_bwd", counted_bwd)
    _, tm = _pair(context_len=8, **dict(SMALL, d_model=64))
    w = _windows(np.random.default_rng(3), 5, 8)
    tm.forward(*(w[k] for k in ("rtg", "obs", "actions", "timesteps")))
    assert calls["fwd"] == [((10, 24, 32), True, 32 ** -0.5)] * 2
    cfg = trl.DTConfig().training(lr=1e-3).learners(num_gpus_per_learner=0)
    calls["fwd"].clear()
    tdt.DTLearner(tm, cfg).update(w)
    assert len(calls["fwd"]) == 2 and calls["bwd"] == 2


def test_dt_learner_update_matches_jax():
    """Three AdamW steps (weight decay 1e-4 on every parameter) on masked
    windows: loss, action accuracy and every weight."""
    jm, tm = _pair(seed=4)
    cfg = {"lr": 3e-3}
    jl = jdt.DTLearner(jm, jdt.DTConfig().training(**cfg))
    tl = tdt.DTLearner(tm, trl.DTConfig().training(**cfg).learners(
        num_gpus_per_learner=0))
    rng = np.random.default_rng(5)
    for step in range(3):
        w = _windows(rng, 16, 4)
        want = jl.update(w)
        got = tl.update(w)
        assert set(got) == set(want) == {"loss", "action_accuracy"}
        tol = (RTOL, ATOL) if step == 0 else (ADAM_RTOL, ADAM_ATOL)
        _close(got["loss"], want["loss"], *tol)
        assert got["action_accuracy"] == pytest.approx(
            want["action_accuracy"])
    sd = convert.dt_params_from_jax(_np_tree(jm.params))
    d = SMALL["d_model"]
    for k, v in tm.get_state().items():
        if k.startswith("attn_qkv_") and k.endswith(".bias"):
            # the key bias adds q·b to every logit of a row: softmax does
            # not see it, its gradient is rounding noise,
            # and Adam turns noise into steps of up to lr in either
            # direction. Held apart: within 3 steps of lr (1 + wd) of the
            # reference's, the query and value biases as every weight.
            _close(v[d:2 * d], sd[k][d:2 * d], 0, 3 * 3e-3 * (1 + 1e-4), k)
            v, want = np.delete(v, np.s_[d:2 * d]), np.delete(
                sd[k].numpy(), np.s_[d:2 * d])
            _close(v, want, ADAM_RTOL, ADAM_ATOL, k)
        else:
            _close(v, sd[k], ADAM_RTOL, ADAM_ATOL, k)


# ---------------------------------------------------------------------------
# episodes, acting
# ---------------------------------------------------------------------------

def _chain_dataset(path, n_episodes=200, seed=0):
    """2-step chain env: obs = one-hot step index, reward = action (0/1).
    A uniform-random behavior policy yields returns in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    frags = []
    for _ in range(n_episodes):
        acts = rng.integers(0, 2, size=2)
        frags.append(SampleBatch({
            "obs": np.eye(2, dtype=np.float32),
            "actions": acts.astype(np.int64),
            "rewards": acts.astype(np.float32),
            "dones": np.array([False, True]),
            "truncateds": np.array([False, False]),
        }))
    return write_json(frags, path)


def test_episode_split_and_rtg(tmp_path):
    path = _chain_dataset(str(tmp_path / "data.json"), n_episodes=3)
    eps = tdt.episodes_from_fragments(read_json_fragments(path))
    assert len(eps) == 3
    for ep in eps:
        assert ep["obs"].shape == (2, 2)
        # chain dataset: reward == action, so rtg[0] is the action sum
        # and rtg[-1] is the final action's reward
        assert ep["rtg"][0] == pytest.approx(float(ep["actions"].sum()))
        assert ep["rtg"][1] == pytest.approx(float(ep["actions"][1]))


def test_episodes_from_fragments_matches_jax(tmp_path):
    """Fragments cut mid-episode (the tail dropped), a truncation, episodes
    across fragments: the same episodes, returns-to-go and timesteps."""
    rng = np.random.default_rng(6)
    frags = []
    for n in (9, 13, 4):
        frags.append(SampleBatch({
            "obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.integers(0, 3, n),
            "rewards": rng.uniform(0, 2, n).astype(np.float32),
            "dones": rng.uniform(size=n) < 0.3,
            "truncateds": rng.uniform(size=n) < 0.1,
        }))
    path = write_json(frags, str(tmp_path / "frags.jsonl"))
    got = tdt.episodes_from_fragments(read_json_fragments(path))
    want = jdt.episodes_from_fragments(j_read_fragments(path))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def _algo_pair(path, **training):
    jc = jdt.DTConfig().offline_data(input_=path).training(**training)
    tc = trl.DTConfig().offline_data(input_=path).training(
        **training).learners(num_gpus_per_learner=0)
    jc.model = tc.model = {"d_model": 32, "n_layer": 2, "n_head": 2}
    ja, ta = jc.build(), tc.build()
    ta.module.set_state(convert.dt_params_from_jax(
        _np_tree(ja.module.params)))
    return ja, ta


def test_rolling_context_acting_matches_jax(tmp_path):
    """``start_episode`` / ``compute_single_action`` / ``observe_reward``
    over 7 steps of a context of 3 (the window rolls past its start): the
    same actions from the same weights, and sampling windows that agree."""
    rng = np.random.default_rng(7)
    frags = [SampleBatch({
        "obs": rng.normal(size=(12, 2)).astype(np.float32),
        "actions": rng.integers(0, 3, 12),
        "rewards": np.ones(12, np.float32),
        "dones": np.arange(12) == 11,
    }) for _ in range(4)]
    path = write_json(frags, str(tmp_path / "d.jsonl"))
    ja, ta = _algo_pair(path, context_len=3, minibatch_size=8, num_epochs=1)
    try:
        for algo in (ja, ta):
            algo.start_episode(target_return=10.0)
        for t in range(7):
            obs = rng.normal(size=2).astype(np.float32)
            a = ta.compute_single_action(obs)
            assert a == ja.compute_single_action(obs), t
            r = float(rng.uniform())
            ta.observe_reward(r)
            ja.observe_reward(r)
        w_t, w_j = ta._sample_windows(8), ja._sample_windows(8)
        for k in w_j:
            np.testing.assert_array_equal(w_t[k], w_j[k])
        # one training iteration from the same weights and windows
        m_t, m_j = ta.train(), ja.train()
        _close(m_t["loss"], m_j["loss"])
        assert m_t["num_env_steps_sampled_lifetime"] == 8
    finally:
        ja.stop()
        ta.stop()


@pytest.mark.parametrize("name", ["DTConfig"])
def test_config_defaults_equal_the_reference(name):
    want = getattr(jdt, name)().to_dict()
    got = getattr(tdt, name)().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


def test_build_raises_without_a_card_unless_the_cpu_is_asked(tmp_path,
                                                              monkeypatch):
    path = _chain_dataset(str(tmp_path / "data.json"), n_episodes=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.DTConfig().offline_data(input_=path).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdt.DTModule(2, 2, 2)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_rllib_dt.py)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_dt_return_conditioning(tmp_path):
    path = _chain_dataset(str(tmp_path / "data.json"))
    cfg = (
        trl.DTConfig()
        .offline_data(input_=path)
        .training(lr=3e-3, minibatch_size=64, num_epochs=25, context_len=2)
        .learners(num_gpus_per_learner=0)
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        for _ in range(8):
            m = algo.train()
        assert m["action_accuracy"] > 0.9, m
        # conditioned on return 2 -> take action 1 at both steps
        algo.start_episode(target_return=2.0)
        a0 = algo.compute_single_action(np.array([1.0, 0.0], np.float32))
        algo.observe_reward(float(a0))
        a1 = algo.compute_single_action(np.array([0.0, 1.0], np.float32))
        assert (a0, a1) == (1, 1), (a0, a1)
        # conditioned on return 0 -> take action 0 at both steps
        algo.start_episode(target_return=0.0)
        b0 = algo.compute_single_action(np.array([1.0, 0.0], np.float32))
        algo.observe_reward(float(b0))
        b1 = algo.compute_single_action(np.array([0.0, 1.0], np.float32))
        assert (b0, b1) == (0, 0), (b0, b1)
    finally:
        algo.stop()


@pytest.fixture()
def cluster():
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_dt_checkpoint_roundtrip(tmp_path, cluster):
    path = _chain_dataset(str(tmp_path / "data.json"), n_episodes=20)
    cfg = (trl.DTConfig().offline_data(input_=path)
           .training(minibatch_size=16, num_epochs=2, context_len=2)
           .learners(num_gpus_per_learner=0))
    algo = cfg.build()
    try:
        algo.train()
        ck = algo.save()
        algo2 = cfg.build()
        algo2.restore(ck)
        w1 = algo.learner.get_weights()
        w2 = algo2.learner.get_weights()
        assert set(w1) == set(w2)
        for k in w1:
            np.testing.assert_allclose(w1[k], w2[k])
        # the AdamW moments came back too: the next step is the same
        mb = algo._sample_windows(16)
        assert algo.learner.update(mb) == algo2.learner.update(mb)
        algo2.stop()
    finally:
        algo.stop()
