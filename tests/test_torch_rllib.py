"""The port's RLlib core on the CPU, held against the JAX package's.

The same numpy inputs, made from a seed, go through ``ray_tpu.rllib`` and
``ray_tpu_torch.rllib``; the port's modules take the reference's weights
through the ``*_from_jax`` bridges of ``ray_tpu_torch/models/convert.py``.
Tolerances are f32's: rtol 1e-5 and atol 1e-6, except where several Adam
steps pile up rounding (rtol 1e-4 and atol 1e-5, said at the test). No
cluster: the learners, the env runners and the ES update run in-process.
Then the port's own seams: where the learner runs, and the import walk.
"""

import ast
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import learner as jlearner
from ray_tpu.rllib import rl_module as jmodule
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import learner as tlearner
from ray_tpu_torch.rllib import rl_module as tmodule

REPO = Path(__file__).resolve().parent.parent
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


def _discrete_pair(seed=0, dueling=False, hiddens=(64, 64), obs_dim=4,
                   num_actions=2):
    """(JAX RLModule, port RLModule on the CPU with its weights)."""
    jm = jmodule.RLModule((obs_dim,), num_actions, hiddens=hiddens,
                          seed=seed, dueling=dueling)
    tm = tmodule.RLModule((obs_dim,), num_actions, hiddens=hiddens,
                          seed=seed + 100, dueling=dueling, device="cpu")
    tm.set_state(convert.rl_module_params_from_jax(_np_tree(jm.params)))
    return jm, tm


def _obs(rng, n, dim=4):
    return rng.normal(size=(n, dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dueling", [False, True])
def test_rl_module_forward_matches_jax(dueling):
    jm, tm = _discrete_pair(seed=3, dueling=dueling)
    obs = _obs(np.random.default_rng(0), 32)
    want_logits, want_values = jm.forward(jm.params, obs)
    logits, values = tm.forward(obs)
    _close(logits, want_logits)
    _close(values, want_values)
    _close(tm.action_greedy(obs), jm.action_greedy(obs), 0, 0)
    if dueling:  # Q = V + A - mean(A)  =>  mean_a(Q) == V
        _close(logits.mean(-1), values, atol=1e-5)


def test_continuous_module_matches_jax():
    info = {"kind": "continuous", "dim": 2,
            "low": np.array([-1.0, -2.0], np.float32),
            "high": np.array([1.0, 0.5], np.float32)}
    jm = jmodule.ContinuousRLModule((3,), info, hiddens=(32, 32), seed=1)
    tm = tmodule.ContinuousRLModule((3,), info, hiddens=(32, 32), seed=9,
                                    device="cpu")
    tm.set_state(convert.continuous_module_params_from_jax(
        _np_tree(jm.params)))
    rng = np.random.default_rng(1)
    obs, act = _obs(rng, 16, 3), rng.uniform(-1, 1, (16, 2)).astype(
        np.float32)
    _close(tm.action_greedy(obs), jm.action_greedy(obs))
    for q in ("q1", "q2"):
        want = jm.critic.apply({"params": jm.params[q]}, obs, act)
        _close(getattr(tm, q)(torch.from_numpy(obs), torch.from_numpy(act)),
               want)
    a = tm.action_exploration(obs, torch.Generator().manual_seed(0), 0.5)
    assert a.shape == (16, 2)
    assert (a >= info["low"]).all() and (a <= info["high"]).all()


def test_action_exploration_logp_and_value_match_jax():
    jm, tm = _discrete_pair(seed=5, num_actions=3, obs_dim=6)
    obs = _obs(np.random.default_rng(2), 64, 6)
    actions, logp, values = tm.action_exploration(
        obs, torch.Generator().manual_seed(0))
    assert actions.shape == (64,) and set(actions) <= {0, 1, 2}
    logits, want_values = jm.forward(jm.params, obs)
    want_logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(64),
                                                       actions]
    _close(logp, want_logp)
    _close(values, want_values)
    # the same generator state draws the same actions
    again, _, _ = tm.action_exploration(obs, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, actions)


def test_init_is_flax_lecun_normal():
    """The port starts as flax's Dense does: zero biases and kernels from a
    normal truncated at 2 std, of std 1/sqrt(fan_in) after truncation."""
    tm = tmodule.RLModule((64,), 2, hiddens=(256, 256), seed=0,
                          device="cpu")
    w = tm.net.fc_1.weight.detach().numpy()
    assert np.abs(w).max() <= 2 * (1 / 256) ** 0.5 / 0.8796256610342398
    assert abs(w.std() * 16.0 - 1.0) < 0.02
    assert not tm.net.fc_1.bias.detach().numpy().any()
    jm = jmodule.RLModule((64,), 2, hiddens=(256, 256), seed=0)
    jw = np.asarray(jm.params["fc_1"]["kernel"])
    assert abs(w.std() - jw.std()) < 0.02 * jw.std()


def test_ravel_follows_ravel_pytree():
    from jax.flatten_util import ravel_pytree

    jm, tm = _discrete_pair(seed=2, dueling=True, hiddens=(8, 5))
    want, unravel = ravel_pytree(jm.params)
    _close(tm.ravel(), want, 0, 0)
    theta = np.random.default_rng(0).normal(size=want.size).astype(
        np.float32)
    _state_close(tm.unravel(theta),
                 convert.rl_module_params_from_jax(_np_tree(
                     unravel(jnp.asarray(theta)))), 0, 0)
    with pytest.raises(ValueError, match="flat vector"):
        tm.unravel(theta[:-1])


# ---------------------------------------------------------------------------
# advantage estimation
# ---------------------------------------------------------------------------

def _fragment(rng, n, obs_dim=4, num_actions=2):
    """A rollout fragment with terminations and truncations mid-fragment."""
    dones = np.zeros(n, bool)
    truncs = np.zeros(n, bool)
    dones[[n // 4, 3 * n // 4]] = True
    truncs[n // 2] = True
    return {
        "obs": _obs(rng, n, obs_dim),
        "next_obs": _obs(rng, n, obs_dim),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        "rewards": rng.normal(1.0, 0.5, n).astype(np.float32),
        "dones": dones,
        "truncateds": truncs,
        "logp": np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        "values": rng.normal(size=n).astype(np.float32),
        "vf_next": rng.normal(size=n).astype(np.float32),
    }


def test_vtrace_matches_jax():
    rng = np.random.default_rng(4)
    f = _fragment(rng, 96)
    target = np.log(rng.uniform(0.1, 0.9, 96)).astype(np.float32)
    args = (f["logp"], target, f["rewards"], f["values"], f["vf_next"],
            f["dones"], f["truncateds"])
    for gamma, rho, c in ((0.99, 1.0, 1.0), (0.9, 2.0, 0.5)):
        want = jlearner.vtrace(*map(jnp.asarray, args), gamma, rho, c)
        got = tlearner.vtrace(*map(torch.from_numpy, args), gamma, rho, c)
        for g, w in zip(got, want):
            _close(g, w)


def test_vtrace_on_policy_reduces_to_td():
    n = 5
    z = torch.zeros(n)
    vs, _ = trl.vtrace(z, z, torch.ones(n), z, z, torch.zeros(n, dtype=bool),
                       torch.zeros(n, dtype=bool), 1.0)
    # on-policy, gamma=1, zero values: vs[t] = sum of remaining rewards
    assert np.allclose(vs.numpy(), [5, 4, 3, 2, 1])


def test_vtrace_truncation_cuts_chain_keeps_bootstrap():
    n = 4
    z = torch.zeros(n)
    # truncation after t=1 bootstraps from V(final obs)=10, and the
    # correction chain must not leak t>=2 rewards into t<=1 targets
    next_values = torch.tensor([0.0, 10.0, 0.0, 0.0])
    truncs = torch.tensor([False, True, False, False])
    vs, _ = trl.vtrace(z, z, torch.ones(n), z, next_values,
                       torch.zeros(n, dtype=bool), truncs, 1.0)
    assert np.allclose(vs.numpy(), [12, 11, 2, 1])


def test_gae_matches_manual():
    batch = trl.SampleBatch({
        "rewards": np.array([1.0, 1.0, 1.0], np.float32),
        "values": np.array([0.5, 0.5, 0.5], np.float32),
        "dones": np.array([False, False, True]),
    })
    out = trl.compute_gae(batch, last_value=9.9, gamma=1.0, lam=1.0)
    assert np.isclose(out["advantages"][2], 0.5)
    assert np.isclose(out["advantages"][1], 1.5)
    assert np.allclose(out["value_targets"], out["advantages"] + 0.5)


def test_gae_truncation_bootstraps_final_obs():
    batch = trl.SampleBatch({
        "rewards": np.array([1.0, 1.0, 1.0], np.float32),
        "values": np.array([0.0, 0.0, 0.0], np.float32),
        "dones": np.array([False, False, False]),
        "truncateds": np.array([False, True, False]),
        "vf_next": np.array([0.0, 10.0, 7.0], np.float32),
    })
    out = trl.compute_gae(batch, last_value=0.0, gamma=1.0, lam=1.0)
    assert np.allclose(out["advantages"], [12.0, 11.0, 8.0])


@pytest.mark.parametrize("vf_next", [True, False])
def test_gae_matches_jax(vf_next):
    f = _fragment(np.random.default_rng(6), 80)
    if not vf_next:
        del f["vf_next"]
    want = jrl.compute_gae(jrl.SampleBatch(dict(f)), 0.7, 0.99, 0.95)
    got = trl.compute_gae(trl.SampleBatch(dict(f)), 0.7, 0.99, 0.95)
    for k in ("advantages", "value_targets"):
        _close(got[k], want[k], 0, 0)


# ---------------------------------------------------------------------------
# learners: one update on one fixed batch, metrics and parameters after
# ---------------------------------------------------------------------------

def _configs(name, **training):
    """The same training settings on the reference's config and the
    port's (the port's learner on the CPU)."""
    cls = {"ppo": "PPOConfig", "pg": "PGConfig", "a2c": "A2CConfig",
           "impala": "IMPALAConfig", "appo": "APPOConfig",
           "dqn": "DQNConfig", "sac": "SACConfig", "td3": "TD3Config",
           "ddpg": "DDPGConfig"}[name]
    jc = getattr(jrl, cls)().training(**training)
    tc = getattr(trl, cls)().training(**training).learners(
        num_gpus_per_learner=0)
    return jc, tc


def _train_batch(rng, n, obs_dim=4, num_actions=2):
    f = _fragment(rng, n, obs_dim, num_actions)
    f["advantages"] = rng.normal(size=n).astype(np.float32)
    f["value_targets"] = rng.normal(size=n).astype(np.float32)
    return f


def _tol(adam_steps):
    """f32's tolerance for what the starting weights give; once Adam steps
    have moved the weights, their rounding piles up: rtol 1e-4, atol
    1e-5."""
    return (RTOL, ATOL) if adam_steps == 0 else (ADAM_RTOL, ADAM_ATOL)


_DISCRETE = {
    # name: (training kwargs, batch rows, Adam steps in one update)
    "ppo": (dict(num_epochs=3, minibatch_size=64, entropy_coeff=0.01),
            256, 12),
    "pg": (dict(num_epochs=2, minibatch_size=100), 200, 4),
    "a2c": ({}, 128, 1),
    "impala": ({}, 128, 1),
    "appo": (dict(clip_param=0.3), 128, 1),
}


@pytest.mark.parametrize("name", sorted(_DISCRETE))
def test_learner_update_matches_jax(name):
    """Two updates of PPO (several epochs of minibatches), PG, A2C, IMPALA
    and APPO; the metrics come from the last minibatch of each."""
    training, n, steps = _DISCRETE[name]
    jc, tc = _configs(name, **training)
    jm, tm = _discrete_pair(seed=7)
    jl = getattr(jrl, jc.algo_class._learner_cls.__name__)(jm, jc)
    tl = getattr(trl, tc.algo_class._learner_cls.__name__)(tm, tc)
    rng = np.random.default_rng(8)
    for update in range(2):
        batch = _train_batch(rng, n)
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], *_tol(update * steps + steps - 1), k)
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 *_tol(2 * steps))


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    """Dueling DQN over PER-weighted n-step batches, double-Q or not, with
    its target network synced between updates."""
    jc, tc = _configs("dqn", double_q=double_q)
    jm, tm = _discrete_pair(seed=11, dueling=True, num_actions=3)
    jl, tl = jrl.DQNLearner(jm, jc), trl.DQNLearner(tm, tc)
    rng = np.random.default_rng(12)
    for step in range(3):
        batch = _train_batch(rng, 64, num_actions=3)
        batch["weights"] = rng.uniform(0.2, 1.0, 64).astype(np.float32)
        batch["nstep_discount"] = rng.choice(
            [0.99, 0.99 ** 2, 0.99 ** 3], 64).astype(np.float32)
        batch["batch_indexes"] = np.arange(64)
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        for k in want:
            _close(got[k], want[k], *_tol(step), k)
        _close(tl.last_td_abs, jl.last_td_abs, *_tol(step))
        if step == 1:
            jl.sync_target()
            tl.sync_target()
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 *_tol(3))
    _state_close(tmodule.get_state(tl.target_net),
                 convert.rl_module_params_from_jax(
                     _np_tree(jl.target_params)), *_tol(2))


def test_sac_update_matches_jax():
    jc, tc = _configs("sac", lr=3e-3)
    jm, tm = _discrete_pair(seed=13)
    jl, tl = jrl.SACLearner(jm, jc), trl.SACLearner(tm, tc)
    q_sd, log_alpha = convert.sac_params_from_jax(_np_tree(jl.q_params),
                                                  np.asarray(jl.log_alpha))
    tl.qnet.load_state_dict(q_sd)
    tl.target_qnet.load_state_dict(q_sd)
    with torch.no_grad():
        tl.log_alpha.copy_(log_alpha)
    rng = np.random.default_rng(14)
    for step in range(3):
        batch = _train_batch(rng, 64)
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want)
        for k in want:
            # the step's own Q update comes before its losses are read
            _close(got[k], want[k], *_tol(step + (k != "q_loss")), k)
    _state_close(tm.get_state(),
                 convert.rl_module_params_from_jax(_np_tree(jm.params)),
                 *_tol(3))
    for port, ref in ((tl.qnet, jl.q_params),
                      (tl.target_qnet, jl.target_q_params)):
        _state_close(tmodule.get_state(port),
                     convert.sac_params_from_jax(_np_tree(ref), 0.0)[0],
                     *_tol(3))
    _close(tl.log_alpha, jl.log_alpha, *_tol(3))


@pytest.mark.parametrize("name", ["td3", "ddpg"])
def test_td3_update_matches_jax(name):
    """TD3 (twin Q, policy delay 2) and DDPG, at ``target_noise=0``: the
    reference draws its target-policy noise from a JAX key."""
    jc, tc = _configs(name, target_noise=0.0, tau=0.05)
    info = {"kind": "continuous", "dim": 1,
            "low": np.array([-1.0], np.float32),
            "high": np.array([1.0], np.float32)}
    jm = jmodule.ContinuousRLModule((2,), info, seed=15)
    tm = tmodule.ContinuousRLModule((2,), info, seed=0, device="cpu")
    tm.set_state(convert.continuous_module_params_from_jax(
        _np_tree(jm.params)))
    jl, tl = jrl.TD3Learner(jm, jc), trl.TD3Learner(tm, tc)
    rng = np.random.default_rng(16)
    for step in range(4):
        batch = {"obs": _obs(rng, 64, 2), "next_obs": _obs(rng, 64, 2),
                 "actions": rng.uniform(-1, 1, (64, 1)).astype(np.float32),
                 "rewards": rng.normal(size=64).astype(np.float32),
                 "dones": rng.uniform(size=64) < 0.1}
        want = jl.update(jrl.SampleBatch(dict(batch)))
        got = tl.update(trl.SampleBatch(dict(batch)))
        assert set(got) == set(want)
        for k in want:
            # the actor's loss is read after the step's critic update
            _close(got[k], want[k], *_tol(step + (k == "actor_loss")), k)
    _state_close(tm.get_state(), convert.continuous_module_params_from_jax(
        _np_tree(jm.params)), *_tol(4))
    _state_close(tmodule.get_state(tl.target),
                 convert.continuous_module_params_from_jax(
                     _np_tree(jl.target_params)), *_tol(4))


def _thread_mean_allreduce(n, mean):
    """Per-rank allreduce functions that meet at a barrier and hand every
    rank the mean of all ranks' gradients (``mean`` averages a list of the
    ranks' gradient lists or trees)."""
    barrier, slots = threading.Barrier(n, timeout=60), [None] * n

    def make(rank):
        def allreduce(grads):
            slots[rank] = grads
            barrier.wait()
            out = mean(list(slots))
            barrier.wait()
            return out
        return allreduce
    return [make(r) for r in range(n)]


def _run_ranks(fns):
    out, threads = [None] * len(fns), []
    for r, fn in enumerate(fns):
        def run(r=r, fn=fn):
            out[r] = fn()
        threads.append(threading.Thread(target=run))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("name", ["ppo", "impala"])
def test_update_ddp_matches_jax(name):
    """Two ranks, each ``update_ddp`` on its shard with an in-process mean
    allreduce between the grad and apply halves; the replicas end equal,
    and equal to the reference's (PPO's several Adam steps: rtol 1e-4)."""
    training = dict(num_epochs=2, minibatch_size=32) if name == "ppo" else {}
    rtol, atol = _tol(name == "ppo")
    jc, tc = _configs(name, **training)
    batch = _train_batch(np.random.default_rng(17), 128)
    shards = jrl.SampleBatch(dict(batch)).shards(2)
    pairs = [_discrete_pair(seed=18) for _ in range(2)]
    jls = [getattr(jrl, jc.algo_class._learner_cls.__name__)(jm, jc)
           for jm, _ in pairs]
    tls = [getattr(trl, tc.algo_class._learner_cls.__name__)(tm, tc)
           for _, tm in pairs]
    jmean = _thread_mean_allreduce(2, lambda trees: jax.tree.map(
        lambda a, b: (a + b) / 2, *trees))
    tmean = _thread_mean_allreduce(2, lambda lists: [
        (a + b) / 2 for a, b in zip(*lists)])
    want = _run_ranks([lambda r=r: jls[r].update_ddp(
        jrl.SampleBatch(dict(shards[r])), jmean[r]) for r in range(2)])
    got = _run_ranks([lambda r=r: tls[r].update_ddp(
        trl.SampleBatch(dict(shards[r])), tmean[r]) for r in range(2)])
    for g, w in zip(got, want):
        for k in w:
            _close(g[k], w[k], rtol, atol, k)
    s0, s1 = (tm.get_state() for _, tm in pairs)
    assert all(np.array_equal(s0[k], s1[k]) for k in s0)
    _state_close(s0, convert.rl_module_params_from_jax(
        _np_tree(pairs[0][0].params)), *_tol(1))


def test_optimizer_state_roundtrip_keeps_adam_moments():
    _, tc = _configs("ppo", num_epochs=1, minibatch_size=64)
    _, tm = _discrete_pair(seed=19)
    tl = trl.PPOLearner(tm, tc)
    tl.update(trl.SampleBatch(_train_batch(np.random.default_rng(20), 128)))
    state = tl.get_optimizer_state()
    assert all(v.device.type == "cpu" for s in state["state"].values()
               for v in s.values() if torch.is_tensor(v))
    other = trl.PPOLearner(_discrete_pair(seed=19)[1], tc)
    other.set_weights(tl.get_weights())
    other.set_optimizer_state(state)
    batch = _train_batch(np.random.default_rng(21), 128)
    tl._rng, other._rng = np.random.default_rng(0), np.random.default_rng(0)
    assert tl.update(trl.SampleBatch(dict(batch))) == \
        other.update(trl.SampleBatch(dict(batch)))
    other.set_optimizer_state(None)
    assert not other.optimizer.state


# ---------------------------------------------------------------------------
# ES and ARS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ES", "ARS"])
def test_es_update_of_a_bridged_module_matches_jax(name):
    """One ES/ARS update: the same theta (flax's flatten order), the same
    noise seeds and returns give the same new weights; and a runner scores
    the same perturbed policy, greedy on the same env, in both packages."""
    from jax.flatten_util import ravel_pytree

    jm, tm = _discrete_pair(seed=22, hiddens=(16,))
    theta, unravel = ravel_pytree(jm.params)
    theta = np.asarray(theta, np.float32)
    _close(tm.ravel(), theta, 0, 0)
    jcfg, tcfg = getattr(jrl, f"{name}Config")(), getattr(
        trl, f"{name}Config")()
    rng = np.random.default_rng(23)
    seeds = rng.integers(0, 2**31 - 1, size=8)
    eps = np.stack([np.random.default_rng(int(s)).standard_normal(
        theta.size).astype(np.float32) for s in seeds])
    plus, minus = (rng.normal(50, 10, 8).astype(np.float32)
                   for _ in range(2))
    want = getattr(jrl, name)._es_update(
        SimpleNamespace(_algo_config=jcfg), eps, plus, minus)
    got = getattr(trl, name)._es_update(
        SimpleNamespace(_algo_config=tcfg), eps, plus, minus)
    _close(got, want)
    new_theta = theta + got
    tm.set_state(tm.unravel(new_theta))
    _state_close(tm.get_state(), convert.rl_module_params_from_jax(
        _np_tree(unravel(jnp.asarray(new_theta)))))

    runner_kw = ("CartPole-native", {"max_episode_steps": 60},
                 {"hiddens": (16,)})
    jr = jrl.EnvRunner(*runner_kw, seed=3)
    tr = trl.EnvRunner(*runner_kw, seed=3)
    jr.set_weights(jm.params)
    tr.set_weights(tm.get_state())
    for seed, sign in ((int(seeds[0]), 1.0), (int(seeds[1]), -1.0)):
        assert tr.evaluate_perturbed(new_theta, seed, sign, 0.05, 2) == \
            jr.evaluate_perturbed(new_theta, seed, sign, 0.05, 2)


# ---------------------------------------------------------------------------
# configs and where the learner runs
# ---------------------------------------------------------------------------

_CONFIGS = ["AlgorithmConfig", "PPOConfig", "IMPALAConfig", "DQNConfig",
            "SACConfig", "TD3Config", "DDPGConfig", "PGConfig", "A2CConfig",
            "APPOConfig", "ESConfig", "ARSConfig"]


@pytest.mark.parametrize("name", _CONFIGS)
def test_config_defaults_equal_the_reference(name):
    """Every default equals the reference's, apart from the learner's
    device knob: ``num_gpus_per_learner`` 1 (the card) where the reference
    has ``num_tpus_per_learner`` 0 (JAX's default device, the chip)."""
    want = getattr(jrl, name)().to_dict()
    got = getattr(trl, name)().to_dict()
    assert want.pop("num_tpus_per_learner") == 0
    assert got.pop("num_gpus_per_learner") == 1
    assert got == want


def test_build_raises_without_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.PPOConfig().env_runners(num_env_runners=0).build()
    with pytest.raises(RuntimeError, match="num_gpus_per_learner=0"):
        trl.TD3Config().env_runners(num_env_runners=0).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodule.RLModule((4,), 2)
    assert tmodule.learner_device(0) == torch.device("cpu")


def test_num_tpus_per_learner_raises():
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        trl.PPOConfig().learners(num_tpus_per_learner=1)
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        trl.PPO(config={"num_tpus_per_learner": 1})
    cfg = trl.IMPALAConfig().learners(num_learners=2,
                                      num_gpus_per_learner=0.5)
    assert (cfg.num_learners, cfg.num_gpus_per_learner) == (2, 0.5)


def test_tuned_examples_are_the_ported_algorithms():
    from ray_tpu_torch.rllib.run_regression import (
        TUNED_EXAMPLES_DIR,
        load_experiments,
    )

    experiments = load_experiments(TUNED_EXAMPLES_DIR)
    reference = load_experiments(str(REPO / "ray_tpu/rllib/tuned_examples"))
    assert sorted(experiments) == sorted(reference) == [
        "cartpole-a2c", "cartpole-appo", "cartpole-ars", "cartpole-cql",
        "cartpole-dqn", "cartpole-dreamerv3", "cartpole-dt", "cartpole-es",
        "cartpole-impala-multilearner", "cartpole-marwil", "cartpole-pg",
        "cartpole-ppo", "cartpole-sac", "memorychain-r2d2", "reacher-ddpg",
        "reacher-td3", "twostep-qmix"]
    for name, spec in experiments.items():
        if name == "cartpole-impala-multilearner":
            # its two learners move from CPUs to half a card each
            learners = spec["config"]["learners"]
            assert learners.pop("num_gpus_per_learner") == 0.5
        assert spec == reference[name], name


def test_port_rllib_modules_import_no_jax_and_nothing_of_ray_tpu():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``; here it is run on RLlib's modules alone:
    the 14 of the first RLlib slice, the 5 of the second (``dreamerv3``,
    ``dt``, ``offline``, ``qmix``, ``r2d2``) and the weight bridge."""
    files = sorted((REPO / "ray_tpu_torch" / "rllib").rglob("*.py"))
    assert [f.stem for f in files] == [
        "__init__", "algorithm", "connectors", "dreamerv3", "dt", "env",
        "env_runner", "evolution", "external_env", "learner",
        "learner_group", "multi_agent", "offline", "qmix", "r2d2",
        "replay_buffer", "rl_module", "run_regression", "sample_batch"]
    files += [REPO / "ray_tpu_torch" / "models" / "convert.py",
              REPO / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                names = [node.value] if node.value == "ray_tpu" or \
                    node.value.startswith("ray_tpu.") else []
            for name in names:
                assert name.split(".")[0] not in {
                    "jax", "jaxlib", "flax", "optax", "ray_tpu"}, \
                    f"{f}: {name}"


# the cluster-operations modules: (path under ray_tpu_torch/, whether the
# GCS, a raylet or the autoscaler monitor imports it, and so must import no
# torch at module level)
CLUSTER_MODULES = {
    "__main__.py": True, "scripts/__init__.py": True,
    "scripts/cli.py": True, "autoscaler/__init__.py": True,
    "autoscaler/autoscaler.py": True, "autoscaler/commands.py": True,
    "autoscaler/monitor.py": True, "autoscaler/node_provider.py": True,
    "job_submission/__init__.py": True, "_private/kv_server.py": True,
    "util/transfer.py": True, "dashboard/grafana.py": True,
    "_private/schedsim.py": True, "_private/perf.py": False,
    "serve/load_harness.py": False, "parallel/mesh_utils.py": False,
    "tools/cluster_runs.py": True,
}


def _module_level_imports(tree):
    """Top-level module names imported outside any function or class."""
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, (ast.If, ast.Try)):
            names += _module_level_imports(ast.Module(
                body=[n for part in ("body", "orelse", "finalbody")
                      for n in getattr(node, part, [])], type_ignores=[]))
    return names


def test_cluster_modules_import_no_jax_no_ray_tpu_and_no_torch_at_boot():
    """The cluster-operations modules (CLI, autoscaler, job submission, KV
    server, perf, schedsim, transfer, grafana, load harness, hybrid mesh,
    the cluster run) name no ``ray_tpu``/``jax`` module anywhere, and those
    that the GCS, a raylet or the monitor import have no module-level torch
    import; importing the monitor's, the CLI's and the job supervisor's
    modules in a fresh process loads neither torch nor JAX."""
    import subprocess
    import sys

    root = REPO / "ray_tpu_torch"
    for rel, at_boot in CLUSTER_MODULES.items():
        f = root / rel
        tree = ast.parse(f.read_text(), str(f))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                names = [node.value] if node.value == "ray_tpu" or \
                    node.value.startswith("ray_tpu.") else []
            for name in names:
                assert name.split(".")[0] not in {
                    "jax", "jaxlib", "flax", "optax", "ray_tpu"}, \
                    f"{rel}: {name}"
        if at_boot:
            top = {n.split(".")[0] for n in _module_level_imports(tree)}
            assert "torch" not in top, f"{rel} imports torch at module level"
    code = ("import sys; import ray_tpu_torch.autoscaler.monitor, "
            "ray_tpu_torch.autoscaler.commands, ray_tpu_torch.scripts.cli, "
            "ray_tpu_torch.job_submission, ray_tpu_torch._private.kv_server, "
            "ray_tpu_torch._private.schedsim, ray_tpu_torch.util.transfer, "
            "ray_tpu_torch.dashboard.grafana, "
            "ray_tpu_torch.tools.cluster_runs; "
            "print(sorted(m for m in ('torch', 'jax', 'ray_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
