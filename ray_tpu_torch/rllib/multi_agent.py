"""Multi-agent RL: env API, runner, and multi-policy PPO.

Reference parity: ray rllib/env/multi_agent_env.py (dict-keyed
reset/step with an "__all__" done key), the policy_mapping_fn contract
(algorithm_config.multi_agent), and multi-policy training where each
policy trains on the transitions of the agents mapped to it (ray:
rllib/policy/sample_batch.py MultiAgentBatch). Each policy is one
RLModule + one PPO learner (on the card unless ``num_gpus_per_learner=0``
is passed among the training kwargs); agents sharing a policy share
weights. Runners sample on CPUs with a ``torch.Generator`` each.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import RUNNER_RUNTIME_ENV
from ray_tpu_torch.rllib.rl_module import RLModule, learner_device
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae


class MultiAgentEnv:
    """Dict-keyed env API (ray parity: multi_agent_env.py). Subclasses
    define agent_ids and per-agent spaces; ``step`` consumes an action
    dict for live agents and returns per-agent dicts plus "__all__" in
    the terminated dict."""

    agent_ids: List[str] = []

    def reset(self, *, seed: Optional[int] = None, options=None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent cart-poles, one per agent — the multi-agent learning
    regression workhorse (ray parity: rllib/examples/envs
    multi_agent_cartpole)."""

    def __init__(self, env_config: Optional[dict] = None):
        from ray_tpu_torch.rllib.env import CartPole

        cfg = env_config or {}
        n = cfg.get("num_agents", 2)
        self.agent_ids = [f"agent_{i}" for i in range(n)]
        self._envs = {
            aid: CartPole({**cfg, "seed": (cfg.get("seed") or 0) + i})
            for i, aid in enumerate(self.agent_ids)
        }
        self._done: Dict[str, bool] = {}
        self.observation_shape = (4,)
        self.num_actions = 2

    def reset(self, *, seed: Optional[int] = None, options=None):
        obs = {}
        for i, (aid, env) in enumerate(self._envs.items()):
            obs[aid], _ = env.reset(
                seed=None if seed is None else seed + i
            )
            self._done[aid] = False
        return obs, {}

    def step(self, action_dict: Dict[str, Any]):
        obs, rew, term, trunc = {}, {}, {}, {}
        for aid, action in action_dict.items():
            if self._done[aid]:
                continue
            o, r, t, tr, _ = self._envs[aid].step(action)
            obs[aid], rew[aid], term[aid], trunc[aid] = o, r, t, tr
            if t or tr:
                self._done[aid] = True
        term["__all__"] = all(self._done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}


class MultiAgentEnvRunner:
    """Samples a MultiAgentEnv with per-policy modules; returns one
    GAE-processed SampleBatch per policy (ray parity: RolloutWorker with
    a policy map)."""

    def __init__(self, env_spec: Any, env_config: Optional[dict],
                 policies: List[str],
                 policy_mapping: Dict[str, str],
                 module_kwargs: Dict, gamma: float, lambda_: float,
                 seed: int = 0):
        torch.set_num_threads(1)
        self.env = make_env(env_spec, env_config)
        self.policies = list(policies)
        self.policy_mapping = dict(policy_mapping)
        obs_shape = self.env.observation_shape
        num_actions = self.env.num_actions
        self.modules = {
            pid: RLModule(obs_shape, num_actions, seed=seed + i,
                          device="cpu", **module_kwargs)
            for i, pid in enumerate(self.policies)
        }
        self.gamma = gamma
        self.lambda_ = lambda_
        self._gen = torch.Generator().manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0
        self._completed: list = []

    def _rt_init_collective(self, *a, **kw):  # collective-group parity hook
        from ray_tpu_torch.util.collective import collective as col

        return col.init_collective_group(*a, **kw)

    def set_weights(self, weights: Dict[str, Any]):
        for pid, params in weights.items():
            self.modules[pid].set_state(params)
        return True

    def _value_of(self, pid: str, obs) -> float:
        _, v = self.modules[pid].forward(np.asarray(obs, np.float32)[None, :])
        return float(v[0])

    def sample(self, num_steps: int) -> Dict[str, SampleBatch]:
        """Collect ``num_steps`` env steps. Trajectories are buffered PER
        AGENT (two agents sharing a policy must never interleave inside
        one GAE chain — ray keeps per-agent rows in MultiAgentBatch for
        the same reason); each agent's segment is GAE-processed on
        termination/truncation/fragment end, then concatenated per policy."""
        traj: Dict[str, dict] = {
            aid: {k: [] for k in
                  ("obs", "act", "rew", "done", "logp", "val")}
            for aid in self.policy_mapping
        }
        frags: Dict[str, List[SampleBatch]] = {pid: [] for pid in self.policies}

        def flush(aid, bootstrap):
            t = traj[aid]
            if not t["obs"]:
                return
            batch = SampleBatch({
                sb.OBS: np.asarray(t["obs"], np.float32),
                sb.ACTIONS: np.asarray(t["act"], np.int32),
                sb.REWARDS: np.asarray(t["rew"], np.float32),
                sb.DONES: np.asarray(t["done"], np.bool_),
                sb.LOGP: np.asarray(t["logp"], np.float32),
                sb.VALUES: np.asarray(t["val"], np.float32),
            })
            frags[self.policy_mapping[aid]].append(
                compute_gae(batch, bootstrap, self.gamma, self.lambda_)
            )
            for v in t.values():
                v.clear()

        for _ in range(num_steps):
            actions = {}
            step_info = {}
            for aid, obs in self._obs.items():
                pid = self.policy_mapping[aid]
                a, logp, v = self.modules[pid].action_exploration(
                    np.asarray(obs, np.float32)[None, :], self._gen
                )
                actions[aid] = int(a[0])
                step_info[aid] = (pid, obs, float(logp[0]), float(v[0]))
            nxt, rew, term, trunc, _ = self.env.step(actions)
            for aid, (pid, obs, logp, val) in step_info.items():
                if aid not in rew:
                    continue
                t = traj[aid]
                t["obs"].append(obs)
                t["act"].append(actions[aid])
                t["rew"].append(rew[aid])
                done = bool(term.get(aid, False))
                t["done"].append(done)
                t["logp"].append(logp)
                t["val"].append(val)
                self._ep_return += rew[aid]
                if done:
                    flush(aid, 0.0)
                elif trunc.get(aid, False):
                    # bootstrap from the final pre-reset observation
                    flush(aid, self._value_of(pid, nxt[aid]))
            if term.get("__all__") or trunc.get("__all__"):
                self._completed.append({"return": self._ep_return})
                self._ep_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                # keep only live agents: a dead agent's terminal obs must
                # never be sampled again nor bootstrap anyone's fragment
                self._obs = {
                    aid: nxt[aid] for aid in nxt
                    if not (term.get(aid, False) or trunc.get(aid, False))
                }
        # fragment end: bootstrap each LIVE agent's open segment
        for aid, obs in self._obs.items():
            if traj[aid]["obs"]:
                flush(aid, self._value_of(self.policy_mapping[aid], obs))
        return {
            pid: SampleBatch.concat(batches)
            for pid, batches in frags.items() if batches
        }

    def get_metrics(self) -> Dict[str, float]:
        eps, self._completed = self._completed, []
        if not eps:
            return {"episodes_this_iter": 0}
        returns = [e["return"] for e in eps]
        return {
            "episodes_this_iter": len(eps),
            "episode_return_mean": float(np.mean(returns)),
        }


class MultiAgentPPO:
    """Multi-policy PPO (ray parity: Algorithm with a policy map — each
    policy holds its own module/learner and trains on the transitions of
    the agents mapped to it). Deliberately a standalone coordinator rather
    than a Trainable subclass: multi-agent configs nest poorly in flat
    param spaces; wrap with tune.with_parameters if sweeping."""

    def __init__(self, env_spec, *, policies: List[str],
                 policy_mapping_fn: Callable[[str], str],
                 env_config: Optional[dict] = None,
                 num_env_runners: int = 1,
                 rollout_fragment_length: int = 200,
                 model: Optional[dict] = None,
                 lr: float = 3e-4, gamma: float = 0.99,
                 lambda_: float = 0.95, seed: int = 0,
                 **training_kwargs):
        import ray_tpu_torch
        from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
        from ray_tpu_torch.rllib.learner import PPOLearner

        probe = make_env(env_spec, env_config)
        obs_shape, num_actions = probe.observation_shape, probe.num_actions
        mapping = {aid: policy_mapping_fn(aid) for aid in probe.agent_ids}
        unknown = set(mapping.values()) - set(policies)
        if unknown:
            raise ValueError(f"policy_mapping_fn produced unknown {unknown}")
        module_kwargs = {"hiddens": tuple((model or {}).get("hiddens",
                                                            (64, 64)))}
        self.policies = list(policies)
        # Every PPO knob AlgorithmConfig exposes is tunable via
        # training_kwargs (clip_param, entropy_coeff, num_epochs,
        # num_gpus_per_learner, ...).
        cfg = AlgorithmConfig().training(
            lr=lr, gamma=gamma, lambda_=lambda_, num_epochs=4,
            **training_kwargs,
        )
        cfg.seed = seed
        device = learner_device(cfg.num_gpus_per_learner)
        self.modules = {
            pid: RLModule(obs_shape, num_actions, seed=seed + i,
                          device=device, **module_kwargs)
            for i, pid in enumerate(policies)
        }
        self.learners = {
            pid: PPOLearner(self.modules[pid], cfg) for pid in policies
        }
        runner_cls = ray_tpu_torch.remote(
            num_cpus=0.5,
            max_restarts=2,
            max_task_retries=2,
            runtime_env=RUNNER_RUNTIME_ENV,
        )(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(env_spec, env_config, policies, mapping,
                              module_kwargs, gamma, lambda_, seed=seed + i)
            for i in range(num_env_runners)
        ]
        self.rollout_fragment_length = rollout_fragment_length
        self._timesteps = 0

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch

        weights = ray_tpu_torch.put({
            pid: self.learners[pid].get_weights() for pid in self.policies
        })
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.runners])
        per_runner = ray_tpu_torch.get([
            r.sample.remote(self.rollout_fragment_length)
            for r in self.runners
        ])
        metrics: Dict[str, Any] = {}
        for pid in self.policies:
            batches = [b[pid] for b in per_runner if pid in b]
            if not batches:
                continue
            batch = SampleBatch.concat(batches)
            self._timesteps += batch.count
            m = self.learners[pid].update(batch)
            metrics[pid] = m
        runner_metrics = ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self.runners]
        )
        returns = [m["episode_return_mean"] for m in runner_metrics
                   if m.get("episodes_this_iter")]
        if returns:
            metrics["episode_return_mean"] = float(np.mean(returns))
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        return metrics

    def get_policy_state(self, policy_id: str):
        return self.learners[policy_id].get_weights()

    def stop(self):
        import ray_tpu_torch

        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
