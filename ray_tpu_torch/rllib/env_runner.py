"""EnvRunner: the sampling-plane actors.

Reference parity: ray rllib/evaluation/rollout_worker.py:660 (sample) /
rllib/env/env_runner.py — actors stepping one env with the current policy
and returning fixed-size rollout fragments plus episode-return metrics.
``EnvRunner`` serves the discrete on-policy stack (log-probs + value
estimates for PPO/IMPALA); ``ContinuousEnvRunner`` serves TD3/DDPG
(deterministic actor + gaussian exploration, plain transitions).

Runners live on the CPU: their modules are built on ``torch.device("cpu")``,
their processes see no card (``RUNNER_RUNTIME_ENV``), and each draws its
actions from a ``torch.Generator`` seeded with the runner's seed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import (
    env_action_info,
    env_obs_shape,
    env_spaces,
    make_env,
)
from ray_tpu_torch.rllib.rl_module import ContinuousRLModule, RLModule
from ray_tpu_torch.rllib.sample_batch import SampleBatch

# The runtime env of every sampling actor: the raylet leaves the card
# visible to a worker, and a runner must never open a context on it.
RUNNER_RUNTIME_ENV = {"env_vars": {"CUDA_VISIBLE_DEVICES": ""}}


class _RunnerBase:
    """Shared env ownership + episode accounting + greedy evaluation."""

    def __init__(self, env_spec: Any, env_config: Optional[dict],
                 seed: int = 0):
        # one tiny forward a step: a pool of intra-op threads per runner
        # process would only contend for the host's cores
        torch.set_num_threads(1)
        self.env = make_env(env_spec, env_config)
        self._gen = torch.Generator().manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._episode_len = 0
        self._completed: list = []

    def set_weights(self, params):
        self.module.set_state(params)
        return True

    def get_weights(self):
        return self.module.get_state()

    def ping(self):
        """Non-destructive liveness probe (get_metrics drains episode
        stats, so health checks must not use it)."""
        return True

    def _end_step(self, reward, terminated, truncated, nxt):
        """Advance episode accounting after one env step; returns True if
        an episode boundary was crossed (env already reset)."""
        self._episode_return += reward
        self._episode_len += 1
        if terminated or truncated:
            self._completed.append(
                {"return": self._episode_return, "len": self._episode_len}
            )
            self._episode_return = 0.0
            self._episode_len = 0
            self._obs, _ = self.env.reset()
            return True
        self._obs = nxt
        return False

    def get_metrics(self) -> Dict[str, float]:
        eps, self._completed = self._completed, []
        if not eps:
            return {"episodes_this_iter": 0}
        returns = [e["return"] for e in eps]
        return {
            "episodes_this_iter": len(eps),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_len_mean": float(np.mean([e["len"] for e in eps])),
        }

    def _reset_sampling_state(self):
        """Evaluation drove the shared env past the sampler's cursor; start
        a fresh episode so the next sample() doesn't pair a stale obs with a
        step from the eval episode's terminal state (for off-policy runners
        a corrupt transition would persist in the replay buffer)."""
        self._obs, _ = self.env.reset()
        self._episode_return = 0.0
        self._episode_len = 0

    def _eval_action(self, obs):
        raise NotImplementedError

    def evaluate(self, num_episodes: int = 5) -> float:
        """Greedy policy evaluation, returns mean episode return."""
        total = []
        self._eval_steps = 0
        for _ in range(num_episodes):
            obs, _ = self.env.reset()
            ep_ret, done = 0.0, False
            while not done:
                obs, r, term, trunc, _ = self.env.step(self._eval_action(obs))
                ep_ret += r
                self._eval_steps += 1
                done = term or trunc
            total.append(ep_ret)
        self._reset_sampling_state()
        return float(np.mean(total))

    def evaluate_with(self, params, num_episodes: int = 1) -> Dict[str, float]:
        """Atomic set_weights + evaluate (for ES/ARS candidate scoring):
        a retried call after an actor restart re-runs BOTH halves, so a
        respawned runner can never score with its re-initialized seed
        weights. Returns the mean return and the env steps consumed."""
        self.set_weights(params)
        score = self.evaluate(num_episodes)
        return {"return": score, "steps": float(self._eval_steps)}

    def evaluate_perturbed(self, base_flat, noise_seed: int, sign: float,
                           noise_std: float,
                           num_episodes: int = 1) -> Dict[str, float]:
        """ES/ARS candidate scoring with seed-based weight reconstruction:
        only the (shared base vector ref, seed, sign) cross the wire — the
        perturbation is regenerated here from the seed, so per-candidate
        payload is a few bytes instead of a full parameter pytree. Atomic
        like evaluate_with (retry-safe after actor restarts)."""
        eps = np.random.default_rng(noise_seed).standard_normal(
            base_flat.size).astype(np.float32)
        theta = base_flat + sign * noise_std * eps
        return self.evaluate_with(self.module.unravel(theta), num_episodes)


class EnvRunner(_RunnerBase):
    def __init__(self, env_spec: Any, env_config: Optional[dict],
                 module_kwargs: Dict, seed: int = 0,
                 observation_filter: Optional[str] = None):
        super().__init__(env_spec, env_config, seed)
        obs_shape, num_actions = env_spaces(self.env)
        self.module = RLModule(obs_shape, num_actions, seed=seed,
                               device="cpu", **module_kwargs)
        # env-to-module connector pipeline (ray parity: ConnectorV2 /
        # MeanStdFilter): observations normalize before the policy AND
        # before entering the train batch, stats sync via
        # get/set_connector_state each iteration.
        from ray_tpu_torch.rllib.connectors import build_obs_pipeline

        self._obs_pipeline = build_obs_pipeline(observation_filter, obs_shape)
        if self._obs_pipeline is not None:
            # the reset obs from _RunnerBase.__init__ is an observation too
            self._obs_pipeline(self._obs, update=True)

    def _reset_sampling_state(self):
        super()._reset_sampling_state()
        if self._obs_pipeline is not None:
            self._obs_pipeline(self._obs, update=True)

    def _filt(self, obs, update: bool):
        if self._obs_pipeline is None:
            return np.asarray(obs, np.float32)
        return self._obs_pipeline(obs, update=update)

    def get_connector_state(self) -> Optional[dict]:
        """Absolute pipeline state (checkpointing/tests)."""
        if self._obs_pipeline is None:
            return None
        return self._obs_pipeline.get_state()

    def pop_connector_delta(self) -> Optional[dict]:
        """Observations since the last sync; clears the delta buffer
        (ray parity: FilterManager.synchronize pulls+clears buffers)."""
        if self._obs_pipeline is None:
            return None
        return self._obs_pipeline.pop_delta_state()

    def set_connector_state(self, state: Optional[dict]):
        if self._obs_pipeline is not None and state:
            self._obs_pipeline.set_state(state)
        return True

    def _eval_action(self, obs):
        return int(self.module.action_greedy(
            self._filt(obs, update=False)[None, :]
        )[0])

    def _value_of(self, obs_f) -> float:
        _, v = self.module.forward(np.asarray(obs_f, np.float32)[None, :])
        return float(v[0])

    def sample(self, num_steps: int) -> SampleBatch:
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = (
            [], [], [], [], [], []
        )
        next_obs_buf, trunc_buf, vf_next_buf = [], [], []
        for _ in range(num_steps):
            # current obs's filter stats were updated when it was first
            # observed; normalize with the frozen view here
            fobs = self._filt(self._obs, update=False)
            a, logp, v = self.module.action_exploration(fobs[None, :],
                                                        self._gen)
            action = int(a[0])
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            fnxt = self._filt(nxt, update=True)  # a NEW observation
            obs_buf.append(fobs)
            next_obs_buf.append(fnxt)
            act_buf.append(action)
            rew_buf.append(reward)
            # bootstrap through time-limit truncation, not termination
            done_buf.append(terminated)
            trunc_buf.append(bool(truncated) and not terminated)
            logp_buf.append(logp[0])
            val_buf.append(v[0])
            if terminated:
                vf_next_buf.append(0.0)  # unused: bootstrap is cut
            elif truncated:
                # V of the episode's final obs, captured BEFORE reset —
                # GAE must bootstrap from the truncated state, not the
                # new episode's reset obs.
                vf_next_buf.append(self._value_of(fnxt))
            else:
                vf_next_buf.append(np.nan)  # = values[t+1], filled below
            if self._end_step(reward, terminated, truncated, nxt) and \
                    self._obs_pipeline is not None:
                # episode boundary: the reset obs is a new observation
                self._obs_pipeline(self._obs, update=True)
        values = np.asarray(val_buf, np.float32)
        vf_next = np.asarray(vf_next_buf, np.float32)
        # Fill mid-episode steps with the next step's on-policy value; the
        # fragment's last step (if mid-episode) bootstraps from the live obs.
        if num_steps and np.isnan(vf_next[-1]):
            vf_next[-1] = self._value_of(self._filt(self._obs, update=False))
        nan_mask = np.isnan(vf_next)
        if nan_mask.any():
            vf_next[nan_mask] = values[1:][nan_mask[:-1]]
        batch = SampleBatch(
            {
                sb.OBS: np.asarray(obs_buf, np.float32),
                sb.NEXT_OBS: np.asarray(next_obs_buf, np.float32),
                sb.ACTIONS: np.asarray(act_buf, np.int32),
                sb.REWARDS: np.asarray(rew_buf, np.float32),
                sb.DONES: np.asarray(done_buf, np.bool_),
                sb.TRUNCATEDS: np.asarray(trunc_buf, np.bool_),
                sb.LOGP: np.asarray(logp_buf, np.float32),
                sb.VALUES: values,
                sb.VF_NEXT: vf_next,
            }
        )
        # fragment-end bootstrap (legacy consumers): == vf_next of last step
        batch["bootstrap_value"] = np.full(
            batch.count, float(vf_next[-1]) if num_steps else 0.0, np.float32
        )
        return batch


class ContinuousEnvRunner(_RunnerBase):
    """Sampling actor for continuous control (TD3/DDPG): gaussian
    exploration noise around the deterministic actor, (s, a, r, s', done)
    transitions only — off-policy learners need no logp/value traces."""

    def __init__(self, env_spec: Any, env_config: Optional[dict],
                 module_kwargs: Dict, seed: int = 0,
                 noise_scale: float = 0.1, warmup_steps: int = 500):
        super().__init__(env_spec, env_config, seed)
        obs_shape = env_obs_shape(self.env)
        info = env_action_info(self.env)
        assert info["kind"] == "continuous", info
        self.module = ContinuousRLModule(obs_shape, info, seed=seed,
                                         device="cpu", **module_kwargs)
        self.noise_scale = noise_scale
        self.warmup_steps = warmup_steps  # uniform-random before learning
        self._steps = 0
        self._rng = np.random.default_rng(seed)

    def _eval_action(self, obs):
        return self.module.action_greedy(
            np.asarray(obs, np.float32)[None, :]
        )[0]

    def sample(self, num_steps: int) -> SampleBatch:
        obs_buf, act_buf, rew_buf, done_buf, next_obs_buf = [], [], [], [], []
        low, high = self.module.low, self.module.high
        for _ in range(num_steps):
            if self._steps < self.warmup_steps:
                action = self._rng.uniform(low, high).astype(np.float32)
            else:
                action = self.module.action_exploration(
                    np.asarray(self._obs, np.float32)[None, :], self._gen,
                    self.noise_scale,
                )[0]
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            obs_buf.append(self._obs)
            act_buf.append(action)
            rew_buf.append(reward)
            done_buf.append(terminated)  # truncation still bootstraps
            next_obs_buf.append(nxt)
            self._steps += 1
            self._end_step(reward, terminated, truncated, nxt)
        return SampleBatch(
            {
                sb.OBS: np.asarray(obs_buf, np.float32),
                sb.NEXT_OBS: np.asarray(next_obs_buf, np.float32),
                sb.ACTIONS: np.asarray(act_buf, np.float32),
                sb.REWARDS: np.asarray(rew_buf, np.float32),
                sb.DONES: np.asarray(done_buf, np.bool_),
            }
        )
