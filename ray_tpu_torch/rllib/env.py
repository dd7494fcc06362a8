"""Environments: gymnasium adapter + dependency-free built-ins.

Reference parity: ray rllib/env/ (BaseEnv/vector envs, env registry) —
reduced to the single-agent gymnasium API (reset/step with terminated/
truncated) plus a tiny registry so algorithm configs can name envs.
CartPole is implemented natively as the learning-regression workhorse
(ray parity: rllib/tuned_examples use CartPole-v1 everywhere).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_env(name: str, creator: Callable[..., Any]):
    """ray parity: ray.tune.register_env."""
    _REGISTRY[name] = creator


def make_env(spec: Any, env_config: Optional[dict] = None):
    if not isinstance(spec, str):
        return spec(env_config or {}) if callable(spec) else spec
    if spec in _REGISTRY:
        return _REGISTRY[spec](env_config or {})
    try:
        import gymnasium as gym

        return gym.make(spec)
    except Exception:
        raise ValueError(f"unknown env {spec!r}") from None


class CartPole:
    """Classic cart-pole, gymnasium API, numpy only
    (dynamics follow the standard formulation)."""

    def __init__(self, env_config: Optional[dict] = None):
        cfg = env_config or {}
        self.max_steps = cfg.get("max_episode_steps", 500)
        self.rng = np.random.default_rng(cfg.get("seed"))
        self.observation_shape = (4,)
        self.num_actions = 2
        self._state = None
        self._t = 0

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self._state = self.rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._t = 0
        return self._state.copy(), {}

    def step(self, action: int):
        x, x_dot, th, th_dot = self._state
        force = 10.0 if action == 1 else -10.0
        g, mc, mp, length = 9.8, 1.0, 0.1, 0.5
        total = mc + mp
        pml = mp * length
        costh, sinth = np.cos(th), np.sin(th)
        temp = (force + pml * th_dot**2 * sinth) / total
        th_acc = (g * sinth - costh * temp) / (
            length * (4.0 / 3.0 - mp * costh**2 / total)
        )
        x_acc = temp - pml * th_acc * costh / total
        tau = 0.02
        x += tau * x_dot
        x_dot += tau * x_acc
        th += tau * th_dot
        th_dot += tau * th_acc
        self._state = np.array([x, x_dot, th, th_dot], dtype=np.float32)
        self._t += 1
        terminated = bool(
            abs(x) > 2.4 or abs(th) > 12 * np.pi / 180
        )
        truncated = self._t >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}

    def close(self):
        pass


register_env("CartPole-native", lambda cfg: CartPole(cfg))


class Reacher1D:
    """Minimal continuous-control env (gymnasium API, numpy only): drive a
    1-D point to a random target with bounded velocity commands. Dense
    quadratic reward; a correct TD3/DDPG solves it in a few thousand steps —
    the continuous learning-regression workhorse, as CartPole is for the
    discrete stack."""

    def __init__(self, env_config: Optional[dict] = None):
        cfg = env_config or {}
        self.max_steps = cfg.get("max_episode_steps", 60)
        self.rng = np.random.default_rng(cfg.get("seed"))
        self.observation_shape = (2,)
        self.action_dim = 1
        self.action_low = np.array([-1.0], np.float32)
        self.action_high = np.array([1.0], np.float32)
        self._pos = 0.0
        self._target = 0.0
        self._t = 0

    def _obs(self):
        return np.array([self._pos, self._target], np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self._pos = float(self.rng.uniform(-1.0, 1.0))
        self._target = float(self.rng.uniform(-1.0, 1.0))
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        self._pos = float(np.clip(self._pos + 0.2 * a, -2.0, 2.0))
        self._t += 1
        err = self._pos - self._target
        reward = -(err * err)
        truncated = self._t >= self.max_steps
        return self._obs(), reward, False, truncated, {}

    def close(self):
        pass


register_env("Reacher1D-native", lambda cfg: Reacher1D(cfg))


def driver_rollouts(env_spec, env_config, act_fn, episodes: int = 5,
                    max_steps: int = 1000, on_reset=None,
                    on_reward=None) -> float:
    """Greedy evaluation rollouts run IN the driver (the harness offline
    algorithms like DT and single-process DreamerV3 share — they have no
    runner gang to evaluate on). ``act_fn(obs) -> action``; optional
    ``on_reset()`` / ``on_reward(r)`` hooks maintain per-episode policy
    context (DT's return conditioning). Returns the mean episode
    return."""
    env = make_env(env_spec, env_config)
    scores = []
    try:
        for _ in range(episodes):
            obs, _info = env.reset()
            if on_reset is not None:
                on_reset()
            total, done, trunc, steps = 0.0, False, False, 0
            while not (done or trunc) and steps < max_steps:
                a = act_fn(obs)
                obs, r, done, trunc, _info = env.step(a)
                if on_reward is not None:
                    on_reward(float(r))
                total += float(r)
                steps += 1
            scores.append(total)
    finally:
        if hasattr(env, "close"):
            env.close()
    return float(np.mean(scores))


def env_spaces(env) -> Tuple[tuple, int]:
    """(observation_shape, num_discrete_actions) for built-in or gym envs."""
    if hasattr(env, "observation_shape"):
        return tuple(env.observation_shape), int(env.num_actions)
    obs_space = env.observation_space
    act_space = env.action_space
    shape = tuple(obs_space.shape)
    n = int(act_space.n)
    return shape, n


def env_action_info(env) -> dict:
    """Action-space descriptor covering both families:
    {"kind": "discrete", "n": int} or
    {"kind": "continuous", "dim": int, "low": array, "high": array}."""
    if hasattr(env, "num_actions"):
        return {"kind": "discrete", "n": int(env.num_actions)}
    if hasattr(env, "action_dim"):
        return {
            "kind": "continuous", "dim": int(env.action_dim),
            "low": np.asarray(env.action_low, np.float32),
            "high": np.asarray(env.action_high, np.float32),
        }
    act_space = env.action_space
    if hasattr(act_space, "n"):
        return {"kind": "discrete", "n": int(act_space.n)}
    low = np.asarray(act_space.low, np.float32).reshape(-1)
    high = np.asarray(act_space.high, np.float32).reshape(-1)
    if not (np.isfinite(low).all() and np.isfinite(high).all()):
        raise ValueError(
            f"continuous action space has non-finite bounds "
            f"(low={low}, high={high}); TD3/DDPG rescale tanh output into "
            f"[low, high] — wrap the env to bound its actions"
        )
    return {
        "kind": "continuous", "dim": int(np.prod(act_space.shape)),
        "low": low, "high": high,
    }


def env_obs_shape(env) -> tuple:
    if hasattr(env, "observation_shape"):
        return tuple(env.observation_shape)
    return tuple(env.observation_space.shape)
