"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing.

Reference parity: ray rllib/algorithms/qmix (Rashid et al. 2018). Each
agent runs a shared Q network over (obs, agent-id); a hypernetwork mixer
conditioned on the GLOBAL state combines per-agent chosen-action Qs into
Q_tot with non-negative mixing weights, so argmax decentralization is
consistent with the centralized TD target (Individual-Global-Max).

The agent net and the mixer are one ``nn.ModuleDict`` (state names
``agent.fc_0.weight``, ``mixer.hyper_w1.bias``, ...); the learner and its
target copy sit where ``num_gpus_per_learner`` puts them (the card by
default). Rollouts run on CPU env-runner actors that never see the card,
their epsilon-greedy draws from a ``torch.Generator`` per runner.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

import ray_tpu_torch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_env, register_env
from ray_tpu_torch.rllib.env_runner import RUNNER_RUNTIME_ENV
from ray_tpu_torch.rllib.learner import (
    TargetNetLearner,
    _backward,
    _floats,
)
from ray_tpu_torch.rllib.multi_agent import MultiAgentEnv
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.rl_module import (
    _dense,
    _torso,
    get_state,
    learner_device,
    set_state,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class TwoStepCoopGame(MultiAgentEnv):
    """The two-step cooperative matrix game from the QMIX paper (§6.1):
    agent 0's first action selects a branch; the second step pays a team
    reward from that branch's payoff matrix. Branch B's optimum (8)
    requires BOTH agents to coordinate on action 1, while its safe play
    pays less than branch A's flat 7 — exactly the structure where
    per-agent (VDN-style additive) values pick the wrong branch and a
    state-conditioned monotonic mixer is needed."""

    PAYOFF_B = np.array([[0.0, 1.0], [1.0, 8.0]], np.float32)

    def __init__(self, env_config: Optional[dict] = None):
        self.agent_ids = ["agent_0", "agent_1"]
        self.observation_shape = (3,)  # one-hot of {start, branchA, branchB}
        self.num_actions = 2
        self.state_dim = 3
        self._state = 0

    def _obs(self):
        o = np.zeros(3, np.float32)
        o[self._state] = 1.0
        return {aid: o.copy() for aid in self.agent_ids}

    def state(self) -> np.ndarray:
        s = np.zeros(3, np.float32)
        s[self._state] = 1.0
        return s

    def reset(self, *, seed=None, options=None):
        self._state = 0
        return self._obs(), {}

    def step(self, action_dict: Dict[str, Any]):
        if self._state == 0:
            self._state = 1 if int(action_dict["agent_0"]) == 0 else 2
            obs = self._obs()
            return (obs, {a: 0.0 for a in self.agent_ids},
                    {"__all__": False}, {"__all__": False}, {})
        if self._state == 1:
            r = 7.0
        else:
            r = float(self.PAYOFF_B[int(action_dict["agent_0"]),
                                    int(action_dict["agent_1"])])
        self._state = 0
        obs = self._obs()
        rew = {a: r for a in self.agent_ids}
        return obs, rew, {"__all__": True}, {"__all__": False}, {}


register_env("TwoStepCoop", lambda cfg: TwoStepCoopGame(cfg))


class AgentQNet(nn.Module):
    """Shared per-agent Q network over (obs ++ one-hot agent id): relu
    ``fc_i`` layers and a ``q`` head."""

    def __init__(self, in_dim: int, num_actions: int, hiddens=(64,),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.n_hidden = len(hiddens)
        width = _torso("", in_dim, hiddens, gen, self)
        self.q = _dense(width, num_actions, gen)

    def forward(self, x):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.q(x)


class QMixer(nn.Module):
    """Monotonic mixing hypernetwork: Q_tot(s, q_1..q_n) with
    dQ_tot/dq_a >= 0 enforced by abs() on the generated weights."""

    def __init__(self, n_agents: int, state_dim: int, embed_dim: int = 32,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.n_agents, self.embed_dim = n_agents, embed_dim
        self.hyper_w1 = _dense(state_dim, n_agents * embed_dim, gen)
        self.hyper_b1 = _dense(state_dim, embed_dim, gen)
        self.hyper_w2 = _dense(state_dim, embed_dim, gen)
        self.hyper_b2_hid = _dense(state_dim, embed_dim, gen)
        self.hyper_b2_out = _dense(embed_dim, 1, gen)

    def forward(self, agent_qs, state):
        B = agent_qs.shape[0]
        w1 = torch.abs(self.hyper_w1(state)).reshape(
            B, self.n_agents, self.embed_dim)
        b1 = self.hyper_b1(state)
        h = nn.functional.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
        w2 = torch.abs(self.hyper_w2(state))
        b2 = self.hyper_b2_out(torch.relu(self.hyper_b2_hid(state)))[..., 0]
        return torch.einsum("be,be->b", h, w2) + b2


def per_agent_q(net: nn.ModuleDict, obs_id: torch.Tensor) -> torch.Tensor:
    """[B, n_agents, A] from obs_id [B, n_agents, obs_dim + n_agents]."""
    B, n, d = obs_id.shape
    return net["agent"](obs_id.reshape(B * n, d)).reshape(B, n, -1)


class QMixModule:
    """Agent net + mixer on ``device`` (``None``: the card, raising
    without one) with a greedy-action entry point over numpy."""

    def __init__(self, obs_dim: int, n_agents: int, num_actions: int,
                 state_dim: int, hiddens: tuple = (64,),
                 embed_dim: int = 32, seed: int = 0, device=None):
        self.n_agents = n_agents
        self.num_actions = num_actions
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.net = nn.ModuleDict({
            "agent": AgentQNet(obs_dim + n_agents, num_actions,
                               tuple(hiddens), gen),
            "mixer": QMixer(n_agents, state_dim, embed_dim, gen),
        }).to(self.device)
        self.agent_net, self.mixer = self.net["agent"], self.net["mixer"]

    def per_agent_q(self, obs_id) -> torch.Tensor:
        with torch.no_grad():
            return per_agent_q(self.net, torch.as_tensor(
                np.asarray(obs_id, np.float32), device=self.device))

    def actions_greedy(self, obs_id: np.ndarray) -> np.ndarray:
        return self.per_agent_q(obs_id).argmax(dim=-1).cpu().numpy()

    def get_state(self):
        return get_state(self.net)

    def set_state(self, params):
        set_state(self.net, params)


def _stack_obs(obs: Dict[str, np.ndarray], agent_ids: List[str]) -> np.ndarray:
    """[n_agents, obs_dim + n_agents]: per-agent obs ++ one-hot agent id
    (the shared-net convention; ray parity: QMIX agent grouping)."""
    n = len(agent_ids)
    rows = []
    for i, aid in enumerate(agent_ids):
        onehot = np.zeros(n, np.float32)
        onehot[i] = 1.0
        rows.append(np.concatenate([np.asarray(obs[aid], np.float32), onehot]))
    return np.stack(rows)


def _state_dim(env, n_agents: int) -> int:
    return getattr(env, "state_dim",
                   int(np.prod(env.observation_shape)) * n_agents)


class QMixEnvRunner:
    """Joint-transition collector: steps ALL agents with epsilon-greedy
    actions from the shared net, records (obs, state, actions, team
    reward, done) tuples. Its module is on the CPU; its epsilon draws come
    from a ``torch.Generator`` seeded with the runner's seed."""

    def __init__(self, env_spec, env_config, module_kwargs: Dict,
                 seed: int = 0):
        # one tiny forward a step: a pool of intra-op threads per runner
        # process would only contend for the host's cores
        torch.set_num_threads(1)
        self.env = make_env(env_spec, env_config)
        self.agent_ids = list(self.env.agent_ids)
        self.module = QMixModule(
            obs_dim=int(np.prod(self.env.observation_shape)),
            n_agents=len(self.agent_ids),
            num_actions=self.env.num_actions,
            state_dim=_state_dim(self.env, len(self.agent_ids)),
            device="cpu", **module_kwargs,
        )
        self._gen = torch.Generator().manual_seed(seed)
        self._obs = None
        self._last_obs: Dict[str, np.ndarray] = {}
        self._ep_return = 0.0
        self._returns: List[float] = []

    def set_weights(self, params):
        self.module.set_state(params)

    def ping(self):
        return "pong"

    def evaluate(self, num_episodes: int = 5):
        returns = []
        for _ in range(num_episodes):
            obs, _ = self.env.reset()
            self._last_obs = dict(obs)
            total, done = 0.0, False
            while not done:
                stacked = _stack_obs(self._last_obs, self.agent_ids)
                a = self.module.actions_greedy(stacked[None])[0]
                acts = {aid: int(a[i])
                        for i, aid in enumerate(self.agent_ids)}
                nobs, rew, term, trunc, _ = self.env.step(acts)
                self._last_obs.update(nobs)
                total += float(sum(rew.values())) / max(1, len(rew))
                done = bool(term.get("__all__")) or bool(trunc.get("__all__"))
            returns.append(total)
        self._obs = None  # force fresh reset for the next sample()
        return {"evaluation/episode_return_mean": float(np.mean(returns))}

    def _state_vec(self) -> np.ndarray:
        if hasattr(self.env, "state"):
            return np.asarray(self.env.state(), np.float32)
        return np.concatenate(
            [np.asarray(self._last_obs[a], np.float32)
             for a in self.agent_ids]
        )

    def _explore(self, epsilon: float) -> bool:
        return bool(torch.rand((), generator=self._gen) < epsilon)

    def sample(self, num_steps: int, epsilon: float) -> SampleBatch:
        if self._obs is None:
            self._obs, _ = self.env.reset()
            self._last_obs = dict(self._obs)
            self._ep_return = 0.0
        cols: Dict[str, list] = {k: [] for k in (
            "obs", "next_obs", "state", "next_state", "actions", "rewards",
            "dones",
        )}
        for _ in range(num_steps):
            stacked = _stack_obs(self._last_obs, self.agent_ids)
            state = self._state_vec()
            greedy = self.module.actions_greedy(stacked[None])[0]
            acts = {}
            for i, aid in enumerate(self.agent_ids):
                if self._explore(epsilon):
                    acts[aid] = int(torch.randint(
                        self.env.num_actions, (), generator=self._gen))
                else:
                    acts[aid] = int(greedy[i])
            nobs, rew, term, trunc, _ = self.env.step(acts)
            # done agents drop out of the env's dicts; keep their last obs
            # so the joint stack stays well-defined until "__all__"
            self._last_obs.update(nobs)
            terminated = bool(term.get("__all__"))
            episode_over = terminated or bool(trunc.get("__all__"))
            team_r = float(sum(rew.values())) / max(1, len(rew))
            self._ep_return += team_r
            cols["obs"].append(stacked)
            cols["next_obs"].append(_stack_obs(self._last_obs, self.agent_ids))
            cols["state"].append(state)
            cols["next_state"].append(self._state_vec())
            cols["actions"].append(
                np.asarray([acts[a] for a in self.agent_ids], np.int32)
            )
            cols["rewards"].append(team_r)
            # sb.DONES contract: terminated ONLY — a time-limit truncation
            # must keep the TD bootstrap alive
            cols["dones"].append(terminated)
            if episode_over:
                self._returns.append(self._ep_return)
                self._obs, _ = self.env.reset()
                self._last_obs = dict(self._obs)
                self._ep_return = 0.0
        return SampleBatch({
            k: np.asarray(v) for k, v in cols.items()
        })

    def get_metrics(self) -> Dict[str, float]:
        out = {
            "episodes_this_iter": len(self._returns),
            "episode_return_mean": float(np.mean(self._returns))
            if self._returns else float("nan"),
        }
        self._returns = []
        return out


class QMixLearner(TargetNetLearner):
    """Centralized TD on Q_tot with a target agent net + target mixer:
    optax's global-norm clip (``grad_clip``) and Adam, as ``Learner``'s
    step."""

    def _loss(self, mb):
        net, target = self.module.net, self.target_net
        q_sel = per_agent_q(net, mb["obs"]).gather(
            -1, mb["actions"].long()[..., None])[..., 0]  # [B, n]
        q_tot = net["mixer"](q_sel, mb["state"])
        with torch.no_grad():
            # double-Q at the team level: online argmax, target evaluation
            a_star = per_agent_q(net, mb["next_obs"]).argmax(dim=-1)
            q_next_sel = per_agent_q(target, mb["next_obs"]).gather(
                -1, a_star[..., None])[..., 0]
            target_tot = target["mixer"](q_next_sel, mb["next_state"])
            y = mb["rewards"] + self.config.gamma * (
                1.0 - mb["dones"].float()) * target_tot
        td = q_tot - y
        return (td ** 2).mean(), td.detach().abs().mean()

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        loss, td = self._loss(self._tensors(batch))
        _backward(loss, self.params)
        self._apply_step()
        return _floats({"loss": loss.detach(), "mean_td_error": td})


def _epsilon(config, timesteps: int) -> float:
    start, end, decay = config.epsilon
    frac = min(1.0, timesteps / max(1, decay))
    return float(start + (end - start) * frac)


class QMIX(Algorithm):
    _learner_cls = QMixLearner

    def setup(self, _config):
        cfg = self._algo_config
        if getattr(cfg, "num_learners", 0) >= 1:
            raise ValueError("num_learners>=1 is not supported for QMIX")
        probe = make_env(cfg.env, cfg.env_config)
        agent_ids = list(probe.agent_ids)
        obs_dim = int(np.prod(probe.observation_shape))
        state_dim = _state_dim(probe, len(agent_ids))
        num_actions = probe.num_actions
        if hasattr(probe, "close"):
            probe.close()
        module_kwargs = {
            "hiddens": tuple(cfg.model.get("hiddens", (64,))),
            "embed_dim": getattr(cfg, "mixing_embed_dim", 32),
            "seed": cfg.seed,
        }
        self.module = QMixModule(
            obs_dim, len(agent_ids), num_actions, state_dim,
            device=learner_device(getattr(cfg, "num_gpus_per_learner", 1)),
            **module_kwargs)
        self.learner = QMixLearner(self.module, cfg)
        runner_cls = ray_tpu_torch.remote(
            num_cpus=0.5, max_restarts=2, max_task_retries=2,
            runtime_env=RUNNER_RUNTIME_ENV,
        )(QMixEnvRunner)
        self._runner_factory = lambda i, replacement=False: runner_cls.remote(
            cfg.env, cfg.env_config, module_kwargs, seed=cfg.seed + i,
        )
        self.runners = [
            self._runner_factory(i) for i in range(cfg.num_env_runners)
        ]
        self.eval_runners = []
        self.agent_ids = agent_ids
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._timesteps = 0
        self._since_target_sync = 0

    def _epsilon(self) -> float:
        return _epsilon(self.config, self._timesteps)

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        eps = self._epsilon()
        frags = self._with_runner_ft(lambda: ray_tpu_torch.get([
            r.sample.remote(cfg.rollout_fragment_length, eps)
            for r in self.runners
        ]))
        for frag in frags:
            self._timesteps += frag.count
            self.buffer.add(frag)
        if len(self.buffer) < cfg.num_steps_sampled_before_learning:
            return {"buffer_size": len(self.buffer), "epsilon": eps}
        metrics = {}
        for _ in range(cfg.num_epochs):
            metrics = self.learner.update(
                self.buffer.sample(cfg.minibatch_size)
            )
            self._since_target_sync += 1
            if self._since_target_sync >= max(
                1, cfg.target_network_update_freq // cfg.minibatch_size
            ):
                self.learner.sync_target()
                self._since_target_sync = 0
        metrics["buffer_size"] = len(self.buffer)
        metrics["epsilon"] = eps
        return metrics

    def compute_actions(self, obs: Dict[str, np.ndarray]) -> Dict[str, int]:
        """Greedy joint action for one env step (decentralized
        execution). Agents are ordered exactly as during training
        (env.agent_ids) — sorting obs keys would permute the one-hot
        agent IDs once ids reach double digits. The net's input layout is
        fixed at n_agents slots, so stacking a subset would both shrink
        the input dim and permute the id one-hots; all agents must be
        observed every step (the runner guarantees this)."""
        missing = [a for a in self.agent_ids if a not in obs]
        if missing:
            raise ValueError(
                f"QMIX.compute_actions needs an observation for every "
                f"agent; missing {missing}. The joint Q network stacks "
                f"all {len(self.agent_ids)} agents' obs in training "
                f"order — a partial dict would misalign the agent-id "
                f"encoding."
            )
        ids = list(self.agent_ids)
        stacked = _stack_obs(obs, ids)
        a = self.module.actions_greedy(stacked[None])[0]
        return {aid: int(a[i]) for i, aid in enumerate(ids)}


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(QMIX)
        self.lr = 5e-4
        self.mixing_embed_dim = 32
        self.model = {"hiddens": (64,)}
        self.epsilon = (1.0, 0.05, 2_000)
        self.replay_buffer_capacity = 20_000
        self.target_network_update_freq = 200
        self.num_steps_sampled_before_learning = 200
        self.minibatch_size = 64
        self.num_epochs = 4
