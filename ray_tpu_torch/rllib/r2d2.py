"""R2D2: recurrent-replay DQN (Kapturowski et al. 2019; ray parity:
rllib/algorithms/r2d2).

The Q network carries an LSTM, replay stores SEQUENCES instead of
transitions, and the learner unrolls the recurrent state over each
sequence (optional burn-in prefix excluded from the loss) with double-Q
targets. This is the framework's recurrent-policy path: acting carries
hidden state across env steps, so the policy can integrate information
that is no longer observable — the capability the memory-task test
isolates (a feedforward DQN is provably at chance there).

The LSTM cell is written out as flax's ``OptimizedLSTMCell`` computes it:
one product of ``[x, h]`` with a (D + H, 4H) kernel in flax's gate order
(i, f, g, o), the bias the hidden kernels' (the input kernels have none),
the carry ``(c, h)``; the unroll is a loop over time on the learner's
device (the card unless ``num_gpus_per_learner=0``). Env runners are CPU
actors that never see the card, their epsilon-greedy draws from a
``torch.Generator`` per runner.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import ray_tpu_torch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import env_spaces, make_env, register_env
from ray_tpu_torch.rllib.env_runner import RUNNER_RUNTIME_ENV
from ray_tpu_torch.rllib.learner import TargetNetLearner, _backward, _floats
from ray_tpu_torch.rllib.qmix import _epsilon
from ray_tpu_torch.rllib.rl_module import (
    _TRUNC_STD,
    _dense,
    get_state,
    learner_device,
    set_state,
)

Carry = Tuple[torch.Tensor, torch.Tensor]


class MemoryChainEnv:
    """Memory probe: a cue shown ONLY at t=0 must be acted on at the
    final step. Rewards: +1 for matching the cue at the end, 0 otherwise;
    intermediate steps carry no reward and no cue. Expected return of any
    memoryless policy: 0.5."""

    def __init__(self, env_config: Optional[dict] = None):
        cfg = env_config or {}
        self.length = int(cfg.get("length", 5))
        self.rng = np.random.default_rng(cfg.get("seed"))
        self.observation_shape = (3,)
        self.num_actions = 2
        self._t = 0
        self._cue = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self._t = 0
        self._cue = int(self.rng.integers(2))
        return np.array([1.0, float(self._cue), 0.0], np.float32), {}

    def step(self, action):
        self._t += 1
        done = self._t >= self.length
        if done:
            reward = 1.0 if int(action) == self._cue else 0.0
        else:
            reward = 0.0
        obs = np.array([0.0, 0.0, self._t / self.length], np.float32)
        return obs, reward, done, False, {}


register_env("MemoryChain", lambda cfg: MemoryChainEnv(cfg))


def _lstm_kernel(in_dim: int, hidden: int, gen: torch.Generator
                 ) -> nn.Linear:
    """The (D + H) -> 4H product of flax's ``OptimizedLSTMCell``: per gate a
    LeCun-normal input kernel over ``x`` and an orthogonal recurrent
    kernel over ``h`` (flax's inits), zero biases."""
    layer = nn.Linear(in_dim + hidden, 4 * hidden)
    std = (1.0 / in_dim) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        layer.bias.zero_()
        for g in range(4):
            rows = slice(g * hidden, (g + 1) * hidden)
            w_in = torch.empty(hidden, in_dim)
            nn.init.trunc_normal_(w_in, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            w_h = torch.empty(hidden, hidden)
            nn.init.orthogonal_(w_h, generator=gen)
            layer.weight[rows] = torch.cat([w_in, w_h], dim=1)
    return layer


class LSTMQNet(nn.Module):
    """Dense torso -> LSTM -> Q head, unrolled over time (layers
    ``torso``, ``lstm``, ``q``)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.hidden = hidden
        self.torso = _dense(obs_dim, hidden, gen)
        self.lstm = _lstm_kernel(hidden, hidden, gen)
        self.q = _dense(hidden, num_actions, gen)

    def cell(self, carry: Carry, x: torch.Tensor) -> Carry:
        c, h = carry
        i, f, g, o = self.lstm(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def forward(self, carry: Carry, obs_seq: torch.Tensor):
        # obs_seq: [B, T, D]; carry: LSTM (c, h) each [B, hidden]
        x = torch.relu(self.torso(obs_seq))
        hs = []
        for t in range(x.shape[1]):
            carry = self.cell(carry, x[:, t])
            hs.append(carry[1])
        return carry, self.q(torch.stack(hs, dim=1))  # [B, T, A]

    def initial_carry(self, batch: int) -> Carry:
        zeros = torch.zeros((batch, self.hidden),
                            device=self.q.weight.device)
        return zeros, zeros


class R2D2Module:
    """The net on ``device`` (``None``: the card, raising without one) with
    sequence and single-step Q entry points."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 seed: int = 0, device=None):
        self.num_actions = num_actions
        self.obs_dim = obs_dim
        self.hidden = hidden
        self.device = resolve_device(device)
        self.net = LSTMQNet(obs_dim, num_actions, hidden,
                            torch.Generator().manual_seed(seed)
                            ).to(self.device)

    def _obs(self, obs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def seq_q(self, carry: Carry, obs_seq):
        with torch.no_grad():
            return self.net(carry, self._obs(obs_seq))

    def step_q(self, carry: Carry, obs):
        """(new carry, Q [B, A]) for one observation [B, D]."""
        with torch.no_grad():
            carry, q = self.net(carry, self._obs(obs)[:, None, :])
        return carry, q[:, 0]

    def initial_state(self) -> Carry:
        return self.net.initial_carry(1)

    def get_state(self):
        return get_state(self.net)

    def set_state(self, params):
        set_state(self.net, params)


class SequenceReplayBuffer:
    """Stores fixed-length EPISODE-ALIGNED sequences. Every sequence
    starts at an env reset, where the zero recurrent state is exact — so
    no carry is stored and the learner unrolls from zeros. Extending to
    mid-episode windows requires storing the carry (R2D2's stored-state
    strategy) and making ``burn_in`` load-bearing."""

    def __init__(self, capacity: int = 2_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._seqs: List[Dict[str, np.ndarray]] = []
        self._next = 0
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self._seqs)

    def add(self, seq: Dict[str, np.ndarray]):
        if len(self._seqs) < self.capacity:
            self._seqs.append(seq)
        else:
            self._seqs[self._next] = seq
            self._next = (self._next + 1) % self.capacity

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, len(self._seqs), size=n)
        picked = [self._seqs[i] for i in idx]
        return {
            k: np.stack([p[k] for p in picked]) for k in picked[0]
        }


class R2D2EnvRunner:
    """Epsilon-greedy rollouts carrying LSTM state; emits fixed-length
    episode sequences padded with a validity mask. Its module is on the
    CPU; env seeds come from a numpy generator and the epsilon draws from
    a ``torch.Generator``, both seeded with the runner's seed."""

    def __init__(self, env_spec, env_config, module_kwargs: Dict,
                 seq_len: int, seed: int = 0):
        # one tiny forward a step: a pool of intra-op threads per runner
        # process would only contend for the host's cores
        torch.set_num_threads(1)
        self.env = make_env(env_spec, env_config)
        obs_shape, num_actions = env_spaces(self.env)
        obs_dim = int(np.prod(obs_shape))
        self.module = R2D2Module(obs_dim, num_actions, device="cpu",
                                 **module_kwargs)
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)
        self._returns: List[float] = []

    def ping(self):
        return "pong"

    def set_weights(self, params):
        self.module.set_state(params)

    def _episode(self, epsilon: float):
        obs, _ = self.env.reset(seed=int(self.rng.integers(2**31)))
        carry = self.module.initial_state()
        rows = {k: [] for k in ("obs", "actions", "rewards", "dones")}
        total = 0.0
        for _ in range(self.seq_len):
            carry, q = self.module.step_q(carry, np.asarray(obs)[None, :])
            if epsilon > 0.0 and bool(
                    torch.rand((), generator=self._gen) < epsilon):
                a = int(torch.randint(self.module.num_actions, (),
                                      generator=self._gen))
            else:
                a = int(q[0].argmax())
            nobs, r, term, trunc, _ = self.env.step(a)
            rows["obs"].append(np.asarray(obs, np.float32))
            rows["actions"].append(a)
            rows["rewards"].append(float(r))
            rows["dones"].append(bool(term))
            total += float(r)
            obs = nobs
            if term or trunc:
                break
        # final obs = the bootstrap observation for a truncated/cut
        # sequence (terminal sequences gate it off via dones anyway)
        return rows, total, np.asarray(obs, np.float32)

    def sample(self, num_episodes: int, epsilon: float) -> List[Dict]:
        out = []
        for _ in range(num_episodes):
            rows, total, final_obs = self._episode(epsilon)
            self._returns.append(total)
            T = len(rows["actions"])
            L = self.seq_len
            seq = {
                "obs": np.zeros((L + 1, self.module.obs_dim), np.float32),
                "actions": np.zeros(L, np.int32),
                "rewards": np.zeros(L, np.float32),
                "dones": np.ones(L, bool),
                "mask": np.zeros(L, np.float32),
            }
            seq["obs"][:T] = np.stack(rows["obs"])
            # slot T holds the bootstrap observation: required for
            # truncated (non-terminal) sequences, harmless for terminal
            # ones where dones gates the bootstrap off
            seq["obs"][T] = final_obs
            seq["actions"][:T] = rows["actions"]
            seq["rewards"][:T] = rows["rewards"]
            seq["dones"][:T] = rows["dones"]
            seq["mask"][:T] = 1.0
            out.append(seq)
        return out

    def evaluate(self, num_episodes: int = 20) -> Dict[str, float]:
        totals = [self._episode(0.0)[1] for _ in range(num_episodes)]
        return {"evaluation/episode_return_mean": float(np.mean(totals))}

    def get_metrics(self) -> Dict[str, float]:
        out = {
            "episodes_this_iter": len(self._returns),
            "episode_return_mean": float(np.mean(self._returns))
            if self._returns else float("nan"),
        }
        self._returns = []
        return out


class R2D2Learner(TargetNetLearner):
    """Sequence TD: unroll online + target LSTMs over each sequence,
    double-Q targets per step, masked loss (burn-in prefix excluded);
    optax's global-norm clip (``grad_clip``) and Adam, as ``Learner``'s
    step."""

    def _loss(self, mb):
        burn_in = int(getattr(self.config, "burn_in", 0))
        net, target = self.module.net, self.target_net
        obs_full = mb["obs"]                       # [B, L+1, D]
        carry = net.initial_carry(obs_full.shape[0])
        _, q_all = net(carry, obs_full)             # [B, L+1, A]
        q_sel = q_all[:, :-1].gather(
            -1, mb["actions"].long()[..., None])[..., 0]
        with torch.no_grad():
            _, q_tar_all = target(carry, obs_full)
            # double-Q: online argmax at t+1, target evaluation
            a_star = q_all[:, 1:].argmax(dim=-1)
            q_boot = q_tar_all[:, 1:].gather(-1, a_star[..., None])[..., 0]
            y = mb["rewards"] + self.config.gamma * (
                1.0 - mb["dones"].float()) * q_boot
        td = q_sel - y
        mask = mb["mask"]
        if burn_in > 0:
            mask = mask.clone()
            mask[:, :burn_in] = 0.0
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (mask * td ** 2).sum() / denom
        return loss, ((mask * td.abs()).sum() / denom).detach()

    def update(self, mb: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss, td = self._loss(self._tensors(mb))
        _backward(loss, self.params)
        self._apply_step()
        return _floats({"loss": loss.detach(), "mean_td_error": td})


class R2D2(Algorithm):
    _learner_cls = R2D2Learner

    def setup(self, _config):
        cfg = self._algo_config
        if getattr(cfg, "num_learners", 0) >= 1:
            raise ValueError("num_learners>=1 is not supported for R2D2")
        probe = make_env(cfg.env, cfg.env_config)
        obs_shape, num_actions = env_spaces(probe)
        obs_dim = int(np.prod(obs_shape))
        if hasattr(probe, "close"):
            probe.close()
        module_kwargs = {
            "hidden": cfg.model.get("hidden", 64), "seed": cfg.seed,
        }
        self.module = R2D2Module(
            obs_dim, num_actions,
            device=learner_device(getattr(cfg, "num_gpus_per_learner", 1)),
            **module_kwargs)
        self.learner = R2D2Learner(self.module, cfg)
        runner_cls = ray_tpu_torch.remote(
            num_cpus=0.5, max_restarts=2, max_task_retries=2,
            runtime_env=RUNNER_RUNTIME_ENV,
        )(R2D2EnvRunner)
        self._runner_factory = lambda i, replacement=False: runner_cls.remote(
            cfg.env, cfg.env_config, module_kwargs, cfg.seq_len,
            seed=cfg.seed + i,
        )
        self.runners = [
            self._runner_factory(i) for i in range(cfg.num_env_runners)
        ]
        self.eval_runners = []
        self.buffer = SequenceReplayBuffer(cfg.replay_buffer_capacity,
                                           seed=cfg.seed)
        self._timesteps = 0
        self._since_target_sync = 0

    def _epsilon(self) -> float:
        return _epsilon(self.config, self._timesteps)

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        eps = self._epsilon()
        per_runner = max(1, cfg.episodes_per_iteration // max(
            1, len(self.runners)
        ))
        seq_lists = self._with_runner_ft(lambda: ray_tpu_torch.get([
            r.sample.remote(per_runner, eps) for r in self.runners
        ]))
        for seqs in seq_lists:
            for seq in seqs:
                self._timesteps += int(seq["mask"].sum())
                self.buffer.add(seq)
        if len(self.buffer) < cfg.min_sequences_before_learning:
            return {"buffer_size": len(self.buffer), "epsilon": eps}
        metrics = {}
        for _ in range(cfg.num_epochs):
            metrics = self.learner.update(
                self.buffer.sample(cfg.minibatch_size)
            )
            self._since_target_sync += 1
            if self._since_target_sync >= cfg.target_sync_every_updates:
                self.learner.sync_target()
                self._since_target_sync = 0
        metrics["buffer_size"] = len(self.buffer)
        metrics["epsilon"] = eps
        return metrics

    def evaluate(self) -> Dict:
        self._sync_weights()
        outs = self._with_runner_ft(lambda: ray_tpu_torch.get([
            r.evaluate.remote() for r in self.runners
        ]))
        return {
            "evaluation/episode_return_mean": float(np.mean([
                o["evaluation/episode_return_mean"] for o in outs
            ]))
        }


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(R2D2)
        self.lr = 1e-3
        self.model = {"hidden": 64}
        self.seq_len = 8
        self.burn_in = 0
        self.episodes_per_iteration = 16
        self.replay_buffer_capacity = 2_000
        self.min_sequences_before_learning = 32
        self.minibatch_size = 32
        self.num_epochs = 4
        self.target_sync_every_updates = 16
        self.epsilon = (1.0, 0.05, 3_000)
