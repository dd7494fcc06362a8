"""DreamerV3: model-based RL — learn a latent world model, train the
policy inside its imagination.

Reference parity: ray rllib/algorithms/dreamerv3 (Hafner et al. 2023,
"Mastering Diverse Domains through World Models"), as the JAX package
builds it for vector observations, here in PyTorch on the learner's device
(the card unless ``num_gpus_per_learner=0``): the RSSM unrolls in a loop
over time (posterior pass over replayed sequences, prior pass through
imagination), and the three optimizers step in one update.

Architecture (compact but faithful):
- RSSM: GRU sequence model h' = f(h, z, a) (flax's ``nn.GRUCell`` written
  out: the input products carry biases, the reset and update gates' hidden
  products none, the candidate's hidden product its own bias); categorical
  latents z (``latent_cats`` distributions x ``latent_classes`` classes,
  sampled with straight-through gradients); posterior q(z|h,emb) from the
  obs embedding, prior p(z|h) from h alone.
- Heads from (h, z): decoder (symlog MSE), reward (symlog MSE),
  continue (Bernoulli).
- World-model loss: recon + reward + continue + KL-balanced dynamics /
  representation terms with free bits (the V3 stabilizers).
- Behavior: imagine ``horizon`` steps from every posterior state with
  the actor; critic learns lambda-returns (symlog MSE, slow EMA target
  mixed in); actor is REINFORCE on advantages normalized by a running
  return-percentile range (V3's scale-free trick), plus entropy.

Simplification vs the paper, stated: reward/value use symlog MSE rather
than the two-hot discretized likelihood.

Randomness: latent samples, imagined actions and exploration draw from
one ``torch.Generator`` on the learner's device seeded with ``seed + 1``.
The world-model loss, imagination and the update take the samples as
optional inputs (``Samples``), so another device or the JAX package's own
draws can be replayed through the same arithmetic.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import env_spaces, make_env
from ray_tpu_torch.rllib.learner import _adam, _backward, _frozen_copy
from ray_tpu_torch.rllib.rl_module import (
    _TRUNC_STD,
    _dense,
    get_state,
    learner_device,
    set_state,
)

Tensor = torch.Tensor


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class MLP(nn.Module):
    """Two silu layers and a linear out, flax's auto names ``Dense_0..2``."""

    def __init__(self, in_dim: int, out: int, hidden: int,
                 gen: torch.Generator):
        super().__init__()
        self.Dense_0 = _dense(in_dim, hidden, gen)
        self.Dense_1 = _dense(hidden, hidden, gen)
        self.Dense_2 = _dense(hidden, out, gen)

    def forward(self, x):
        x = F.silu(self.Dense_0(x))
        x = F.silu(self.Dense_1(x))
        return self.Dense_2(x)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r = σ(x W_ir + b_ir + h W_hr), z = σ(x W_iz +
    b_iz + h W_hz), n = tanh(x W_in + b_in + r (h W_hn + b_hn)),
    h' = (1 - z) n + z h. ``ih`` holds the three input kernels and their
    biases (r, z, n), ``hh`` the three hidden kernels, ``hn_bias`` b_hn;
    flax's inits (LeCun-normal input, orthogonal hidden kernels, zero
    biases)."""

    def __init__(self, in_dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.ih = nn.Linear(in_dim, 3 * hidden)
        self.hh = nn.Linear(hidden, 3 * hidden, bias=False)
        self.hn_bias = nn.Parameter(torch.zeros(hidden))
        std = (1.0 / in_dim) ** 0.5 / _TRUNC_STD
        with torch.no_grad():
            self.ih.bias.zero_()
            for g in range(3):
                rows = slice(g * hidden, (g + 1) * hidden)
                w = torch.empty(hidden, in_dim)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=gen)
                self.ih.weight[rows] = w
                w = torch.empty(hidden, hidden)
                nn.init.orthogonal_(w, generator=gen)
                self.hh.weight[rows] = w

    def forward(self, h, x):
        ir, iz, i_n = self.ih(x).chunk(3, dim=-1)
        hr, hz, hn = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * (hn + self.hn_bias))
        return (1.0 - z) * n + z * h


class Samples(NamedTuple):
    """The draws of one update: the posterior latents of the world-model
    pass (L, B, C), and imagination's actions (H, N) and prior latents
    (H, N, C), each a class index."""

    wm_latents: Tensor
    actions: Tensor
    im_latents: Tensor


class DreamerV3Module:
    """The world model (``wm``: encoder, gru, posterior, prior, decoder,
    reward, continue), the actor and the critic on ``device`` (``None``:
    the card, raising without one), as ``nn.Module``s."""

    def __init__(self, obs_dim: int, num_actions: int, cfg, seed: int = 0,
                 device=None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = resolve_device(device)
        U = cfg.units
        C, K = cfg.latent_cats, cfg.latent_classes
        self.C, self.K = C, K
        self.latent_dim = C * K
        self.h_dim = cfg.gru_units
        feat = self.h_dim + self.latent_dim
        gen = torch.Generator().manual_seed(seed)
        self.wm = nn.ModuleDict({
            "encoder": MLP(obs_dim, U, U, gen),            # obs -> embedding
            "gru": GRUCell(self.latent_dim + num_actions, self.h_dim, gen),
            "posterior": MLP(self.h_dim + U, C * K, U, gen),  # [h, emb]
            "prior": MLP(self.h_dim, C * K, U, gen),       # h -> z logits
            "decoder": MLP(feat, obs_dim, U, gen),         # [h, z] -> obs
            "reward": MLP(feat, 1, U, gen),
            "continue": MLP(feat, 1, U, gen),
        }).to(self.device)
        self.actor = MLP(feat, num_actions, U, gen).to(self.device)
        self.critic = MLP(feat, 1, U, gen).to(self.device)

    # -- distribution helpers (categorical latents, straight-through) ---
    def sample_latent(self, logits: Tensor, generator=None,
                      idx: Optional[Tensor] = None):
        """(z, log-probs, class indices): C categorical latents, one-hot,
        straight-through grads. 1% uniform mixing keeps every class
        reachable (V3 unimix). ``idx`` (B, C) replays given draws."""
        B = logits.shape[0]
        lg = logits.reshape(B, self.C, self.K)
        probs = 0.99 * torch.softmax(lg, dim=-1) + 0.01 / self.K
        lg = torch.log(probs)
        if idx is None:
            idx = torch.multinomial(probs.detach().reshape(-1, self.K), 1,
                                    generator=generator).reshape(B, self.C)
        onehot = F.one_hot(idx.long(), self.K).to(probs.dtype)
        st = onehot + probs - probs.detach()
        return st.reshape(B, self.C * self.K), lg, idx

    def obs_step(self, h, z, a_onehot, obs, generator=None, idx=None):
        """One posterior step: advance the GRU, infer q(z'|h',emb)."""
        emb = self.wm["encoder"](symlog(obs))
        h2 = self.wm["gru"](h, torch.cat([z, a_onehot], -1))
        post_logits = self.wm["posterior"](torch.cat([h2, emb], -1))
        z2, post_lg, idx = self.sample_latent(post_logits, generator, idx)
        return h2, z2, post_lg, idx

    def get_state(self):
        return {"wm": get_state(self.wm), "actor": get_state(self.actor),
                "critic": get_state(self.critic)}

    def set_state(self, state):
        set_state(self.wm, state["wm"])
        set_state(self.actor, state["actor"])
        set_state(self.critic, state["critic"])


def _kl_categorical(lg_p, lg_q):
    """KL(p || q) for stacked categorical latents, summed over cats."""
    p = torch.softmax(lg_p, dim=-1)
    return torch.sum(p * (torch.log_softmax(lg_p, dim=-1)
                          - torch.log_softmax(lg_q, dim=-1)), dim=(-2, -1))


class DreamerV3(Algorithm):
    """Single-process Dreamer: one collector env in the driver, the world
    model and behavior nets on the learner's device (ray parity:
    dreamerv3 runs a single EnvRunner too)."""

    def setup(self, _config):
        cfg = self._algo_config
        self.env = make_env(cfg.env, getattr(cfg, "env_config", None))
        obs_shape, num_actions = env_spaces(self.env)
        obs_dim = int(np.prod(obs_shape))
        device = learner_device(getattr(cfg, "num_gpus_per_learner", 1))
        self.module = DreamerV3Module(obs_dim, num_actions, cfg,
                                      seed=cfg.seed, device=device)
        m = self.module
        self._gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        self.np_rng = np.random.default_rng(cfg.seed)
        self._init_optimizers()
        self.critic_ema = _frozen_copy(m.critic)

        # episodic replay of full sequences
        self._episodes: list = []
        self._buffer_steps = 0
        self._ep: Dict[str, list] = {"obs": [], "actions": [], "rewards": [],
                                     "continues": []}
        self._obs, _ = self.env.reset(seed=cfg.seed)
        self._reset_latent()
        self._timesteps = 0
        self._returns_q = []  # recent episode returns (reporting)
        # running 5th..95th percentile spread, on the device
        self._ret_range = torch.ones((), device=device)
        self.runners = []
        self.eval_runners = []

    def _init_optimizers(self):
        cfg, m = self._algo_config, self.module
        self.wm_opt = _adam(m.wm.parameters(), cfg.wm_lr)
        self.actor_opt = _adam(m.actor.parameters(), cfg.actor_lr)
        self.critic_opt = _adam(m.critic.parameters(), cfg.critic_lr)

    def _reset_latent(self):
        m = self.module
        self._h = torch.zeros((1, m.h_dim), device=m.device)
        self._z = torch.zeros((1, m.latent_dim), device=m.device)

    # ------------------------------------------------------------------
    def wm_loss(self, batch: Dict[str, Tensor], latents=None):
        """(loss, feat (B, L, h + z), metrics, the posterior draws (L, B,
        C)). Alignment convention: state s_t = f(s_{t-1}, a_{t-1}, obs_t) —
        the GRU consumes the PREVIOUS action with the current observation;
        heads at s_t predict the reward/continue received ON ENTERING obs_t
        (rewards[t-1]). Matches how imagination collects rewards at
        arrived-at states."""
        m, cfg = self.module, self.config
        B, L = batch["actions"].shape
        a_onehot = F.one_hot(batch["actions"].long(), m.num_actions).float()
        prev_a = torch.cat([torch.zeros_like(a_onehot[:, :1]),
                            a_onehot[:, :-1]], 1)
        r_in = torch.cat([torch.zeros_like(batch["rewards"][:, :1]),
                          batch["rewards"][:, :-1]], 1)
        c_in = torch.cat([torch.ones_like(batch["continues"][:, :1]),
                          batch["continues"][:, :-1]], 1)
        h = torch.zeros((B, m.h_dim), device=m.device)
        z = torch.zeros((B, m.latent_dim), device=m.device)
        feats, posts, priors, draws = [], [], [], []
        for t in range(L):
            h, z, post_lg, idx = m.obs_step(
                h, z, prev_a[:, t], batch["obs"][:, t], self._gen,
                None if latents is None else latents[t])
            priors.append(m.wm["prior"](h).reshape(B, m.C, m.K))
            feats.append(torch.cat([h, z], -1))
            posts.append(post_lg)
            draws.append(idx)
        feat = torch.stack(feats, 1)
        post_lg, prior_lg = torch.stack(posts, 1), torch.stack(priors, 1)

        recon = m.wm["decoder"](feat)
        rew = m.wm["reward"](feat)[..., 0]
        cont = m.wm["continue"](feat)[..., 0]
        # masked means over the TOTAL element count: short episodes
        # zero-pad their sequences, and the per-element gradient scale
        # stays that of an unpadded batch
        mask = batch["mask"]
        denom = float(B * L)

        def mmean(x):
            return torch.sum(x * mask) / denom

        l_recon = mmean(torch.sum((recon - symlog(batch["obs"])) ** 2, -1))
        l_rew = mmean((rew - symlog(r_in)) ** 2)
        l_cont = mmean(F.binary_cross_entropy_with_logits(
            cont, c_in, reduction="none"))
        # KL balance: dynamics pushes prior -> sg(posterior),
        # representation pushes posterior -> sg(prior); free bits
        # clip each below 1 nat
        dyn = _kl_categorical(post_lg.detach(), prior_lg)
        rep = _kl_categorical(post_lg, prior_lg.detach())
        l_kl = mmean(0.5 * torch.clamp(dyn, min=cfg.free_bits)
                     + 0.1 * torch.clamp(rep, min=cfg.free_bits))
        loss = l_recon + l_rew + l_cont + l_kl
        metrics = {"wm_loss": loss, "recon_loss": l_recon,
                   "reward_loss": l_rew, "kl_loss": l_kl}
        return loss, feat, metrics, torch.stack(draws)

    def imagine(self, feat0: Tensor, actions=None, latents=None):
        """Roll the prior forward ``horizon`` steps with the actor, without
        gradients: the policy's training data is entirely imagined (V3's
        core move). Yields each decision state feat_t, the action taken
        and the ARRIVED-AT state feat_{t+1} whose reward/continue heads
        price the transition, (H, N, ...), and the prior draws (H, N, C).
        ``actions`` (H, N) and ``latents`` (H, N, C) replay given draws."""
        m = self.module
        h, z = feat0[:, :m.h_dim], feat0[:, m.h_dim:]
        feats, acts, feats_next, draws = [], [], [], []
        with torch.no_grad():
            for t in range(self.config.horizon):
                feat = torch.cat([h, z], -1)
                if actions is None:
                    a = torch.multinomial(torch.softmax(m.actor(feat), -1),
                                          1, generator=self._gen)[:, 0]
                else:
                    a = actions[t].long()
                a_onehot = F.one_hot(a, m.num_actions).float()
                h = m.wm["gru"](h, torch.cat([z, a_onehot], -1))
                z, _, idx = m.sample_latent(
                    m.wm["prior"](h), self._gen,
                    None if latents is None else latents[t])
                feats.append(feat)
                acts.append(a)
                feats_next.append(torch.cat([h, z], -1))
                draws.append(idx)
        return (torch.stack(feats), torch.stack(acts), torch.stack(feats_next),
                torch.stack(draws))

    def behavior_loss(self, feat0: Tensor, mask0: Tensor, ret_range,
                      actions=None, latents=None):
        """(actor + critic loss, actor loss, critic loss, lambda-returns
        (H, N), imagined actions, prior draws); gradients reach the actor
        and the critic only."""
        m, cfg = self.module, self.config
        H = cfg.horizon
        gamma, lam = cfg.gamma, cfg.lambda_
        feats, acts, feats_next, draws = self.imagine(feat0.detach(),
                                                      actions, latents)
        pred = m.critic(feats)[..., 0]
        with torch.no_grad():
            # transition t: from feats[t] via acts[t] -> feats_next[t]; the
            # world model prices the ARRIVED state
            rew = symexp(m.wm["reward"](feats_next)[..., 0])
            cont = torch.sigmoid(m.wm["continue"](feats_next)[..., 0])
            disc = gamma * cont
            v = symexp(pred)
            v_next = symexp(m.critic(feats_next)[..., 0])
            v_ema = symexp(self.critic_ema(feats)[..., 0])
            # lambda-returns, backward: G_t = r_{t+1} + gamma*c_{t+1} *
            # ((1-lam) V(s_{t+1}) + lam G_{t+1})
            rets = torch.empty_like(rew)
            nxt = v_next[-1]
            for t in range(H - 1, -1, -1):
                nxt = rew[t] + disc[t] * ((1 - lam) * v_next[t] + lam * nxt)
                rets[t] = nxt
        # imagined trajectories launched from PAD states carry no signal:
        # weight every per-trajectory term by the start state's validity
        w = mask0[None, :]
        wdenom = float(mask0.shape[0] * H)  # total, not valid: see wm_loss

        def wmean(x):
            return torch.sum(x * w) / wdenom

        # critic: symlog MSE to lambda-returns + EMA regularizer
        l_critic = wmean((pred - symlog(rets)) ** 2) \
            + 0.1 * wmean((pred - symlog(v_ema)) ** 2)
        # actor: REINFORCE on percentile-normalized advantages
        adv = (rets - v) / ret_range
        logits = m.actor(feats)
        logp = torch.log_softmax(logits, dim=-1)
        a_logp = logp.gather(-1, acts[..., None])[..., 0]
        ent = -torch.sum(torch.softmax(logits, dim=-1) * logp, -1)
        l_actor = -wmean(a_logp * adv) - cfg.entropy_coeff * wmean(ent)
        return l_actor + l_critic, l_actor, l_critic, rets, acts, draws

    def train_step(self, batch: Dict[str, np.ndarray],
                   samples: Optional[Samples] = None):
        """One update of all three nets on one batch: (metrics as tensors
        on the device, the samples it drew or was given)."""
        m = self.module
        tb = {k: torch.as_tensor(np.asarray(v), device=m.device)
              for k, v in batch.items()}
        wm_params = list(m.wm.parameters())
        wm_l, feat, metrics, wm_latents = self.wm_loss(
            tb, None if samples is None else samples.wm_latents)
        _backward(wm_l, wm_params)
        self.wm_opt.step()

        feat0 = feat.reshape(-1, feat.shape[-1])
        mask0 = tb["mask"].reshape(-1)
        total, l_a, l_c, rets, acts, im_latents = self.behavior_loss(
            feat0, mask0, self._ret_range,
            *(() if samples is None else samples[1:]))
        ac_params = list(m.actor.parameters()) + list(m.critic.parameters())
        _backward(total, ac_params)
        self.actor_opt.step()
        self.critic_opt.step()
        with torch.no_grad():
            for e, p in zip(self.critic_ema.parameters(),
                            m.critic.parameters()):
                e.copy_(0.98 * e + 0.02 * p)
            # running 5..95 percentile spread of imagined returns
            flat = rets.reshape(-1)
            spread = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
            self._ret_range = torch.clamp(
                0.99 * self._ret_range + 0.01 * spread, min=1.0)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update({"actor_loss": l_a.detach(),
                        "critic_loss": l_c.detach(),
                        "return_range": self._ret_range})
        return metrics, Samples(wm_latents, acts, im_latents)

    # ------------------------------------------------------------------
    def _policy_step(self, h, z, a_prev: Optional[int], obs, explore: bool):
        """(h', z', action): one posterior step from the previous action
        (``None`` at an episode's start) and ``obs``, then the actor's
        sample (``explore``) or argmax."""
        m = self.module
        with torch.no_grad():
            a_onehot = torch.zeros((1, m.num_actions), device=m.device)
            if a_prev is not None:
                a_onehot[0, a_prev] = 1.0
            obs_t = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                    device=m.device)
            h, z, _, _ = m.obs_step(h, z, a_onehot, obs_t, self._gen)
            logits = m.actor(torch.cat([h, z], -1))
            if explore:
                a = torch.multinomial(torch.softmax(logits, -1), 1,
                                      generator=self._gen)[0, 0]
            else:
                a = logits[0].argmax()
        return h, z, int(a)

    def _act(self, obs, explore: bool) -> int:
        prev = self._ep["actions"][-1] if self._ep["actions"] else None
        self._h, self._z, a = self._policy_step(self._h, self._z, prev, obs,
                                                explore)
        return a

    def _collect(self, steps: int):
        for _ in range(steps):
            a = self._act(self._obs, explore=True)
            obs2, r, done, trunc, _ = self.env.step(a)
            ep = self._ep
            ep["obs"].append(np.asarray(self._obs, np.float32))
            ep["actions"].append(a)
            ep["rewards"].append(float(r))
            ep["continues"].append(0.0 if done else 1.0)
            self._obs = obs2
            self._timesteps += 1
            if done or trunc:
                self._returns_q.append(sum(ep["rewards"]))
                self._returns_q = self._returns_q[-32:]
                self._store_episode()
                self._obs, _ = self.env.reset()
                self._reset_latent()

    def _store_episode(self):
        ep = {k: np.asarray(v) for k, v in self._ep.items()}
        if len(ep["actions"]) >= 2:
            self._episodes.append(ep)
            self._buffer_steps += len(ep["actions"])
        self._ep = {"obs": [], "actions": [], "rewards": [],
                    "continues": []}
        cap = self.config.replay_capacity
        while self._buffer_steps > cap and len(self._episodes) > 1:
            gone = self._episodes.pop(0)
            self._buffer_steps -= len(gone["actions"])

    def _sample_batch(self):
        cfg = self.config
        B, L = cfg.batch_size, cfg.batch_length
        m = self.module
        out = {"obs": np.zeros((B, L, m.obs_dim), np.float32),
               "actions": np.zeros((B, L), np.int32),
               "rewards": np.zeros((B, L), np.float32),
               "continues": np.ones((B, L), np.float32),
               "mask": np.zeros((B, L), np.float32)}
        for b in range(B):
            ep = self._episodes[self.np_rng.integers(len(self._episodes))]
            T = len(ep["actions"])
            start = int(self.np_rng.integers(max(1, T - L + 1)))
            n = min(L, T - start)
            out["obs"][b, :n] = ep["obs"][start:start + n]
            out["actions"][b, :n] = ep["actions"][start:start + n]
            out["rewards"][b, :n] = ep["rewards"][start:start + n]
            out["continues"][b, :n] = ep["continues"][start:start + n]
            out["mask"][b, :n] = 1.0
        return out

    # ------------------------------------------------------------------
    def training_step(self) -> Dict:
        cfg = self.config
        self._collect(cfg.env_steps_per_iteration)
        if self._buffer_steps < cfg.num_steps_before_learning:
            return {"buffer_steps": self._buffer_steps,
                    "episode_return_mean": float(np.mean(self._returns_q))
                    if self._returns_q else None}
        metrics = {}
        for _ in range(cfg.train_steps_per_iteration):
            metrics, _ = self.train_step(self._sample_batch())
        out = {k: float(v) for k, v in metrics.items()}
        out["buffer_steps"] = self._buffer_steps
        if self._returns_q:
            out["episode_return_mean"] = float(np.mean(self._returns_q))
        return out

    def step(self) -> Dict:
        metrics = self.training_step()
        metrics = {k: v for k, v in metrics.items() if v is not None}
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        self._train_iter = getattr(self, "_train_iter", 0) + 1
        return metrics

    def evaluate(self, episodes: int = 5) -> Dict:
        from ray_tpu_torch.rllib.env import driver_rollouts

        m = self.module
        state = {}

        def on_reset():
            state["h"] = torch.zeros((1, m.h_dim), device=m.device)
            state["z"] = torch.zeros((1, m.latent_dim), device=m.device)
            state["a_prev"] = None

        def act(obs):
            state["h"], state["z"], a = self._policy_step(
                state["h"], state["z"], state["a_prev"], obs, False)
            state["a_prev"] = a
            return a

        score = driver_rollouts(
            self.config.env, getattr(self.config, "env_config", None),
            act, episodes=episodes, on_reset=on_reset,
        )
        return {"evaluation": {"episode_return_mean": score,
                               "num_episodes": episodes}}

    def cleanup(self):
        if hasattr(self.env, "close"):
            try:
                self.env.close()
            except Exception:
                pass
        super().cleanup()


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(DreamerV3)
        # world model
        self.units = 128
        self.gru_units = 128
        self.latent_cats = 8
        self.latent_classes = 8
        self.wm_lr = 6e-4
        # behavior
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.horizon = 15
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.entropy_coeff = 3e-3
        self.free_bits = 1.0
        # replay / cadence
        self.replay_capacity = 50_000
        self.batch_size = 8
        self.batch_length = 32
        self.env_steps_per_iteration = 200
        self.train_steps_per_iteration = 8
        self.num_steps_before_learning = 400
        self.num_env_runners = 0
