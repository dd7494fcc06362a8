"""Decision Transformer: offline RL as return-conditioned sequence
modeling (Chen et al. 2021; ray parity: rllib/algorithms/dt).

The policy is a small causal transformer over interleaved
(return-to-go, state, action) token triples; training is supervised
action prediction on offline episodes, and acting conditions the model
on a TARGET return — ask for a high return and the model extrapolates
the behavior that achieved high returns in the data.

The model is an ``nn.Module`` on the learner's device (the card unless
``num_gpus_per_learner=0``); its attention is the port's own
``ops.attention.flash_attention`` on (B, H, 3K, D), causal: on the card
the three sm_90a flash kernels in f32 (the forward while acting, all three
while training), on the CPU their plain versions. Flax's defaults are
kept: LayerNorm eps 1e-6, the tanh GELU, LeCun-normal Dense kernels and
N(0, 1/d) embeddings; the optimizer is ``optax.adamw(lr,
weight_decay=1e-4)`` as ``torch.optim.AdamW`` (decoupled decay scaled by
the lr, on every parameter).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import _opt_state
from ray_tpu_torch.rllib.offline import read_json_fragments
from ray_tpu_torch.rllib.rl_module import (
    _dense,
    get_state,
    learner_device,
    set_state,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def _embed(num: int, features: int, gen: torch.Generator) -> nn.Embedding:
    """flax ``nn.Embed``'s init: N(0, 1/features)."""
    layer = nn.Embedding(num, features)
    with torch.no_grad():
        layer.weight.normal_(0.0, features ** -0.5, generator=gen)
    return layer


class DTNet(nn.Module):
    """Causal transformer over (rtg, state, action) token triples.

    Sequence layout per timestep t: [R_t, s_t, a_t] -> 3K tokens for a
    K-step context. Action logits are read at the STATE positions (the
    model has seen R_t and s_t, not yet a_t). Layer names are the flax
    module's (``timestep_emb``, ``attn_qkv_0``, ``ln_f``, ...)."""

    def __init__(self, num_actions: int, obs_dim: int, d_model: int = 64,
                 n_layer: int = 2, n_head: int = 2, max_timestep: int = 1024,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        self.d_model, self.n_layer, self.n_head = d_model, n_layer, n_head
        self.timestep_emb = _embed(max_timestep, d_model, gen)
        self.rtg_emb = _dense(1, d_model, gen)
        self.obs_emb = _dense(obs_dim, d_model, gen)
        self.act_emb = _embed(num_actions + 1, d_model, gen)
        for i in range(n_layer):
            self.add_module(f"ln1_{i}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"attn_qkv_{i}", _dense(d_model, 3 * d_model, gen))
            self.add_module(f"attn_proj_{i}", _dense(d_model, d_model, gen))
            self.add_module(f"ln2_{i}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"mlp_up_{i}", _dense(d_model, 4 * d_model, gen))
            self.add_module(f"mlp_down_{i}", _dense(4 * d_model, d_model, gen))
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = _dense(d_model, num_actions, gen)

    def forward(self, rtg, obs, actions, timesteps):
        # rtg: [B,K] float; obs: [B,K,obs_dim]; actions: [B,K] int
        # (teacher-forced; -1 pads to embedding row 0); timesteps: [B,K] int
        B, K = rtg.shape
        d, h = self.d_model, self.n_head
        t_emb = self.timestep_emb(timesteps.long())
        r_tok = self.rtg_emb(rtg[..., None]) + t_emb
        s_tok = self.obs_emb(obs) + t_emb
        a_tok = self.act_emb(actions.long() + 1) + t_emb
        # interleave to [B, 3K, d]: (R_1, s_1, a_1, R_2, s_2, a_2, ...)
        x = torch.stack([r_tok, s_tok, a_tok], dim=2).reshape(B, 3 * K, d)
        for i in range(self.n_layer):
            y = getattr(self, f"ln1_{i}")(x)
            q, k, v = (t.reshape(B, 3 * K, h, d // h).transpose(1, 2)
                       for t in getattr(self, f"attn_qkv_{i}")(y).split(d, -1))
            # square causal mask: top-left and bottom-right alignment agree;
            # scale (d/h)^-0.5 as jax.nn.dot_product_attention's default
            att = flash_attention(q, k, v, causal=True)
            x = x + getattr(self, f"attn_proj_{i}")(
                att.transpose(1, 2).reshape(B, 3 * K, d))
            y = getattr(self, f"ln2_{i}")(x)
            y = F.gelu(getattr(self, f"mlp_up_{i}")(y), approximate="tanh")
            x = x + getattr(self, f"mlp_down_{i}")(y)
        x = self.ln_f(x)
        state_positions = x.reshape(B, K, 3, d)[:, :, 1]
        return self.head(state_positions)


class DTModule:
    """The net on ``device`` and its forward for training and
    rolling-context acting. ``device=None`` is the card (raises without
    one)."""

    def __init__(self, obs_dim: int, num_actions: int, context_len: int,
                 d_model: int = 64, n_layer: int = 2, n_head: int = 2,
                 max_timestep: int = 1024, seed: int = 0, device=None):
        self.context_len = context_len
        self.num_actions = num_actions
        self.obs_dim = obs_dim
        self.device = resolve_device(device)
        self.net = DTNet(num_actions, obs_dim, d_model, n_layer, n_head,
                         max_timestep, torch.Generator().manual_seed(seed)
                         ).to(self.device)

    def forward(self, rtg, obs, actions, timesteps) -> torch.Tensor:
        """Logits [B, K, A] on the module's device from numpy windows, no
        gradient."""
        dev = self.device
        with torch.no_grad():
            return self.net(
                torch.as_tensor(np.asarray(rtg, np.float32), device=dev),
                torch.as_tensor(np.asarray(obs, np.float32), device=dev),
                torch.as_tensor(np.asarray(actions), device=dev),
                torch.as_tensor(np.asarray(timesteps), device=dev))

    def get_state(self):
        return get_state(self.net)

    def set_state(self, params):
        set_state(self.net, params)


def episodes_from_fragments(frags: List[SampleBatch]) -> List[Dict[str, np.ndarray]]:
    """Split offline fragments at episode boundaries and precompute
    undiscounted returns-to-go (the DT conditioning signal).

    Fragments are processed INDEPENDENTLY — datasets recorded by parallel
    runners interleave fragments, so trajectory state must never cross a
    seam (read_json_fragments documents the same invariant). A fragment's
    unterminated tail is DROPPED: its remaining rewards live in some
    other fragment, so its return-to-go cannot be computed correctly."""
    episodes = []
    for frag in frags:
        dones = np.asarray(
            frag.get(sb.DONES, np.zeros(frag.count, bool))
        ).astype(bool)
        trunc = np.asarray(
            frag.get(sb.TRUNCATEDS, np.zeros(frag.count, bool))
        ).astype(bool)
        cur: Dict[str, list] = {"obs": [], "actions": [], "rewards": []}
        for i in range(frag.count):
            cur["obs"].append(np.asarray(frag[sb.OBS][i], np.float32))
            cur["actions"].append(int(frag[sb.ACTIONS][i]))
            cur["rewards"].append(float(frag[sb.REWARDS][i]))
            if dones[i] or trunc[i]:
                episodes.append(_finish_episode(cur))
                cur = {"obs": [], "actions": [], "rewards": []}
    return episodes


def _finish_episode(cur: Dict[str, list]) -> Dict[str, np.ndarray]:
    rewards = np.asarray(cur["rewards"], np.float32)
    rtg = np.cumsum(rewards[::-1])[::-1].copy()
    return {
        "obs": np.stack(cur["obs"]),
        "actions": np.asarray(cur["actions"], np.int32),
        "rtg": rtg,
        "timesteps": np.arange(len(rewards), dtype=np.int32),
    }


def _adamw(params, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=1e-4): b1 0.9, b2 0.999, eps 1e-8
    outside the square root, the decay decoupled and scaled by the lr."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


class DTLearner:
    """Supervised next-action prediction over offline context windows."""

    def __init__(self, module: DTModule, config):
        self.module = module
        self.config = config
        self.device = module.device
        self.params = list(module.net.parameters())
        self.optimizer = _adamw(self.params, config.lr)

    def _loss(self, mb):
        # actions feed in UNSHIFTED: the causal mask already hides a_t's
        # token (position 3t+2) from the state position 3t+1 where a_t is
        # predicted, while a_{t-1} stays visible — the reference DT's layout
        logits = self.module.net(mb["rtg"], mb["obs"], mb["actions"],
                                 mb["timesteps"])
        actions = mb["actions"].long()
        ll = torch.log_softmax(logits, dim=-1).gather(
            -1, actions[..., None])[..., 0]
        mask = mb["mask"]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = -(ll * mask).sum() / denom
        acc = ((logits.argmax(-1) == actions) * mask).sum() / denom
        return loss, acc

    def update(self, mb: Dict[str, np.ndarray]) -> Dict[str, float]:
        tmb = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in mb.items()}
        loss, acc = self._loss(tmb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": float(loss.detach()), "action_accuracy": float(acc)}

    def get_weights(self):
        return self.module.get_state()

    def set_weights(self, params):
        self.module.set_state(params)

    def get_optimizer_state(self):
        return _opt_state(self.optimizer)

    def set_optimizer_state(self, state):
        if state is None:
            self.optimizer = _adamw(self.params, self.config.lr)
        else:
            self.optimizer.load_state_dict(state)


class DT(Algorithm):
    """Offline algorithm: no env runners; training_step samples context
    windows uniformly from the offline episodes; the learner is in the
    driver, on the card unless ``num_gpus_per_learner=0``."""

    _learner_cls = DTLearner

    def setup(self, _config):
        cfg = self._algo_config
        input_ = getattr(cfg, "input_", None)
        if not input_:
            raise ValueError("DTConfig.offline_data(input_=...) is required")
        self._episodes = episodes_from_fragments(read_json_fragments(input_))
        if not self._episodes:
            raise ValueError(f"no episodes found in {input_!r}")
        obs_dim = int(self._episodes[0]["obs"].shape[-1])
        num_actions = int(
            max(int(ep["actions"].max()) for ep in self._episodes) + 1
        )
        K = cfg.context_len
        self.module = DTModule(
            obs_dim, num_actions, K,
            d_model=cfg.model.get("d_model", 64),
            n_layer=cfg.model.get("n_layer", 2),
            n_head=cfg.model.get("n_head", 2),
            max_timestep=cfg.max_timestep, seed=cfg.seed,
            device=learner_device(getattr(cfg, "num_gpus_per_learner", 1)),
        )
        self.learner = DTLearner(self.module, cfg)
        self.runners = []
        self.eval_runners = []
        self.rng = np.random.default_rng(cfg.seed)
        self._timesteps = 0

    def _sample_windows(self, batch_size: int) -> Dict[str, np.ndarray]:
        K = self.config.context_len
        obs_dim = self.module.obs_dim
        out = {
            "rtg": np.zeros((batch_size, K), np.float32),
            "obs": np.zeros((batch_size, K, obs_dim), np.float32),
            "actions": np.zeros((batch_size, K), np.int32),
            "timesteps": np.zeros((batch_size, K), np.int32),
            "mask": np.zeros((batch_size, K), np.float32),
        }
        for b in range(batch_size):
            ep = self._episodes[self.rng.integers(len(self._episodes))]
            T = len(ep["actions"])
            start = int(self.rng.integers(T))
            end = min(T, start + K)
            n = end - start
            out["rtg"][b, :n] = ep["rtg"][start:end]
            out["obs"][b, :n] = ep["obs"][start:end]
            out["actions"][b, :n] = ep["actions"][start:end]
            out["timesteps"][b, :n] = ep["timesteps"][start:end]
            out["mask"][b, :n] = 1.0
        return out

    def training_step(self) -> Dict:
        cfg = self.config
        metrics = {}
        for _ in range(cfg.num_epochs):
            mb = self._sample_windows(cfg.minibatch_size)
            metrics = self.learner.update(mb)
            self._timesteps += cfg.minibatch_size
        return metrics

    def step(self) -> Dict:
        metrics = self.training_step()
        self._train_iter = getattr(self, "_train_iter", 0) + 1
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        return metrics

    # -- acting --------------------------------------------------------
    def start_episode(self, target_return: float):
        """Begin a return-conditioned rollout; feed observations through
        ``compute_single_action`` and rewards through ``observe_reward``."""
        self._ctx = {
            "rtg": [float(target_return)], "obs": [], "actions": [],
            "timesteps": [],
        }

    def compute_single_action(self, obs, explore: bool = False):
        c = self._ctx
        K = self.config.context_len
        t = len(c["obs"])
        c["obs"].append(np.asarray(obs, np.float32))
        c["timesteps"].append(min(t, self.config.max_timestep - 1))
        n = min(K, len(c["obs"]))
        rtg = np.zeros((1, K), np.float32)
        ob = np.zeros((1, K, self.module.obs_dim), np.float32)
        # past actions in their own slots; the CURRENT step's action slot
        # holds the -1 pad — causality makes its content unreadable at the
        # state position being decoded anyway
        act = np.full((1, K), -1, np.int32)
        ts = np.zeros((1, K), np.int32)
        rtg[0, :n] = c["rtg"][-n:]
        ob[0, :n] = np.stack(c["obs"][-n:])
        past = c["actions"][-(n - 1):] if n > 1 else []
        act[0, :len(past)] = past
        ts[0, :n] = c["timesteps"][-n:]
        logits = self.module.forward(rtg, ob, act, ts)
        a = int(logits[0, n - 1].argmax())
        c["actions"].append(a)
        return a

    def observe_reward(self, reward: float):
        c = self._ctx
        c["rtg"].append(c["rtg"][-1] - float(reward))

    def evaluate(self, episodes: int = 5) -> Dict:
        """Return-conditioned greedy rollouts against the configured env
        (offline DT has no runner gang; the driver rolls out directly).
        The conditioning target defaults to the dataset's best episode
        return — "act like your best demonstration"."""
        from ray_tpu_torch.rllib.env import driver_rollouts

        target = getattr(self.config, "target_return", None)
        if target is None:
            target = max(float(ep["rtg"][0]) for ep in self._episodes)
        score = driver_rollouts(
            self.config.env, getattr(self.config, "env_config", None),
            self.compute_single_action, episodes=episodes,
            on_reset=lambda: self.start_episode(target),
            on_reward=self.observe_reward,
        )
        return {"evaluation": {"episode_return_mean": score,
                               "num_episodes": episodes}}


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DT)
        self.lr = 1e-3
        self.context_len = 8
        self.max_timestep = 1024
        self.model = {"d_model": 64, "n_layer": 2, "n_head": 2}
        self.minibatch_size = 64
        self.num_epochs = 20
        self.num_env_runners = 0
        self.input_: Optional[str] = None

    def offline_data(self, *, input_=None, **_kw):
        if input_ is not None:
            self.input_ = input_
        return self
