"""Learners: policy updates on the learner's device.

Reference parity: ray rllib/core/learner/learner.py:229 (update,
compute_gradients) + learner_group.py. Each update is the loss's
``backward()`` into ``.grad``, optax's ``clip_by_global_norm`` written out,
and ``torch.optim.Adam`` (optax's ``adam``: the same moments, bias
corrections and eps outside the square root). The step splits into
``_grad_step`` and ``_apply_step`` so the DDP LearnerGroup can mean-reduce
the gradients between the two halves.

PPO loss: clipped surrogate + value loss + entropy bonus
(ray parity: rllib/algorithms/ppo/ppo_torch_policy.py loss).
IMPALA: v-trace off-policy correction
(ray parity: rllib/algorithms/impala/vtrace_torch.py).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.rl_module import (
    RLModule,
    _dense,
    _torso,
    get_state,
    set_state,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

Tensors = Dict[str, torch.Tensor]


def _adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _clip_by_global_norm(params: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm``
    (no host sync: the choice is made on the device)."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _backward(loss: torch.Tensor, params: List[torch.Tensor]):
    """Fresh gradients of ``loss`` in ``params``' ``.grad``; a parameter the
    loss does not reach gets zeros, as ``jax.grad`` gives it (so Adam
    decays its moments as optax does)."""
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def _opt_state(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict with its tensors copied to the host (a
    checkpoint or a reply from a learner actor must not hold card memory;
    ``load_state_dict`` moves them back to each parameter's device)."""
    sd = opt.state_dict()
    return {"state": {i: {k: (v.detach().cpu().clone() if torch.is_tensor(v)
                              else v) for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "param_groups": copy.deepcopy(sd["param_groups"])}


def _frozen_copy(net: nn.Module) -> nn.Module:
    return copy.deepcopy(net).requires_grad_(False)


def _polyak(target: nn.Module, online: nn.Module, tau: float):
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_((1.0 - tau) * t + tau * o)


def _x32(v) -> np.ndarray:
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _floats(metrics: Tensors) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _taken(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(1, actions.long()[:, None])[:, 0]


def _entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


def _normalized(adv: torch.Tensor) -> torch.Tensor:
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


class Learner:
    # True for learners whose step splits into _grad_step/_apply_step —
    # only these can run under LearnerGroup.
    supports_ddp = False

    def __init__(self, module: RLModule, config):
        self.module = module
        self.config = config
        self.device = module.device
        self.params = list(module.net.parameters())
        self.grad_clip = config.grad_clip or 1e9
        self.optimizer = _adam(self.params, config.lr)

    def _tensors(self, batch, keys=None, skip=()) -> Tensors:
        """The batch's columns on the learner's device; f64 columns (JSON
        read back) become f32, as ``jnp.asarray`` makes them."""
        return {k: torch.tensor(_x32(v), device=self.device)
                for k, v in batch.items()
                if (keys is None or k in keys) and k not in skip}

    def get_weights(self):
        return self.module.get_state()

    def sgd_epochs(self, batch: "SampleBatch", keys=None,
                   step_fn=None) -> Dict[str, float]:
        """Shared minibatch-SGD driver: shuffle + minibatch + train step
        for config.num_epochs (used by PPO and PG). ``step_fn`` overrides
        the per-minibatch step (tensors -> metrics dict), which is how the
        DDP path injects its grad/allreduce/apply split."""
        cfg = self.config
        rng = getattr(self, "_rng", None)
        if rng is None:
            rng = self._rng = np.random.default_rng(getattr(cfg, "seed", 0))
        metrics = {}
        for _ in range(cfg.num_epochs):
            shuffled = batch.shuffled(rng)
            for mb in shuffled.minibatches(cfg.minibatch_size):
                if mb.count < 2:
                    continue
                tmb = self._tensors(mb, keys)
                metrics = (step_fn or self._train_step)(tmb)
        return _floats(metrics)

    def set_weights(self, params):
        # Weights-only update: Adam moments survive (checkpoint restore and
        # Tune pause/resume must not silently cold-start the optimizer).
        self.module.set_state(params)

    def get_optimizer_state(self):
        return _opt_state(self.optimizer)

    def set_optimizer_state(self, opt_state):
        """Restore Adam moments; ``None`` re-inits (a checkpoint without
        optimizer state must not keep moments from the discarded weights)."""
        if opt_state is None:
            self.optimizer = _adam(self.params, self.config.lr)
        else:
            self.optimizer.load_state_dict(opt_state)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError

    # -- shared machinery for actor-critic learners ---------------------
    def _loss(self, mb: Tensors):
        """(total, (pi_loss, vf_loss, entropy)) of one batch."""
        raise NotImplementedError

    def _grad_step(self, mb: Tensors) -> Tensors:
        total, (pi, vf, ent) = self._loss(mb)
        _backward(total, self.params)
        return {"total_loss": total.detach(), "policy_loss": pi.detach(),
                "vf_loss": vf.detach(), "entropy": ent.detach()}

    def _apply_step(self):
        _clip_by_global_norm(self.params, self.grad_clip)
        self.optimizer.step()

    def _train_step(self, mb: Tensors) -> Tensors:
        metrics = self._grad_step(mb)
        self._apply_step()
        return metrics

    # -- DDP hooks (LearnerGroup) ---------------------------------------
    def _ddp_step(self, mb: Tensors, allreduce: Callable) -> Tensors:
        metrics = self._grad_step(mb)
        grads = allreduce([p.grad for p in self.params])
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.grad.copy_(torch.as_tensor(g))
        self._apply_step()
        return metrics

    def update_ddp(self, batch: "SampleBatch", allreduce) -> Dict[str, float]:
        """One data-parallel update: local grads on this learner's shard,
        ``allreduce`` (a list of gradients -> their means across the
        group), then the optimizer step — every learner applies identical
        averaged grads to identical params, so replicas stay in sync
        without a broadcast (ray parity: learner.py:558
        postprocess_gradients + DDP wrap). Default = single full-batch
        step (IMPALA/APPO shape)."""
        return _floats(self._ddp_step(self._tensors(batch), allreduce))

    def _update_full_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One step over the whole (time-ordered) batch."""
        return _floats(self._train_step(self._tensors(batch)))


class PPOLearner(Learner):
    supports_ddp = True

    def __init__(self, module: RLModule, config):
        super().__init__(module, config)
        self._rng = np.random.default_rng(0)

    def _loss(self, mb):
        cfg = self.config
        clip = cfg.clip_param
        logits, values = self.module.net(mb[sb.OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = _taken(logp_all, mb[sb.ACTIONS])
        ratio = torch.exp(logp - mb[sb.LOGP])
        adv = _normalized(mb[sb.ADVANTAGES])
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -surrogate.mean()
        vf_loss = ((values - mb[sb.TARGETS]) ** 2).mean()
        entropy = _entropy(logp_all)
        total = pi_loss + cfg.vf_loss_coeff * vf_loss - \
            cfg.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.sgd_epochs(batch)

    def update_ddp(self, batch: SampleBatch, allreduce) -> Dict[str, float]:
        """PPO's epoch/minibatch SGD with an allreduce between grad and
        apply. Every group member runs the SAME number of minibatches
        (equal shard sizes, fixed minibatch grid) — a mismatch would
        deadlock the lockstep allreduces."""
        return self.sgd_epochs(
            batch, step_fn=lambda mb: self._ddp_step(mb, allreduce))


class PGLearner(Learner):
    """Vanilla policy gradient / REINFORCE (ray parity:
    rllib/algorithms/pg): loss = -E[logp(a|s) * R_t] with normalized
    Monte-Carlo returns-to-go and no baseline; the module's value head
    exists but is untrained."""

    supports_ddp = True

    def _loss(self, mb):
        logits, _ = self.module.net(mb[sb.OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = _taken(logp_all, mb[sb.ACTIONS])
        ret = mb[sb.ADVANTAGES]  # returns-to-go, normalized upstream
        pi_loss = -(logp * ret).mean()
        entropy = _entropy(logp_all)
        total = pi_loss - self.config.entropy_coeff * entropy
        return total, (pi_loss, torch.zeros((), device=self.device), entropy)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.sgd_epochs(batch)


class A2CLearner(Learner):
    """Advantage actor-critic (ray parity: rllib/algorithms/a2c): the
    unclipped PPO objective — one synchronous pass per batch, GAE
    advantages, trained value baseline."""

    supports_ddp = True

    def _loss(self, mb):
        cfg = self.config
        logits, values = self.module.net(mb[sb.OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = _taken(logp_all, mb[sb.ACTIONS])
        adv = _normalized(mb[sb.ADVANTAGES])
        pi_loss = -(logp * adv).mean()
        vf_loss = ((values - mb[sb.TARGETS]) ** 2).mean()
        entropy = _entropy(logp_all)
        total = pi_loss + cfg.vf_loss_coeff * vf_loss - \
            cfg.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self._update_full_batch(batch)


def vtrace(behavior_logp, target_logp, rewards, values, next_values, dones,
           truncateds, gamma, clip_rho: float = 1.0, clip_c: float = 1.0):
    """V-trace targets (IMPALA) over one fragment (time-major 1D tensors on
    one device; ``dones`` and ``truncateds`` boolean).

    ``next_values`` is V(s_{t+1}) per step, with the pre-reset observation's
    value at truncations (env_runner's VF_NEXT). Terminations cut the reward
    bootstrap; truncations only cut the correction chain. The reverse
    recursion is a plain loop, one ``addcmul`` launch a step; no gradient
    flows through the targets.
    """
    with torch.no_grad():
        ratio = torch.exp(target_logp - behavior_logp)
        rho = torch.clamp(ratio, max=clip_rho)
        c = torch.clamp(ratio, max=clip_c)
        nonterminal = 1.0 - dones.float()
        chain = nonterminal * (1.0 - truncateds.float())
        deltas = rho * (rewards + gamma * next_values * nonterminal - values)
        coef = gamma * c * chain
        vs_minus_v = torch.empty_like(deltas)
        acc = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
        for t in range(len(deltas) - 1, -1, -1):
            acc = torch.addcmul(deltas[t], coef[t], acc, out=vs_minus_v[t])
        vs = values + vs_minus_v
        # vs_{t+1} within an episode; across a truncation/fragment boundary
        # the uncorrected next_values bootstrap is the only estimate
        vs_tp1 = torch.cat([vs[1:], next_values[-1:]])
        boundary = (dones | truncateds).float()
        next_vs = boundary * next_values + (1.0 - boundary) * vs_tp1
        pg_adv = rho * (rewards + gamma * next_vs * nonterminal - values)
    return vs, pg_adv


class _VtraceLearner(Learner):
    """Shared IMPALA/APPO forward: policy logp + v-trace targets."""

    supports_ddp = True

    def _vtrace_forward(self, mb):
        logits, values = self.module.net(mb[sb.OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = _taken(logp_all, mb[sb.ACTIONS])
        vs, pg_adv = vtrace(
            mb[sb.LOGP], target_logp.detach(), mb[sb.REWARDS],
            values.detach(), mb[sb.VF_NEXT], mb[sb.DONES],
            mb[sb.TRUNCATEDS], self.config.gamma)
        return logp_all, target_logp, values, vs, pg_adv

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self._update_full_batch(batch)


class ImpalaLearner(_VtraceLearner):
    def _loss(self, mb):
        cfg = self.config
        logp_all, target_logp, values, vs, pg_adv = self._vtrace_forward(mb)
        pi_loss = -(pg_adv * target_logp).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = _entropy(logp_all)
        total = pi_loss + cfg.vf_loss_coeff * vf_loss - \
            cfg.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)


class APPOLearner(_VtraceLearner):
    """APPO: PPO's clipped surrogate on v-trace-corrected advantages
    (ray parity: rllib/algorithms/appo — IMPALA's off-policy correction
    with PPO's trust region, so stale fragments can be re-used for
    multiple SGD passes without policy collapse)."""

    def _loss(self, mb):
        cfg = self.config
        clip = cfg.clip_param
        logp_all, target_logp, values, vs, pg_adv = self._vtrace_forward(mb)
        adv = _normalized(pg_adv)
        ratio = torch.exp(target_logp - mb[sb.LOGP])
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -surrogate.mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = _entropy(logp_all)
        total = pi_loss + cfg.vf_loss_coeff * vf_loss - \
            cfg.entropy_coeff * entropy
        return total, (pi_loss, vf_loss, entropy)


class TargetNetLearner(Learner):
    """A learner with a frozen copy of its net for TD targets: synced on
    demand, and carried through checkpoints on the optimizer-state channel
    (a fresh-init target after a restore would feed garbage TD targets
    until the next sync). DQN, CQL, QMIX and R2D2 share it."""

    def __init__(self, module, config):
        super().__init__(module, config)
        self.target_net = _frozen_copy(module.net)

    def sync_target(self):
        self.target_net.load_state_dict(self.module.net.state_dict())

    def get_optimizer_state(self):
        return {"opt": _opt_state(self.optimizer),
                "target_params": get_state(self.target_net)}

    def set_optimizer_state(self, state):
        if isinstance(state, dict) and "target_params" in state:
            super().set_optimizer_state(state["opt"])
            set_state(self.target_net, state["target_params"])
        else:  # None, or a raw optimizer state with no recorded target
            super().set_optimizer_state(state)
            self.sync_target()


class DQNLearner(TargetNetLearner):
    """DQN with the reference's rainbow-family knobs (ray parity:
    rllib/algorithms/dqn — ``double_q``, ``dueling`` (module-side),
    ``n_step`` (buffer-side; consumed here via ``nstep_discount``), and
    prioritized replay (``weights`` importance correction in the loss +
    per-sample |TD| returned for priority updates))."""

    def __init__(self, module: RLModule, config):
        super().__init__(module, config)
        self.double_q = bool(getattr(config, "double_q", False))

    def _loss(self, mb):
        net = self.module.net
        q, _ = net(mb[sb.OBS])
        q_sel = _taken(q, mb[sb.ACTIONS])
        with torch.no_grad():
            q_next_t, _ = self.target_net(mb[sb.NEXT_OBS])
            if self.double_q:
                # action selection by the ONLINE net, evaluation by the
                # target net (van Hasselt 2016) — kills the max-operator
                # overestimation bias
                q_next_o, _ = net(mb[sb.NEXT_OBS])
                q_boot = _taken(q_next_t, q_next_o.argmax(dim=-1))
            else:
                q_boot = q_next_t.max(dim=-1).values
            # n-step fragments carry their actual bootstrap discount
            # (gamma^h, horizon-clipped at episode ends)
            disc = mb.get("nstep_discount", self.config.gamma)
            target = mb[sb.REWARDS] + disc * (
                1.0 - mb[sb.DONES].float()) * q_boot
        td = q_sel - target
        w = mb.get("weights")  # PER importance correction
        loss = (w * td ** 2).mean() if w is not None else (td ** 2).mean()
        return loss, td.detach().abs()

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        loss, td_abs = self._loss(self._tensors(batch,
                                                skip=("batch_indexes",)))
        _backward(loss, self.params)
        self._apply_step()
        # exposed for the algorithm's PER priority refresh
        self.last_td_abs = td_abs.cpu().numpy()
        return _floats({"loss": loss.detach(),
                        "mean_td_error": td_abs.mean()})


class TD3Learner(Learner):
    """TD3 (Fujimoto et al. 2018) — and, with ``twin_q=False,
    policy_delay=1, target_noise=0``, plain DDPG (Lillicrap et al. 2015).
    Reference analog: rllib/algorithms/td3 and /ddpg: a critic step every
    update, a delayed actor step with polyak target updates.

    Expects a ContinuousRLModule (actor/q1/q2). The target-policy noise
    comes from a ``torch.Generator`` on the learner's device seeded with
    ``seed + 7``."""

    def __init__(self, module, config):
        # Learner.__init__ builds one optimizer over module.net; TD3 needs
        # separate actor/critic optimizers, so set up by hand.
        self.module = module
        self.config = config
        self.device = module.device
        self.tau = getattr(config, "tau", 0.005)
        self.twin_q = getattr(config, "twin_q", True)
        self.policy_delay = max(1, int(getattr(config, "policy_delay", 2)))
        self.target_noise = getattr(config, "target_noise", 0.2)
        self.noise_clip = getattr(config, "target_noise_clip", 0.5)
        self.low = torch.as_tensor(module.low, device=self.device)
        self.high = torch.as_tensor(module.high, device=self.device)
        self.grad_clip = config.grad_clip or 1e9
        self.actor_params = list(module.actor.parameters())
        self.critic_params = list(module.q1.parameters()) + \
            list(module.q2.parameters())
        self._init_optimizers()
        self.target = _frozen_copy(module.net)
        self._updates = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            getattr(config, "seed", 0) + 7)

    def _init_optimizers(self):
        cfg = self.config
        self.actor_opt = _adam(self.actor_params,
                               getattr(cfg, "actor_lr", cfg.lr))
        self.critic_opt = _adam(self.critic_params,
                                getattr(cfg, "critic_lr", cfg.lr))

    def _critic_step(self, mb) -> torch.Tensor:
        m, t = self.module, self.target
        with torch.no_grad():
            # target policy smoothing: act from the target actor + clipped
            # noise, then clipped double-Q target
            a_next = t["actor"](mb[sb.NEXT_OBS])
            if self.target_noise > 0:
                noise = torch.clamp(
                    torch.randn(a_next.shape, generator=self._gen,
                                device=self.device) * self.target_noise,
                    -self.noise_clip, self.noise_clip,
                ) * (self.high - self.low) * 0.5
                a_next = torch.clamp(a_next + noise, self.low, self.high)
            tq = t["q1"](mb[sb.NEXT_OBS], a_next)
            if self.twin_q:
                tq = torch.minimum(tq, t["q2"](mb[sb.NEXT_OBS], a_next))
            y = mb[sb.REWARDS] + self.config.gamma * (
                1.0 - mb[sb.DONES].float()) * tq
        act = mb[sb.ACTIONS].float()
        loss = ((m.q1(mb[sb.OBS], act) - y) ** 2).mean()
        if self.twin_q:
            loss = loss + ((m.q2(mb[sb.OBS], act) - y) ** 2).mean()
        _backward(loss, self.critic_params)
        _clip_by_global_norm(self.critic_params, self.grad_clip)
        self.critic_opt.step()
        return loss.detach()

    def _actor_step(self, mb) -> torch.Tensor:
        m = self.module
        loss = -m.q1(mb[sb.OBS], m.actor(mb[sb.OBS])).mean()
        _backward(loss, self.actor_params)
        _clip_by_global_norm(self.actor_params, self.grad_clip)
        self.actor_opt.step()
        # polyak targets move only on actor (delayed) steps, as in TD3
        _polyak(self.target, m.net, self.tau)
        return loss.detach()

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        mb = self._tensors(batch, keys=(sb.OBS, sb.NEXT_OBS, sb.ACTIONS,
                                        sb.REWARDS, sb.DONES))
        metrics = {"critic_loss": float(self._critic_step(mb))}
        self._updates += 1
        if self._updates % self.policy_delay == 0:
            metrics["actor_loss"] = float(self._actor_step(mb))
        return metrics

    def get_optimizer_state(self):
        return {
            "actor": _opt_state(self.actor_opt),
            "critic": _opt_state(self.critic_opt),
            "target_params": get_state(self.target),
            "updates": self._updates,
        }

    def set_optimizer_state(self, state):
        if state is None:
            self._init_optimizers()
            self.target.load_state_dict(self.module.net.state_dict())
            self._updates = 0
            return
        self.actor_opt.load_state_dict(state["actor"])
        self.critic_opt.load_state_dict(state["critic"])
        set_state(self.target, state["target_params"])
        self._updates = state.get("updates", 0)


class _TwinQ(nn.Module):
    """Two independent per-action Q MLPs (discrete SAC's clipped double-Q;
    reference analog: rllib/algorithms/sac — torch twin Q towers): layers
    ``q1_fc_i``/``q1_out`` and ``q2_fc_i``/``q2_out``."""

    def __init__(self, obs_dim: int, num_actions: int, hiddens,
                 gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        for tower in ("q1", "q2"):
            width = _torso(f"{tower}_", obs_dim, hiddens, gen, self)
            self.add_module(f"{tower}_out", _dense(width, num_actions, gen))

    def forward(self, obs):
        qs = []
        for tower in ("q1", "q2"):
            x = obs
            for i in range(self.n_hidden):
                x = torch.relu(getattr(self, f"{tower}_fc_{i}")(x))
            qs.append(getattr(self, f"{tower}_out")(x))
        return qs[0], qs[1]


class SACLearner(Learner):
    """Discrete soft actor-critic (Christodoulou 2019): categorical policy
    from the shared module's logits head, twin per-action Q towers with
    polyak-averaged targets, and auto-tuned temperature toward a fraction
    of max entropy. The Q towers start from a generator seeded with
    ``seed + 1``."""

    def __init__(self, module: RLModule, config):
        super().__init__(module, config)
        self.tau = getattr(config, "tau", 0.01)
        target_entropy = getattr(config, "target_entropy", None)
        if target_entropy is None:
            target_entropy = 0.6 * float(np.log(np.float32(
                module.num_actions)))
        self.target_entropy = target_entropy
        gen = torch.Generator().manual_seed(config.seed + 1)
        self.qnet = _TwinQ(int(np.prod(module.obs_shape)), module.num_actions,
                           tuple(config.model.get("hiddens", (64, 64))),
                           gen).to(self.device)
        self.q_params = list(self.qnet.parameters())
        self.target_qnet = _frozen_copy(self.qnet)
        self.log_alpha = torch.zeros((), device=self.device,
                                     requires_grad=True)
        self._init_side_optimizers()

    def _init_side_optimizers(self):
        self.q_opt = _adam(self.q_params, self.config.lr)
        self.alpha_opt = _adam([self.log_alpha], self.config.lr)

    def _policy_dist(self, obs):
        logits, _ = self.module.net(obs)
        logp = torch.log_softmax(logits, dim=-1)
        return torch.exp(logp), logp

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        mb = self._tensors(batch)
        gamma = self.config.gamma
        alpha = torch.exp(self.log_alpha.detach())
        # critic: soft Bellman target from the current policy
        with torch.no_grad():
            probs_n, logp_n = self._policy_dist(mb[sb.NEXT_OBS])
            tq1, tq2 = self.target_qnet(mb[sb.NEXT_OBS])
            soft_v = (probs_n * (torch.minimum(tq1, tq2) - alpha * logp_n)
                      ).sum(-1)
            target = mb[sb.REWARDS] + gamma * (
                1.0 - mb[sb.DONES].float()) * soft_v
        q1, q2 = self.qnet(mb[sb.OBS])
        q1a, q2a = _taken(q1, mb[sb.ACTIONS]), _taken(q2, mb[sb.ACTIONS])
        q_loss = ((q1a - target) ** 2 + (q2a - target) ** 2).mean()
        _backward(q_loss, self.q_params)
        self.q_opt.step()
        # actor against the updated critic
        probs, logp = self._policy_dist(mb[sb.OBS])
        with torch.no_grad():
            qmin = torch.minimum(*self.qnet(mb[sb.OBS]))
        pi_loss = (probs * (alpha * logp - qmin)).sum(-1).mean()
        entropy = -(probs * logp).sum(-1).mean().detach()
        _backward(pi_loss, self.params)
        self._apply_step()
        # temperature: grows alpha while entropy < target, shrinks it above
        a_loss = self.log_alpha * (entropy - self.target_entropy)
        _backward(a_loss, [self.log_alpha])
        self.alpha_opt.step()
        _polyak(self.target_qnet, self.qnet, self.tau)
        return _floats({
            "q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(),
            "alpha_loss": a_loss.detach(),
            "alpha": torch.exp(self.log_alpha.detach()), "entropy": entropy,
        })

    def get_optimizer_state(self):
        return {
            "pi": _opt_state(self.optimizer),
            "q": _opt_state(self.q_opt),
            "alpha": _opt_state(self.alpha_opt),
            "q_params": get_state(self.qnet),
            "target_q_params": get_state(self.target_qnet),
            "log_alpha": float(self.log_alpha),
        }

    def set_optimizer_state(self, state):
        if state is None:
            super().set_optimizer_state(None)
            self._init_side_optimizers()
            return
        self.optimizer.load_state_dict(state["pi"])
        self.q_opt.load_state_dict(state["q"])
        self.alpha_opt.load_state_dict(state["alpha"])
        set_state(self.qnet, state["q_params"])
        set_state(self.target_qnet, state["target_q_params"])
        with torch.no_grad():
            self.log_alpha.fill_(state["log_alpha"])
