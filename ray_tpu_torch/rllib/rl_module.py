"""RLModule: the policy/value network abstraction.

Reference parity: ray rllib/core/rl_module/rl_module.py — here as torch
``nn.Module``s on an explicit device: the learner's module sits on the card
(``device=None``; it raises when there is none) or on the CPU when asked,
the env runners' copies on the CPU.

Layers keep the names of the JAX package's flax modules (``fc_0``, ``pi``,
``vf``, ...), and start as flax's ``Dense`` does: a LeCun-normal kernel
(truncated normal over the fan-in) and a zero bias, drawn from a
``torch.Generator`` seeded with the module's seed. A module's state crosses
processes as ``{state-dict name: numpy array}``; ``ravel``/``unravel``
flatten it in flax's ``ravel_pytree`` order (sorted layer names, bias
before kernel, each kernel (in, out)), so a flat vector means the same
weights in both packages.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device

# flax's variance_scaling(1.0, "fan_in", "truncated_normal"): the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _dense(fan_in: int, fan_out: int, gen: torch.Generator) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out)
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
        layer.bias.zero_()
    return layer


def _torso(prefix: str, fan_in: int, hiddens: Sequence[int],
           gen: torch.Generator, module: nn.Module) -> int:
    """Add ``{prefix}fc_i`` layers to ``module``; returns the last width."""
    for i, h in enumerate(hiddens):
        module.add_module(f"{prefix}fc_{i}", _dense(fan_in, h, gen))
        fan_in = h
    return fan_in


class DiscreteActorCritic(nn.Module):
    """MLP torso (tanh) with policy-logits + value heads (ray parity: the
    default fcnet Catalog model)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int], gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        width = _torso("", obs_dim, hiddens, gen, self)
        self.pi = _dense(width, num_actions, gen)
        self.vf = _dense(width, 1, gen)

    def forward(self, obs):
        x = obs
        for i in range(self.n_hidden):
            x = torch.tanh(getattr(self, f"fc_{i}")(x))
        return self.pi(x), self.vf(x)[..., 0]


class DuelingQNet(nn.Module):
    """Dueling-architecture Q network (Wang et al. 2016; ray parity: the
    ``dueling`` flag of rllib/algorithms/dqn): Q = V + A - mean(A).
    Returns ``(q_values, state_value)``, DiscreteActorCritic's
    ``(logits, value)`` contract."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int], gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        width = _torso("", obs_dim, hiddens, gen, self)
        self.adv = _dense(width, num_actions, gen)
        self.val = _dense(width, 1, gen)

    def forward(self, obs):
        x = obs
        for i in range(self.n_hidden):
            x = torch.tanh(getattr(self, f"fc_{i}")(x))
        adv = self.adv(x)
        val = self.val(x)[..., 0]
        q = val[..., None] + adv - adv.mean(dim=-1, keepdim=True)
        return q, val


class ContinuousActor(nn.Module):
    """Deterministic policy: MLP (relu) -> tanh, rescaled into [low, high]
    (ray parity: DDPG/TD3 actor nets)."""

    def __init__(self, obs_dim: int, action_dim: int, low: np.ndarray,
                 high: np.ndarray, hiddens: Sequence[int],
                 gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        width = _torso("", obs_dim, hiddens, gen, self)
        self.mu = _dense(width, action_dim, gen)
        self.register_buffer("low", torch.as_tensor(low), persistent=False)
        self.register_buffer("high", torch.as_tensor(high), persistent=False)

    def forward(self, obs):
        x = obs
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        raw = torch.tanh(self.mu(x))
        return self.low + (raw + 1.0) * 0.5 * (self.high - self.low)


class ContinuousQ(nn.Module):
    """Q(s, a) critic MLP over the concatenated obs+action."""

    def __init__(self, in_dim: int, hiddens: Sequence[int],
                 gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        width = _torso("", in_dim, hiddens, gen, self)
        self.q = _dense(width, 1, gen)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.q(x)[..., 0]


State = Dict[str, np.ndarray]


def get_state(net: nn.Module) -> State:
    """``{state-dict name: numpy copy}``, host side, for any device."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in net.state_dict().items()}


def set_state(net: nn.Module, state: State) -> None:
    """Copy ``state`` into ``net``'s parameters in place, on their device
    (optimizers keep their hold on the same tensors)."""
    with torch.no_grad():
        for k, v in net.state_dict().items():
            v.copy_(torch.tensor(np.asarray(state[k])))


def _flax_layout(state: State):
    """[(name, is_kernel)] in ``ravel_pytree``'s order of the flax tree:
    layers sorted by their path, bias before kernel."""
    layers = sorted({k.rsplit(".", 1)[0] for k in state},
                    key=lambda s: s.split("."))
    return [(f"{layer}.{leaf}", leaf == "weight") for layer in layers
            for leaf in ("bias", "weight")]


def ravel(state: State) -> np.ndarray:
    """Flat f32 vector of ``state`` in flax's ``ravel_pytree`` order, each
    kernel laid out (in, out)."""
    return np.concatenate([
        (np.asarray(state[k]).T if kern else np.asarray(state[k])).ravel()
        for k, kern in _flax_layout(state)]).astype(np.float32)


def unravel(flat: np.ndarray, template: State) -> State:
    """The inverse of ``ravel``: ``template`` gives the names and shapes."""
    size = sum(int(np.prod(np.shape(v))) for v in template.values())
    if size != len(flat):
        raise ValueError(f"flat vector of {len(flat)} for {size} parameters")
    out, at = {}, 0
    for k, kern in _flax_layout(template):
        shape = np.shape(template[k])
        n = int(np.prod(shape))
        piece = np.asarray(flat[at:at + n], np.float32)
        out[k] = (piece.reshape(shape[::-1]).T.copy() if kern
                  else piece.reshape(shape))
        at += n
    return out


def _as_obs(obs, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(obs, np.float32), device=device)


class RLModule:
    """A discrete actor-critic (or dueling Q) net on ``device`` with
    inference entry points that take and return numpy."""

    def __init__(self, obs_shape: tuple, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), seed: int = 0,
                 dueling: bool = False,
                 device: Union[str, torch.device, None] = None):
        self.obs_shape = tuple(obs_shape)
        self.num_actions = num_actions
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        cls = DuelingQNet if dueling else DiscreteActorCritic
        self.net = cls(int(np.prod(obs_shape)), num_actions, tuple(hiddens),
                       gen).to(self.device)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits or Q-values, values) on the module's device."""
        with torch.no_grad():
            return self.net(_as_obs(obs, self.device))

    # -- inference entry points ----------------------------------------
    def action_exploration(self, obs: np.ndarray, generator: torch.Generator):
        """Sample from the policy: (actions, their log-probs, values)."""
        logits, value = self.forward(obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(logp_all.exp(), 1,
                                   generator=generator)[:, 0]
        logp = logp_all.gather(1, action[:, None])[:, 0]
        return (action.cpu().numpy(), logp.cpu().numpy(),
                value.cpu().numpy())

    def action_greedy(self, obs: np.ndarray):
        logits, _ = self.forward(obs)
        return logits.argmax(dim=-1).cpu().numpy()

    def get_state(self) -> State:
        return get_state(self.net)

    def set_state(self, params: State):
        set_state(self.net, params)

    def ravel(self) -> np.ndarray:
        return ravel(self.get_state())

    def unravel(self, flat: np.ndarray) -> State:
        return unravel(flat, self.get_state())


class ContinuousRLModule:
    """Actor + twin critics for continuous control (TD3/DDPG): ``actor``,
    ``q1`` and ``q2`` under one ``nn.ModuleDict`` (state names
    ``actor.fc_0.weight``, ``q1.q.bias``, ...); the learner owns targets
    and updates."""

    def __init__(self, obs_shape: tuple, action_info: dict,
                 hiddens: Sequence[int] = (64, 64), seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.obs_shape = tuple(obs_shape)
        self.action_dim = action_info["dim"]
        self.low = np.asarray(action_info["low"], np.float32)
        self.high = np.asarray(action_info["high"], np.float32)
        self.device = resolve_device(device)
        obs_dim = int(np.prod(obs_shape))
        gen = torch.Generator().manual_seed(seed)
        self.net = nn.ModuleDict({
            "actor": ContinuousActor(obs_dim, self.action_dim, self.low,
                                     self.high, tuple(hiddens), gen),
            "q1": ContinuousQ(obs_dim + self.action_dim, tuple(hiddens), gen),
            "q2": ContinuousQ(obs_dim + self.action_dim, tuple(hiddens), gen),
        }).to(self.device)
        self.actor, self.q1, self.q2 = (self.net[k]
                                        for k in ("actor", "q1", "q2"))

    def _act(self, obs) -> torch.Tensor:
        with torch.no_grad():
            return self.actor(_as_obs(obs, self.device))

    def action_greedy(self, obs: np.ndarray) -> np.ndarray:
        return self._act(obs).cpu().numpy()

    def action_exploration(self, obs: np.ndarray, generator: torch.Generator,
                           noise_scale: float = 0.1) -> np.ndarray:
        a = self._act(obs)
        noise = torch.randn(a.shape, generator=generator,
                            device=self.device) * noise_scale
        a = a + noise * torch.as_tensor((self.high - self.low) * 0.5,
                                        device=self.device)
        return torch.clamp(a, torch.as_tensor(self.low, device=self.device),
                           torch.as_tensor(self.high, device=self.device)
                           ).cpu().numpy()

    def get_state(self) -> State:
        return get_state(self.net)

    def set_state(self, params: State):
        set_state(self.net, params)


def learner_device(num_gpus_per_learner: float) -> torch.device:
    """A learner's device: the current card when it asks for one, else the
    CPU. Raises when it asks for a card and there is none: a learner never
    drops to the CPU on its own."""
    if not num_gpus_per_learner:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the learner; "
                           "pass num_gpus_per_learner=0 to learn on the CPU")
    return resolve_device(None)
