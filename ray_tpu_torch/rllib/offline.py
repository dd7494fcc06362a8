"""Offline RL: sample writing/reading, behavior cloning, MARWIL and CQL.

ray parity: rllib/offline/ (JsonWriter/JsonReader feeding offline
algorithms) and rllib/algorithms/{bc,marwil,cql} — train a policy from
recorded transitions with no environment interaction; the env is only
probed for spaces and used for evaluation on one CPU runner.

The learners run where ``num_gpus_per_learner`` puts the module (the card
by default): each minibatch's loss goes through ``backward()``, optax's
global-norm clip written out and ``torch.optim.Adam`` (``Learner``'s step).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import (
    Learner,
    TargetNetLearner,
    _backward,
    _floats,
    _taken,
)
from ray_tpu_torch.rllib.sample_batch import SampleBatch, returns_to_go


def write_json(batches: List[SampleBatch], path: str) -> str:
    """Record sample batches as JSON lines (ray parity: JsonWriter)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for batch in batches:
            f.write(json.dumps({
                k: np.asarray(v).tolist() for k, v in batch.items()
            }) + "\n")
    return path


def read_json_fragments(path: str) -> List[SampleBatch]:
    """Load recorded batches preserving fragment boundaries (one recorded
    SampleBatch per JSON line) — consumers that chain values through time
    (returns-to-go) must not cross these seams."""
    batches = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            batches.append(SampleBatch({
                k: np.asarray(v) for k, v in row.items()
            }))
    if not batches:
        raise ValueError(f"no batches in {path}")
    return batches


def read_json(path: str) -> SampleBatch:
    """Load recorded batches back (ray parity: JsonReader)."""
    return SampleBatch.concat(read_json_fragments(path))


def _action_nll(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return -_taken(torch.log_softmax(logits, dim=-1), actions)


class BCLearner(Learner):
    """Supervised action cross-entropy on logged transitions (ray parity:
    rllib/algorithms/bc — the new-stack BC loss)."""

    def _train_step(self, mb):
        logits, _ = self.module.net(mb[sb.OBS])
        loss = _action_nll(logits, mb[sb.ACTIONS]).mean()
        _backward(loss, self.params)
        self._apply_step()
        return {"bc_loss": loss.detach()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.sgd_epochs(batch, keys=(sb.OBS, sb.ACTIONS))


class BC(Algorithm):
    """Behavior cloning: no sampling plane — each train() runs supervised
    epochs over the offline dataset; evaluate() rolls the env on the one
    CPU runner."""

    _learner_cls = BCLearner

    def setup(self, config):
        # BC never samples: one evaluation runner is all it needs — clamp
        # BEFORE the fleet spawns rather than killing extras after.
        self._algo_config.num_env_runners = 1
        super().setup(config)
        input_ = self._algo_config.offline_input
        if input_ is None:
            raise ValueError("BCConfig.offline_data(input_=...) is required")
        if isinstance(input_, str):
            self._fragments = read_json_fragments(input_)
            self._dataset = SampleBatch.concat(self._fragments)
        elif isinstance(input_, SampleBatch):
            # a single pre-built batch is one fragment by construction
            self._fragments = [input_]
            self._dataset = input_
        else:  # ray_tpu_torch.data Dataset of obs/actions columns
            rows = input_.take_all()
            self._dataset = SampleBatch({
                sb.OBS: np.asarray([r["obs"] for r in rows], np.float32),
                sb.ACTIONS: np.asarray([r["actions"] for r in rows], np.int32),
            })
            self._fragments = [self._dataset]

    def training_step(self) -> Dict:
        metrics = self.learner.update(self._dataset)
        self._timesteps += self._dataset.count
        # keep the evaluation runner's weights current (BC never goes
        # through the sampling loop that normally syncs)
        self._sync_weights()
        return metrics


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(BC)
        self.offline_input = None
        self.num_env_runners = 1
        self.num_epochs = 1
        self.lr = 1e-3

    def offline_data(self, *, input_=None, **_kw):
        """ray parity: AlgorithmConfig.offline_data(input_=...)."""
        if input_ is not None:
            self.offline_input = input_
        return self


class MARWILLearner(Learner):
    """Monotonic advantage re-weighted imitation learning (ray parity:
    rllib/algorithms/marwil): exp(beta * advantage)-weighted action
    cross-entropy plus a value-head regression to the recorded returns;
    beta=0 reduces exactly to BC."""

    def _train_step(self, mb):
        cfg = self.config
        logits, values = self.module.net(mb[sb.OBS])
        nll = _action_nll(logits, mb[sb.ACTIONS])
        adv = mb["returns"] - values
        # the advantage normalizer is batch-local (the reference keeps a
        # running mean of |adv|; the JAX package folds it into the batch)
        adv_n = adv / (adv.abs().mean() + 1e-8)
        weight = torch.exp(torch.clamp(cfg.beta * adv_n.detach(), -10.0,
                                       10.0))
        pi_loss = (weight * nll).mean()
        vf_loss = (adv ** 2).mean()
        total = pi_loss + cfg.vf_loss_coeff * vf_loss
        _backward(total, self.params)
        self._apply_step()
        return {"total_loss": total.detach(), "policy_loss": pi_loss.detach(),
                "vf_loss": vf_loss.detach()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        return self.sgd_epochs(batch, keys=(sb.OBS, sb.ACTIONS, "returns"))


class MARWIL(BC):
    """Offline advantage-weighted imitation (ray parity:
    rllib/algorithms/marwil). Same offline data plane as BC; the dataset
    gains a ``returns`` column (discounted returns-to-go) for the
    advantage weighting."""

    _learner_cls = MARWILLearner

    def setup(self, config):
        super().setup(config)
        if "returns" not in self._dataset:
            if (sb.REWARDS not in self._dataset
                    or sb.DONES not in self._dataset):
                raise ValueError(
                    "MARWIL needs 'returns' or rewards/dones columns in "
                    "the offline data"
                )
            # per-fragment: the discount chain must not run across the
            # seam between independently recorded fragments (the step
            # before a seam is usually mid-episode, not terminal)
            self._dataset["returns"] = np.concatenate([
                returns_to_go(f, self._algo_config.gamma)
                for f in self._fragments
            ])


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0
        self.vf_loss_coeff = 1.0
        self.num_epochs = 5


class CQLLearner(TargetNetLearner):
    """Discrete conservative Q-learning (ray parity: rllib/algorithms/cql,
    discrete form): the DQN TD loss on logged transitions plus the CQL
    regularizer  E[logsumexp_a Q(s,a) - Q(s, a_logged)], which pushes down
    Q on actions the dataset never took (the offline over-estimation
    fix). The target net rides the optimizer state, as DQN's does."""

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        cfg = self.config
        mb = self._tensors(batch, keys=(sb.OBS, sb.ACTIONS, sb.REWARDS,
                                        sb.DONES, sb.NEXT_OBS))
        q, _ = self.module.net(mb[sb.OBS])
        q_sel = _taken(q, mb[sb.ACTIONS])
        with torch.no_grad():
            q_next, _ = self.target_net(mb[sb.NEXT_OBS])
            target = mb[sb.REWARDS] + cfg.gamma * (
                1.0 - mb[sb.DONES].float()) * q_next.max(dim=-1).values
        td_loss = ((q_sel - target) ** 2).mean()
        cql_term = (torch.logsumexp(q, dim=-1) - q_sel).mean()
        total = td_loss + cfg.cql_alpha * cql_term
        _backward(total, self.params)
        self._apply_step()
        return _floats({"total_loss": total.detach(),
                        "td_loss": td_loss.detach(),
                        "cql_loss": cql_term.detach()})


class CQL(BC):
    """Offline discrete CQL: minibatch TD sweeps over the logged dataset
    with periodic target sync; no environment sampling."""

    _learner_cls = CQLLearner

    def setup(self, config):
        super().setup(config)
        for key in (sb.NEXT_OBS, sb.REWARDS, sb.DONES):
            if key not in self._dataset:
                raise ValueError(f"CQL offline data needs {key!r}")
        self._rng = np.random.default_rng(self._algo_config.seed)
        self._since_target_sync = 0

    def training_step(self) -> Dict:
        cfg = self.config
        metrics = {}
        for _ in range(cfg.num_epochs):
            idx = self._rng.integers(0, self._dataset.count,
                                     size=cfg.minibatch_size)
            mb = SampleBatch({k: np.asarray(v)[idx]
                              for k, v in self._dataset.items()})
            metrics = self.learner.update(mb)
            self._since_target_sync += 1
            if self._since_target_sync >= cfg.target_sync_every:
                self.learner.sync_target()
                self._since_target_sync = 0
        self._timesteps += cfg.num_epochs * cfg.minibatch_size
        self._sync_weights()
        return metrics


class CQLConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.cql_alpha = 1.0
        self.num_epochs = 50
        self.minibatch_size = 256
        self.target_sync_every = 20
        self.lr = 1e-3
