"""SampleBatch + advantage estimation.

Reference parity: ray rllib/policy/sample_batch.py:98 (SampleBatch) and
rllib/evaluation/postprocessing.py (GAE) — a dict of parallel numpy
arrays with concat/shuffle/minibatch helpers. GAE runs here on the host;
v-trace runs in the learner, on its device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"  # terminated only: cuts the reward bootstrap
TRUNCATEDS = "truncateds"  # time-limit cut: cuts the GAE chain, not bootstrap
NEXT_OBS = "next_obs"
LOGP = "logp"
VALUES = "values"
VF_NEXT = "vf_next"  # V(s_{t+1}) with the *pre-reset* obs at truncations
ADVANTAGES = "advantages"
TARGETS = "value_targets"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat(batches: List["SampleBatch"]) -> "SampleBatch":
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in keys}
        )

    def shuffled(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for start in range(0, n, size):
            yield SampleBatch(
                {k: v[start : start + size] for k, v in self.items()}
            )

    def shards(self, n: int) -> List["SampleBatch"]:
        """Split into n EQUAL-size shards (remainder dropped): DDP learners
        must run identical minibatch counts or their lockstep gradient
        allreduces deadlock (ray parity: learner_group.py batch sharding)."""
        per = self.count // n
        if per == 0:
            raise ValueError(
                f"batch of {self.count} rows cannot shard {n} ways"
            )
        return [
            SampleBatch({
                k: v[i * per:(i + 1) * per] for k, v in self.items()
            })
            for i in range(n)
        ]


def returns_to_go(batch: SampleBatch, gamma: float) -> np.ndarray:
    """Discounted returns-to-go, reset at episode boundaries (terminated
    OR truncated — past a cut, the tail of that episode is unknown to
    this batch). Shared by PG (Monte-Carlo targets) and offline MARWIL."""
    rewards = np.asarray(batch[REWARDS], np.float32)
    dones = np.asarray(batch[DONES], bool)
    truncs = np.asarray(batch.get(TRUNCATEDS, np.zeros(len(rewards), bool)),
                        bool)
    ret = np.zeros(len(rewards), np.float32)
    running = 0.0
    for t in reversed(range(len(rewards))):
        if dones[t] or truncs[t]:
            running = 0.0
        running = rewards[t] + gamma * running
        ret[t] = running
    return ret


def compute_gae(batch: SampleBatch, last_value: float, gamma: float,
                lam: float) -> SampleBatch:
    """Generalized advantage estimation over one rollout fragment
    (ray parity: postprocessing.compute_advantages).

    Truncation (time-limit) handling: the value bootstrap at a truncated
    step uses V of the episode's *final* observation (``VF_NEXT``, captured
    before the env reset), and the GAE chain is cut there — terminated
    steps cut both the bootstrap and the chain.
    """
    rewards = batch[REWARDS]
    values = batch[VALUES]
    dones = batch[DONES]
    n = len(rewards)
    if VF_NEXT in batch:
        vf_next = batch[VF_NEXT]
    else:  # legacy path: V(s_{t+1}) = values[t+1], fragment end = last_value
        vf_next = np.concatenate(
            [values[1:], np.asarray([last_value], values.dtype)]
        )
    truncs = batch.get(TRUNCATEDS, np.zeros(n, np.bool_))
    adv = np.zeros(n, np.float32)
    last_gae = 0.0
    for t in reversed(range(n)):
        nonterminal = 1.0 - float(dones[t])
        chain = nonterminal * (1.0 - float(truncs[t]))
        delta = rewards[t] + gamma * vf_next[t] * nonterminal - values[t]
        last_gae = delta + gamma * lam * chain * last_gae
        adv[t] = last_gae
    batch[ADVANTAGES] = adv
    batch[TARGETS] = adv + values
    return batch
