"""Replay buffers (ray parity: rllib/utils/replay_buffers/
replay_buffer.py:67 + prioritized_replay_buffer.py:19)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._storage: dict = {}
        self._size = 0
        self._next = 0
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add(self, batch: SampleBatch):
        n = batch.count
        if not self._storage:
            self._storage = {
                k: np.zeros((self.capacity, *v.shape[1:]), v.dtype)
                for k, v in batch.items()
            }
        for i in range(n):
            for k, v in batch.items():
                self._storage[k][self._next] = v[i]
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self.rng.integers(0, self._size, size=num_items)
        return SampleBatch({k: v[idx] for k, v in self._storage.items()})


def n_step_transform(batch: SampleBatch, n_step: int,
                     gamma: float) -> SampleBatch:
    """Rewrite a rollout fragment into n-step transitions (ray parity: the
    ``n_step`` knob of rllib/algorithms/dqn — applied before the replay
    buffer, so stored transitions carry aggregated rewards).

    For each t: reward := sum_{k<h} gamma^k r_{t+k}, next_obs := obs after
    the horizon, where the horizon h stops early at episode boundaries.
    Terminations keep done=True (no bootstrap); truncations stop the
    window but leave done=False (bootstrap from the truncated state's
    next_obs). Adds ``nstep_discount`` = gamma^h, the per-sample bootstrap
    discount the TD target must use in place of a flat gamma."""
    if n_step <= 1:
        return batch
    n = batch.count
    rewards = np.asarray(batch[sb.REWARDS], np.float32)
    dones = np.asarray(batch[sb.DONES], bool)
    trunc = np.asarray(
        batch.get(sb.TRUNCATEDS, np.zeros(n, bool)), bool
    )
    next_obs = np.asarray(batch[sb.NEXT_OBS])
    out_r = np.zeros(n, np.float32)
    out_done = np.zeros(n, bool)
    out_next = next_obs.copy()
    out_disc = np.zeros(n, np.float32)
    for t in range(n):
        acc, g = 0.0, 1.0
        h = t
        for k in range(n_step):
            idx = t + k
            if idx >= n:
                break
            acc += g * rewards[idx]
            g *= gamma
            h = idx
            if dones[idx] or trunc[idx]:
                break
        out_r[t] = acc
        out_done[t] = bool(dones[h])
        out_next[t] = next_obs[h]
        out_disc[t] = g  # gamma^h_actual
    data = {k: v for k, v in batch.items()}
    data[sb.REWARDS] = out_r
    data[sb.DONES] = out_done
    data[sb.NEXT_OBS] = out_next
    data["nstep_discount"] = out_disc
    return SampleBatch(data)


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add(self, batch: SampleBatch):
        n = batch.count
        start = self._next
        super().add(batch)
        for i in range(n):
            self._prio[(start + i) % self.capacity] = self._max_prio

    def sample(self, num_items: int) -> SampleBatch:
        p = self._prio[: self._size] ** self.alpha
        p = p / p.sum()
        idx = self.rng.choice(self._size, size=num_items, p=p)
        weights = (self._size * p[idx]) ** (-self.beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._storage.items()})
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        self._prio[idx] = priorities + 1e-6
        self._max_prio = max(self._max_prio, float(priorities.max()))
