"""Connector framework: composable obs/action transforms on the sampling
path.

ray parity: rllib/connectors/connector.py:83 (ConnectorV2 pipelines —
env-to-module transforms applied to observations before the policy, with
state that syncs across the runner gang) and the classic MeanStdFilter
(rllib/utils/filter.py) — running mean/std normalization whose statistics
merge across env runners each iteration (filter synchronization).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Connector:
    """One transform in a pipeline. Stateless unless get/set_state say
    otherwise; ``update`` distinguishes training-time observation (stats
    accumulate) from evaluation (frozen)."""

    def __call__(self, x, update: bool = True):
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict):
        pass

    @staticmethod
    def merge_states(states: List[dict]) -> dict:
        return states[0] if states else {}


class ConnectorPipeline(Connector):
    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, x, update: bool = True):
        for c in self.connectors:
            x = c(x, update=update)
        return x

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def pop_delta_state(self) -> dict:
        return {
            i: (c.pop_delta() if hasattr(c, "pop_delta") else c.get_state())
            for i, c in enumerate(self.connectors)
        }

    def set_state(self, state: dict):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class MeanStdFilter(Connector):
    """Running mean/std observation normalization (ray parity:
    rllib/utils/filter.py MeanStdFilter + FilterManager.synchronize):
    Welford accumulation locally into BOTH the live stats (used for
    normalization) and a delta buffer. Synchronization pops each
    runner's delta (clearing it), merges deltas into the global stats,
    and redistributes the global — re-merging absolute states every
    iteration would compound counts ~num_runners^iteration."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.count = 0.0
        self.mean = np.zeros(self.shape, np.float64)
        self.m2 = np.zeros(self.shape, np.float64)
        self._reset_delta()

    def _reset_delta(self):
        self.d_count = 0.0
        self.d_mean = np.zeros(self.shape, np.float64)
        self.d_m2 = np.zeros(self.shape, np.float64)

    @staticmethod
    def _welford(count, mean, m2, x):
        count += 1.0
        delta = x - mean
        mean = mean + delta / count
        m2 = m2 + delta * (x - mean)
        return count, mean, m2

    def __call__(self, x, update: bool = True):
        x = np.asarray(x, np.float64)
        if update:
            self.count, self.mean, self.m2 = self._welford(
                self.count, self.mean, self.m2, x
            )
            self.d_count, self.d_mean, self.d_m2 = self._welford(
                self.d_count, self.d_mean, self.d_m2, x
            )
        if self.count < 2:
            return np.asarray(x, np.float32)
        std = np.sqrt(self.m2 / (self.count - 1.0)) + 1e-8
        return np.asarray((x - self.mean) / std, np.float32)

    def get_state(self) -> dict:
        """Absolute state (checkpointing)."""
        return {"count": self.count, "mean": self.mean.copy(),
                "m2": self.m2.copy(), "shape": self.shape}

    def pop_delta(self) -> dict:
        """Observations since the last sync; clears the buffer."""
        out = {"count": self.d_count, "mean": self.d_mean.copy(),
               "m2": self.d_m2.copy(), "shape": self.shape}
        self._reset_delta()
        return out

    def set_state(self, state: dict):
        """Adopt the merged global stats (delta buffer keeps collecting
        fresh local observations independently)."""
        self.count = float(state["count"])
        self.mean = np.asarray(state["mean"], np.float64).copy()
        self.m2 = np.asarray(state["m2"], np.float64).copy()

    @staticmethod
    def merge_states(states: List[dict]) -> dict:
        """Chan et al. parallel mean/variance merge."""
        states = [s for s in states if s and s.get("count", 0) > 0]
        if not states:
            return {}
        count = states[0]["count"]
        mean = np.asarray(states[0]["mean"], np.float64).copy()
        m2 = np.asarray(states[0]["m2"], np.float64).copy()
        for s in states[1:]:
            nb = s["count"]
            delta = np.asarray(s["mean"], np.float64) - mean
            tot = count + nb
            m2 = m2 + np.asarray(s["m2"], np.float64) + \
                delta * delta * count * nb / tot
            mean = mean + delta * nb / tot
            count = tot
        return {"count": count, "mean": mean, "m2": m2,
                "shape": states[0]["shape"]}


class ClipObs(Connector):
    """Clip observations into [low, high] (post-normalization guard)."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, x, update: bool = True):
        return np.clip(x, self.low, self.high)


def merge_pipeline_states(states: List[Optional[dict]]) -> Optional[dict]:
    """Merge per-runner pipeline states (index -> connector state):
    MeanStdFilter stats merge with the parallel formula; stateless
    connectors contribute nothing."""
    states = [s for s in states if s]
    if not states:
        return None
    merged: Dict = {}
    for idx in states[0]:
        per = [s.get(idx, {}) for s in states]
        if per[0] and "m2" in per[0]:
            merged[idx] = MeanStdFilter.merge_states(per)
        else:
            merged[idx] = per[0]
    return merged


_FILTERS = {
    "MeanStdFilter": MeanStdFilter,
    "NoFilter": None,
    None: None,
}


def build_obs_pipeline(observation_filter: Optional[str],
                       obs_shape) -> Optional[ConnectorPipeline]:
    """Classic-API entry (config.env_runners(observation_filter=...)):
    MeanStdFilter implies the normalize+clip pipeline the reference uses."""
    if observation_filter in (None, "NoFilter"):
        return None
    if observation_filter not in _FILTERS:
        raise ValueError(
            f"unknown observation_filter {observation_filter!r}; "
            f"known: {sorted(k for k in _FILTERS if k)}"
        )
    return ConnectorPipeline([MeanStdFilter(obs_shape), ClipObs()])
