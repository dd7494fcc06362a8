"""Evolution strategies: ES and ARS.

ray parity: rllib/algorithms/es (OpenAI-ES: antithetic Gaussian
perturbations, centered-rank fitness shaping) and rllib/algorithms/ars
(Augmented Random Search: top-k direction selection, reward-std step
normalization). These are the reference's showcase of embarrassingly
parallel RL — no gradients cross the wire, only (noise seed, episode
return) pairs — and they map directly onto the actor fleet: each
perturbation is an ordered set_weights + evaluate pair on an env-runner
actor, fanned out round-robin.

The search vector theta is the module's weights flattened in flax's
``ravel_pytree`` order (``RLModule.ravel``), so the same noise seed
perturbs the same weights as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """OpenAI-ES fitness shaping: returns in [-0.5, 0.5] by rank."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / (len(x) - 1) - 0.5


class ES(Algorithm):
    """OpenAI evolution strategies over the discrete policy net."""

    def setup(self, config):
        super().setup(config)
        self._theta = self.module.ravel()
        self._es_rng = np.random.default_rng(self._algo_config.seed)

    def _evaluate_population(self, seeds, signs) -> np.ndarray:
        """Fan (seed, sign) candidate descriptors across the runner fleet.
        The base theta ships ONCE per iteration as a shared object-store
        ref; each candidate call carries only a seed + sign, and the
        runner regenerates the perturbation (evaluate_perturbed — atomic
        weights+rollout, so actor restarts/retries re-run both halves).
        Dispatched through the shared runner-FT wrapper like every other
        algorithm's gang."""
        cfg = self._algo_config

        def fan_out():
            base_ref = ray_tpu_torch.put(self._theta)
            refs = [
                self.runners[i % len(self.runners)].evaluate_perturbed.remote(
                    base_ref, int(seed), float(sign), cfg.noise_std,
                    cfg.episodes_per_candidate,
                )
                for i, (seed, sign) in enumerate(zip(seeds, signs))
            ]
            return ray_tpu_torch.get(refs, timeout=600)

        results = self._with_runner_ft(fan_out)
        self._timesteps += int(sum(r["steps"] for r in results))
        return np.asarray([r["return"] for r in results], np.float32)

    def training_step(self) -> Dict:
        cfg = self._algo_config
        half = cfg.population // 2
        seeds = self._es_rng.integers(0, 2**31 - 1, size=half)
        eps = np.stack([
            np.random.default_rng(int(s)).standard_normal(
                self._theta.size).astype(np.float32)
            for s in seeds
        ])
        all_seeds = np.concatenate([seeds, seeds])
        signs = np.concatenate([np.ones(half), -np.ones(half)])
        scores = self._evaluate_population(all_seeds, signs)
        update = self._es_update(eps, scores[:half], scores[half:])
        self._theta = self._theta + update
        self.module.set_state(self.module.unravel(self._theta))
        # push the updated mean policy everywhere: runners still hold the
        # LAST candidate's perturbed weights, which would otherwise leak
        # into evaluate() / the next checkpoint's runner state
        self._sync_weights()
        return {
            "episode_return_mean": float(scores.mean()),
            "population_best": float(scores.max()),
        }

    def load_checkpoint(self, checkpoint):
        super().load_checkpoint(checkpoint)
        # _theta is the ES source of truth — re-sync it from the restored
        # module or the next training_step perturbs the stale init vector
        self._theta = self.module.ravel()

    def _es_update(self, eps, plus, minus) -> np.ndarray:
        cfg = self._algo_config
        shaped = _centered_ranks(np.concatenate([plus, minus]))
        weights = shaped[: len(plus)] - shaped[len(plus):]
        return (cfg.lr / (len(eps) * cfg.noise_std)) * (weights @ eps)


class ARS(ES):
    """Augmented random search: keep only the top_k directions by
    max(plus, minus) and scale the step by the reward std of the survivors
    (Mania et al. 2018; ray parity: rllib/algorithms/ars)."""

    def _es_update(self, eps, plus, minus) -> np.ndarray:
        cfg = self._algo_config
        k = min(cfg.ars_top_k, len(eps))
        order = np.argsort(-np.maximum(plus, minus))[:k]
        used = np.concatenate([plus[order], minus[order]])
        sigma_r = used.std() + 1e-8
        diffs = plus[order] - minus[order]
        return (cfg.lr / (k * sigma_r)) * (diffs @ eps[order])


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(ES)
        self.population = 32  # total candidates (antithetic pairs: pop/2)
        self.noise_std = 0.05
        self.lr = 0.03
        self.episodes_per_candidate = 1
        self.num_env_runners = 4


class ARSConfig(ESConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = ARS
        self.ars_top_k = 8
