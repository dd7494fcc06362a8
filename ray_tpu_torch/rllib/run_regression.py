"""RLlib learning-regression runner.

Reference parity: ray rllib/tests/run_regression_tests.py + the
rllib/tuned_examples/ config registry — per-algorithm YAML files declare
an environment, a training config, and a stop block with a reward
threshold; one command runs every config and fails if any algorithm
stops learning.

Usage::

    python -m ray_tpu_torch.rllib.run_regression            # all configs
    python -m ray_tpu_torch.rllib.run_regression --select ppo
    python -m ray_tpu_torch.rllib.run_regression --dir my_configs/
    python -m ray_tpu_torch.rllib.run_regression --num-gpus-per-learner 0

Learners run where each config puts them: on the card by default
(``num_gpus_per_learner`` 1). ``--num-gpus-per-learner`` overrides every
config's share; 0 learns on the CPU.

Config shape (one or more experiments per file)::

    cartpole-ppo:
      algorithm: PPO           # <Name>Config looked up in ray_tpu_torch.rllib
      env: CartPole-native
      stop:
        episode_return_mean: 100.0   # pass threshold (required)
        training_iteration: 30       # iteration budget (required)
      config:                  # sections = AlgorithmConfig builder calls
        env_runners: {num_env_runners: 2}
        training: {lr: 0.005}
        learners: {num_learners: 2, num_gpus_per_learner: 0.5}
        debugging: {seed: 0}
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time
from typing import Dict, List

TUNED_EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "tuned_examples")


def load_experiments(directory: str, select: str = "") -> Dict[str, dict]:
    import yaml

    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.yaml"))):
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for name, spec in doc.items():
            if select and select not in name:
                continue
            if name in out:
                raise ValueError(
                    f"duplicate experiment name {name!r} in {path}; a "
                    "silent overwrite would drop a regression config"
                )
            out[name] = spec
    return out


_DATASETS: Dict[str, str] = {}


def offline_dataset(kind: str, num_gpus_per_learner=None) -> str:
    """Generate (once per harness run) a shared offline dataset for the
    offline algorithms' tuned examples (ray parity: the data files
    shipped under rllib/tuned_examples/ for MARWIL/CQL/DT). The
    ``cartpole_expert`` dataset is a briefly-trained PPO expert's
    rollouts with rewards/dones/next_obs: 8 iterations of PPO, its learner
    where ``num_gpus_per_learner`` puts it (the card by default), then 2 x
    512 steps from its runner. The file goes under a fresh temporary
    directory."""
    if kind in _DATASETS:
        return _DATASETS[kind]
    if kind != "cartpole_expert":
        raise ValueError(f"unknown offline dataset {kind!r}")
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.offline import write_json

    config = (
        PPOConfig()
        .environment("CartPole-native")
        .env_runners(num_env_runners=1, rollout_fragment_length=512)
        .training(num_epochs=6, minibatch_size=128)
        .debugging(seed=0)
    )
    if num_gpus_per_learner is not None:
        config = config.learners(num_gpus_per_learner=num_gpus_per_learner)
    expert = config.build()
    try:
        for _ in range(8):
            expert.train()
        recorded = rt.get(
            [expert.runners[0].sample.remote(512) for _ in range(2)],
            timeout=300,
        )
        path = write_json(
            recorded,
            os.path.join(tempfile.mkdtemp(prefix="rllib_regression_"),
                         "expert.jsonl"),
        )
    finally:
        expert.stop()
    _DATASETS[kind] = path
    return path


def build_algorithm(spec: dict, num_gpus_per_learner=None):
    import ray_tpu_torch.rllib as rllib

    algo_name = spec["algorithm"]
    config_cls = getattr(rllib, f"{algo_name}Config", None)
    if config_cls is None:
        raise ValueError(f"unknown algorithm {algo_name!r}")
    config = config_cls().environment(spec["env"])
    if spec.get("offline_dataset"):
        config = config.offline_data(input_=offline_dataset(
            spec["offline_dataset"], num_gpus_per_learner))
    for section, kwargs in (spec.get("config") or {}).items():
        method = getattr(config, section, None)
        if method is None or not callable(method):
            raise ValueError(
                f"{algo_name}Config has no builder section {section!r}"
            )
        # the fluent builders silently drop unknown kwargs; a typoed
        # hyperparameter would test defaults while looking tuned
        for key in kwargs:
            if not hasattr(config, key) and section == "training":
                raise ValueError(
                    f"{algo_name}Config.{section}() does not know "
                    f"{key!r} (typo in the tuned-example config?)"
                )
        config = method(**kwargs)
    if num_gpus_per_learner is not None:
        config = config.learners(num_gpus_per_learner=num_gpus_per_learner)
    return config.build()


def run_experiment(name: str, spec: dict, num_gpus_per_learner=None) -> dict:
    stop = spec.get("stop") or {}
    threshold = stop.get("episode_return_mean")
    # offline algorithms (MARWIL/CQL/DT) never emit training returns —
    # their pass bar is a post-training greedy EVALUATION return
    eval_threshold = stop.get("evaluation_return_mean")
    if threshold is None and eval_threshold is None:
        # a missing/misspelled threshold must not silently auto-pass:
        # this harness exists to catch learning regressions
        raise ValueError(
            f"experiment {name!r} has no stop.episode_return_mean or "
            f"stop.evaluation_return_mean threshold "
            f"(found stop keys: {sorted(stop)})"
        )
    max_iters = int(stop.get("training_iteration", 50))
    algo = build_algorithm(spec, num_gpus_per_learner)
    best = float("-inf")
    iters = 0
    t0 = time.monotonic()
    try:
        for iters in range(1, max_iters + 1):
            result = algo.train()
            r = result.get("episode_return_mean")
            if r is not None:
                best = max(best, r)
            if threshold is not None and best >= threshold:
                break
        eval_score = None
        if eval_threshold is not None:
            # judged ALONE: mixing in training returns would let lucky
            # exploration rollouts mask a regressed greedy policy
            eval_score = algo.evaluate()["evaluation"][
                "episode_return_mean"]
    finally:
        algo.stop()
    if eval_threshold is not None:
        passed = eval_score >= eval_threshold
        bar, shown = eval_threshold, eval_score
    else:
        passed = best >= threshold
        bar, shown = threshold, best
    return {
        "name": name, "passed": passed, "best": shown,
        "threshold": bar, "iterations": iters,
        "wall_s": round(time.monotonic() - t0, 1),
    }


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--select", default="",
                        help="substring filter on experiment names")
    parser.add_argument("--dir", default=TUNED_EXAMPLES_DIR,
                        help="directory of tuned-example YAMLs")
    parser.add_argument("--num-cpus", type=int, default=4)
    parser.add_argument("--num-gpus-per-learner", type=float, default=None,
                        help="every config's learner share of a card "
                             "(0: learn on the CPU)")
    args = parser.parse_args(argv)

    experiments = load_experiments(args.dir, args.select)
    if not experiments:
        print(f"no experiments matched --select {args.select!r} "
              f"in {args.dir}")
        return 2

    import torch

    import ray_tpu_torch

    started_here = not ray_tpu_torch.is_initialized()
    if started_here:
        # the node advertises this host's cards for learner actors
        ray_tpu_torch.init(num_cpus=args.num_cpus,
                           num_gpus=torch.cuda.device_count())
    results = []
    try:
        for name, spec in experiments.items():
            print(f"== {name} ({spec['algorithm']} on {spec['env']})",
                  flush=True)
            res = run_experiment(name, spec, args.num_gpus_per_learner)
            results.append(res)
            status = "PASS" if res["passed"] else "FAIL"
            print(f"   {status}: best={res['best']:.1f} "
                  f"threshold={res['threshold']} "
                  f"iters={res['iterations']} ({res['wall_s']}s)",
                  flush=True)
    finally:
        if started_here:
            ray_tpu_torch.shutdown()

    failed = [r for r in results if not r["passed"]]
    print(f"\n{len(results) - len(failed)}/{len(results)} regression "
          f"configs passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
