"""Algorithm + AlgorithmConfig: the RL training drivers.

Reference parity: ray rllib/algorithms/algorithm.py:815 (Algorithm is a
Tune Trainable; step() = training_step + metrics) and
algorithm_config.py (fluent config). PPO's training_step mirrors
rllib/algorithms/ppo/ppo.py:424 (synchronous_parallel_sample →
learner update → weight broadcast); IMPALA applies v-trace to
behavior-policy fragments; DQN replays from a (prioritized) buffer.

The learner runs on the card: ``num_gpus_per_learner`` (default 1) puts the
in-driver learner on the current CUDA device, or gives each learner actor
that share of a card; ``num_gpus_per_learner=0`` is the one way to learn on
the CPU. Env runners step their envs on CPUs and never see the card.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional, Type

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.env import env_spaces, make_env
from ray_tpu_torch.rllib.env_runner import RUNNER_RUNTIME_ENV, EnvRunner
from ray_tpu_torch.rllib.learner import (
    A2CLearner,
    APPOLearner,
    DQNLearner,
    ImpalaLearner,
    Learner,
    PGLearner,
    PPOLearner,
    SACLearner,
    TD3Learner,
)
from ray_tpu_torch.rllib.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    n_step_transform,
)
from ray_tpu_torch.rllib.rl_module import RLModule, learner_device
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae, returns_to_go
from ray_tpu_torch.tune.trainable import Trainable


_NO_TPUS = ("num_tpus_per_learner: no node of this runtime advertises TPUs, "
             "so such a learner would never be placed; use "
             "num_gpus_per_learner")


class AlgorithmConfig:
    """Fluent config (ray parity: AlgorithmConfig.environment()
    .env_runners().training().resources())."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env = "CartPole-native"
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners = 2
        self.rollout_fragment_length = 200
        # external-env mode (ray parity: PolicyServerInput): when set,
        # runners host policy servers on consecutive ports instead of
        # stepping the env; the env is probed for spaces only
        self.policy_server_port: Optional[int] = None
        self.policy_server_host: str = "127.0.0.1"
        # >=1: that many learner ACTORS with DDP gradient sync
        # (LearnerGroup); 0 = one in-driver learner (ray parity:
        # config.learners(num_learners=...))
        self.num_learners = 0
        self.num_cpus_per_learner = 0.5
        # the learner's share of a card: 1 = the in-driver learner on the
        # current CUDA device; a fraction packs learner actors onto one
        # card; 0 = learn on the CPU
        self.num_gpus_per_learner = 1
        # connectors (ray parity: ConnectorV2 / classic MeanStdFilter):
        # "MeanStdFilter" normalizes observations on every runner with
        # cross-runner stat merging each iteration
        self.observation_filter: Optional[str] = None
        # evaluation plane (ray parity: config.evaluation(...) +
        # evaluation workers): a separate runner gang scores the greedy
        # policy every evaluation_interval train iterations
        self.evaluation_interval: Optional[int] = None
        self.evaluation_num_env_runners = 0
        self.evaluation_duration = 5  # episodes per eval runner
        self.lr = 5e-3
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.train_batch_size = 0  # derived if 0
        self.minibatch_size = 128
        self.num_epochs = 6
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.grad_clip = 0.5
        self.model: Dict[str, Any] = {"hiddens": (64, 64)}
        self.seed = 0
        # DQN
        self.replay_buffer_capacity = 50_000
        self.target_network_update_freq = 500
        self.epsilon = (1.0, 0.05, 10_000)  # start, end, decay steps
        self.num_steps_sampled_before_learning = 1_000

    # -- fluent setters -------------------------------------------------
    def environment(self, env=None, *, env_config=None, **_kw):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners=None,
                    rollout_fragment_length=None,
                    observation_filter=None, policy_server_port=None,
                    policy_server_host=None, **_kw):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if observation_filter is not None:
            self.observation_filter = observation_filter
        if policy_server_port is not None:
            # external-env sampling: runner i serves PolicyClients on
            # port+i instead of stepping an env (rllib/external_env.py)
            self.policy_server_port = policy_server_port
        if policy_server_host is not None:
            self.policy_server_host = policy_server_host
        return self

    def evaluation(self, *, evaluation_interval=None,
                   evaluation_num_env_runners=None,
                   evaluation_duration=None, **_kw):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = evaluation_num_env_runners
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    # accepted for reference-API compatibility
    rollouts = env_runners

    def learners(self, *, num_learners=None, num_cpus_per_learner=None,
                 num_tpus_per_learner=None, num_gpus_per_learner=None,
                 **_kw):
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if num_tpus_per_learner is not None:
            raise ValueError(_NO_TPUS)
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            key = {"lambda": "lambda_"}.get(k, k)
            if not hasattr(self, key):
                continue
            setattr(self, key, v)
        return self

    def framework(self, *_a, **_k):
        return self  # always torch here

    def resources(self, **_k):
        return self

    def debugging(self, *, seed=None, **_k):
        if seed is not None:
            self.seed = seed
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v for k, v in vars(self).items() if k != "algo_class"
        }

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, env=None) -> "Algorithm":
        if env is not None:
            self.env = env
        cls = self.algo_class or Algorithm
        return cls(config=self)

    # Trainable-style usage through Tune
    def build_algo(self, env=None):
        return self.build(env)


def _clock_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded from the clock (exploration in
    ``compute_single_action``)."""
    return torch.Generator(device=device).manual_seed(
        int(time.time() * 1e6) % 2**31)


class Algorithm(Trainable):
    """Trainable subclass so Tuner(PPO, param_space=...) works."""

    _config_cls = AlgorithmConfig
    _learner_cls: Type[Learner] = PPOLearner

    def __init__(self, config: Optional[AlgorithmConfig] = None,
                 env=None, trial_info=None, **kw):
        if isinstance(config, dict):
            if "num_tpus_per_learner" in config:
                raise ValueError(_NO_TPUS)
            cfg = self._config_cls(type(self))
            for k, v in config.items():
                key = {"lambda": "lambda_"}.get(k, k)
                if hasattr(cfg, key):
                    setattr(cfg, key, v)
            config = cfg
        self._algo_config = config or self._config_cls(type(self))
        if env is not None:
            self._algo_config.env = env
        super().__init__(self._algo_config.to_dict(), trial_info)
        # Trainable.__init__ set self.config to the plain dict; the typed
        # config is the API surface (ray parity: Algorithm.config)
        self.config = self._algo_config

    # -- Trainable plumbing --------------------------------------------
    def setup(self, _config: Dict):
        cfg = self._algo_config
        probe = make_env(cfg.env, cfg.env_config)
        obs_shape, num_actions = env_spaces(probe)
        if hasattr(probe, "close"):
            probe.close()
        hiddens = tuple(cfg.model.get("hiddens", (64, 64)))
        dueling = bool(getattr(cfg, "dueling", False))
        gpus = getattr(cfg, "num_gpus_per_learner", 1)
        group = getattr(cfg, "num_learners", 0) >= 1
        # with learner actors the driver's module only mirrors their
        # weights for local inference: it stays on the CPU
        self.module = RLModule(
            obs_shape, num_actions, seed=cfg.seed, hiddens=hiddens,
            dueling=dueling,
            device="cpu" if group else learner_device(gpus),
        )
        if group:
            # Multi-learner plane: N learner actors, DDP gradient sync.
            # Each worker rebuilds an identical module (same seed) so the
            # replicas start in sync; the driver's module mirrors rank-0
            # weights at every _sync_weights for local inference.
            if not getattr(self._learner_cls, "supports_ddp", False):
                raise ValueError(
                    f"num_learners={cfg.num_learners} is not supported for "
                    f"{self._learner_cls.__name__}: only learners with the "
                    "split grad/apply step (PPO, PG, A2C, IMPALA, APPO) can "
                    "run under LearnerGroup; use num_learners=0"
                )
            from ray_tpu_torch.rllib.learner_group import LearnerGroup

            if gpus and ray_tpu_torch.cluster_resources().get(
                    "GPU", 0) < gpus:
                raise RuntimeError(
                    f"num_gpus_per_learner={gpus}: the cluster has no such "
                    "share of a GPU; pass num_gpus_per_learner=0 to learn "
                    "on the CPU")
            seed, model_hiddens = cfg.seed, hiddens

            def module_factory(_shape=obs_shape, _n=num_actions):
                # runs in the learner actor: the card it leased, or the CPU
                return RLModule(_shape, _n, seed=seed, hiddens=model_hiddens,
                                dueling=dueling, device=learner_device(gpus))

            self.learner = LearnerGroup(
                self._learner_cls, module_factory, cfg,
                num_learners=cfg.num_learners,
                num_cpus_per_learner=getattr(cfg, "num_cpus_per_learner", 0.5),
                num_gpus_per_learner=gpus,
            )
        else:
            self.learner = self._learner_cls(self.module, cfg)
        # Sampling plane runs on host CPUs: the learner owns the card, and
        # runner processes do not see it.
        if getattr(cfg, "policy_server_port", None) is not None:
            # external-env sampling: each runner hosts a policy server on
            # port+i; PolicyClients drive the episodes
            if not getattr(self, "_supports_external_env", False):
                raise ValueError(
                    f"policy_server_port is only supported for off-policy "
                    f"algorithms training from plain transitions (DQN, "
                    f"SAC) — {type(self).__name__}'s training step needs "
                    f"on-policy keys (logp/values/bootstrap) external "
                    f"clients don't produce"
                )
            from ray_tpu_torch.rllib.external_env import PolicyServerRunner

            server_cls = ray_tpu_torch.remote(
                num_cpus=0.5, max_restarts=2, max_task_retries=2,
                runtime_env=RUNNER_RUNTIME_ENV,
            )(PolicyServerRunner)
            self._runner_factory = (
                lambda i, replacement=False: server_cls.remote(
                    cfg.env, cfg.env_config,
                    {"hiddens": hiddens, "dueling": dueling},
                    seed=cfg.seed + i,
                    host=cfg.policy_server_host,
                    port=cfg.policy_server_port + i,
                )
            )
            self.runners = [
                self._runner_factory(i) for i in range(cfg.num_env_runners)
            ]
            self.eval_runners = []
            self._timesteps = 0
            return
        runner_cls = ray_tpu_torch.remote(
            num_cpus=0.5,
            # Survive transient worker death (memory-monitor kills under
            # concurrent Tune trials): the actor restarts in place and the
            # in-flight call retries, so _sync_weights never sees a dead
            # actor for a one-off kill (ray parity: FaultTolerantActorManager
            # + max_restarts on rollout workers).
            max_restarts=2,
            max_task_retries=2,
            runtime_env=RUNNER_RUNTIME_ENV,
        )(EnvRunner)
        self._runner_factory = lambda i, replacement=False: runner_cls.remote(
            cfg.env, cfg.env_config,
            {"hiddens": hiddens, "dueling": dueling},
            seed=cfg.seed + i,
            observation_filter=getattr(cfg, "observation_filter", None),
        )
        self.runners = [
            self._runner_factory(i) for i in range(cfg.num_env_runners)
        ]
        # evaluation gang: separate actors so eval episodes never disturb
        # the training runners' env cursors or filter stats (ray parity:
        # evaluation workers / evaluation_num_env_runners)
        self.eval_runners = [
            self._runner_factory(10_000 + i)
            for i in range(getattr(cfg, "evaluation_num_env_runners", 0))
        ]
        self._timesteps = 0

    def step(self) -> Dict:
        metrics = self.training_step()
        self._train_iter = getattr(self, "_train_iter", 0) + 1
        metrics["num_env_steps_sampled_lifetime"] = self._timesteps
        self._sync_connectors()
        runner_metrics = self._with_runner_ft(lambda: ray_tpu_torch.get(
            [r.get_metrics.remote() for r in self.runners]
        ))
        returns = [
            m["episode_return_mean"]
            for m in runner_metrics
            if m.get("episodes_this_iter")
        ]
        if returns:
            metrics["episode_return_mean"] = float(np.mean(returns))
            # legacy metric name used across reference tooling
            metrics["episode_reward_mean"] = metrics["episode_return_mean"]
        interval = getattr(self.config, "evaluation_interval", None)
        if interval and self._train_iter % interval == 0:
            metrics.update(self.evaluate())
        return metrics

    def _sync_connectors(self):
        """Pull each runner's observation DELTAS (cleared on pop), fold
        them into the global filter state, and redistribute the global
        (ray parity: FilterManager.synchronize — merging absolute states
        instead would compound counts ~num_runners^iteration)."""
        if not getattr(self.config, "observation_filter", None):
            return
        from ray_tpu_torch.rllib.connectors import merge_pipeline_states

        try:
            deltas = ray_tpu_torch.get(
                [r.pop_connector_delta.remote() for r in self.runners],
                timeout=120,
            )
        except Exception:
            return  # dead runner: _restore_dead_runners handles it
        merged = merge_pipeline_states(
            [d for d in deltas] + [getattr(self, "_connector_state", None)]
        )
        if merged is None:
            return
        self._connector_state = merged
        targets = self.runners + getattr(self, "eval_runners", [])
        try:
            ray_tpu_torch.get(
                [r.set_connector_state.remote(merged) for r in targets],
                timeout=120,
            )
        except Exception:
            pass

    def training_step(self) -> Dict:
        raise NotImplementedError

    # -- utils ----------------------------------------------------------
    def _restore_dead_runners(self):
        """Probe each runner and replace the dead (ray parity:
        rllib/utils/actor_manager.py FaultTolerantActorManager — a killed
        rollout worker is recreated, not fatal to training)."""
        import logging

        log = logging.getLogger(__name__)
        probes = [r.ping.remote() for r in self.runners]
        replaced = 0
        weights = None
        for i, p in enumerate(probes):
            try:
                ray_tpu_torch.get(p, timeout=120)
                continue
            except Exception:
                pass
            try:
                # a slow-but-alive runner misdiagnosed by the probe must
                # not linger as a duplicate actor eating CPU
                ray_tpu_torch.kill(self.runners[i])
            except Exception:
                pass
            self.runners[i] = self._runner_factory(i, replacement=True)
            replaced += 1
            # fresh runner must not sample with init weights: retry the
            # push once, and if it still fails say so loudly — on-policy
            # learners would train on a stale-policy fragment otherwise
            if weights is None:
                weights = ray_tpu_torch.put(self.learner.get_weights())
            for attempt in (1, 2):
                try:
                    ray_tpu_torch.get(
                        self.runners[i].set_weights.remote(weights),
                        timeout=120,
                    )
                    break
                except Exception as e:
                    if attempt == 2:
                        log.warning(
                            "replacement runner %d did not take weights "
                            "(%s); its first fragment may be off-policy",
                            i, e,
                        )
        if replaced:
            log.warning("replaced %d dead env runner(s)", replaced)
        return replaced

    def _restore_dead_eval_runners(self):
        """Probe+replace the evaluation gang (mirrors
        _restore_dead_runners for the training gang)."""
        probes = [r.ping.remote() for r in self.eval_runners]
        for i, p in enumerate(probes):
            try:
                ray_tpu_torch.get(p, timeout=120)
                continue
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(self.eval_runners[i])
            except Exception:
                pass
            self.eval_runners[i] = self._runner_factory(
                10_000 + i, replacement=True
            )
            conn = getattr(self, "_connector_state", None)
            if conn:
                try:
                    ray_tpu_torch.get(
                        self.eval_runners[i].set_connector_state.remote(conn),
                        timeout=120,
                    )
                except Exception:
                    pass

    def _with_runner_ft(self, fn, attempts: int = 3):
        """Run a fan-out; on failure restore dead runners and retry.

        Up to ``attempts`` tries total: each failure triggers a probe+replace
        pass, and the retry re-issues the whole fan-out against the (possibly
        refreshed) runner set. A failure with no dead runner found is not
        retriable — it is a real application error, re-raise it."""
        last = None
        for i in range(attempts):
            try:
                return fn()
            except Exception as e:
                last = e
                if not self._restore_dead_runners():
                    raise
        raise last

    def _sync_weights(self):
        raw = self.learner.get_weights()
        from ray_tpu_torch.rllib.learner_group import LearnerGroup

        if isinstance(self.learner, LearnerGroup):
            # keep the driver's module current for compute_single_action /
            # evaluate (with an in-driver learner they share params)
            self.module.set_state(raw)
        weights = ray_tpu_torch.put(raw)
        self._with_runner_ft(lambda: ray_tpu_torch.get(
            [r.set_weights.remote(weights) for r in self.runners]
        ))

    def _sample_all(self) -> List[SampleBatch]:
        cfg = self.config
        return self._with_runner_ft(lambda: ray_tpu_torch.get(
            [
                r.sample.remote(cfg.rollout_fragment_length)
                for r in self.runners
            ]
        ))

    def compute_single_action(self, obs, explore: bool = False):
        obs = np.asarray(obs, np.float32)[None, :]
        if explore:
            a, _, _ = self.module.action_exploration(obs, _clock_generator(
                self.module.device))
            return int(a[0])
        return int(self.module.action_greedy(obs)[0])

    def get_policy_state(self):
        return self.learner.get_weights()

    def save_checkpoint(self, checkpoint_dir=None) -> Dict:
        return {"weights": self.learner.get_weights(),
                "opt_state": self.learner.get_optimizer_state(),
                "timesteps": self._timesteps,
                "connectors": getattr(self, "_connector_state", None)}

    def load_checkpoint(self, checkpoint: Optional[Dict]):
        if checkpoint:
            self.learner.set_weights(checkpoint["weights"])
            # restore Adam moments (None re-inits: a legacy checkpoint must
            # not keep moments matched to the overwritten weights)
            self.learner.set_optimizer_state(checkpoint.get("opt_state"))
            self.module.set_state(checkpoint["weights"])
            self._timesteps = checkpoint.get("timesteps", 0)
            self._sync_weights()
            conn = checkpoint.get("connectors")
            if conn:
                self._connector_state = conn
                targets = self.runners + getattr(self, "eval_runners", [])
                try:
                    ray_tpu_torch.get(
                        [r.set_connector_state.remote(conn) for r in targets],
                        timeout=120,
                    )
                except Exception:
                    pass

    def cleanup(self):
        for r in getattr(self, "runners", []) + getattr(self, "eval_runners", []):
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        learner = getattr(self, "learner", None)
        if learner is not None and hasattr(learner, "shutdown"):
            try:
                learner.shutdown()
            except Exception:
                pass

    def stop(self):
        super().stop()

    def evaluate(self) -> Dict:
        """Greedy-policy evaluation. With an eval gang configured
        (evaluation_num_env_runners > 0) the episodes run on dedicated
        workers in parallel with fresh weights; otherwise on training
        runner 0 (ray parity: Algorithm.evaluate / evaluation workers)."""
        episodes = getattr(self.config, "evaluation_duration", 5)
        gang = getattr(self, "eval_runners", [])
        if gang:
            def run_gang():
                weights = ray_tpu_torch.put(self.learner.get_weights())
                ray_tpu_torch.get(
                    [r.set_weights.remote(weights) for r in self.eval_runners],
                    timeout=120,
                )
                return ray_tpu_torch.get(
                    [r.evaluate.remote(episodes) for r in self.eval_runners],
                    timeout=600,
                )

            try:
                scores = run_gang()
            except Exception:
                # same FT discipline as the training gang: replace the
                # dead, retry once — a lost eval runner must not fail an
                # otherwise healthy trial
                self._restore_dead_eval_runners()
                scores = run_gang()
            return {"evaluation": {
                "episode_return_mean": float(np.mean(scores)),
                "num_episodes": episodes * len(gang),
            }}
        score = ray_tpu_torch.get(
            self.runners[0].evaluate.remote(episodes), timeout=600
        )
        return {"evaluation": {"episode_return_mean": score,
                               "num_episodes": episodes}}


class PPO(Algorithm):
    _learner_cls = PPOLearner

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        fragments = self._sample_all()
        processed = []
        for frag in fragments:
            processed.append(
                compute_gae(
                    frag, float(frag["bootstrap_value"][-1]),
                    cfg.gamma, cfg.lambda_,
                )
            )
        batch = SampleBatch.concat(processed)
        self._timesteps += batch.count
        return self.learner.update(batch)


class PG(Algorithm):
    """Vanilla policy gradient (ray parity: rllib/algorithms/pg):
    Monte-Carlo returns-to-go, no critic in the loss."""

    _learner_cls = PGLearner

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        processed = []
        for frag in self._sample_all():
            frag[sb.ADVANTAGES] = returns_to_go(frag, cfg.gamma)
            processed.append(frag)
        batch = SampleBatch.concat(processed)
        # normalize across the whole train batch (variance reduction —
        # REINFORCE has no baseline)
        ret = batch[sb.ADVANTAGES]
        batch[sb.ADVANTAGES] = (ret - ret.mean()) / (ret.std() + 1e-8)
        self._timesteps += batch.count
        return self.learner.update(batch)


class A2C(Algorithm):
    """Synchronous advantage actor-critic (ray parity:
    rllib/algorithms/a2c): PPO's sampling + GAE plumbing, unclipped loss,
    exactly one gradient pass per batch."""

    _learner_cls = A2CLearner

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        processed = [
            compute_gae(frag, float(frag["bootstrap_value"][-1]),
                        cfg.gamma, cfg.lambda_)
            for frag in self._sample_all()
        ]
        batch = SampleBatch.concat(processed)
        self._timesteps += batch.count
        return self.learner.update(batch)


class IMPALA(Algorithm):
    _learner_cls = ImpalaLearner

    def training_step(self) -> Dict:
        self._sync_weights()
        fragments = self._sample_all()
        metrics = {}
        for frag in fragments:  # per-fragment v-trace (time ordering)
            self._timesteps += frag.count
            metrics = self.learner.update(frag)
        return metrics


class APPO(Algorithm):
    """Async PPO (ray parity: rllib/algorithms/appo): IMPALA's fragment
    flow, but v-trace feeds a clipped surrogate so each fragment batch
    sustains several SGD passes."""

    _learner_cls = APPOLearner

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        fragments = self._sample_all()
        for frag in fragments:
            self._timesteps += frag.count
        metrics = {}
        passes = max(1, cfg.num_epochs // 2)
        for _ in range(passes):
            for frag in fragments:  # per-fragment: v-trace needs time order
                metrics = self.learner.update(frag)
        return metrics


class DQN(Algorithm):
    """DQN with the reference's rainbow-family options on by default:
    double-Q, dueling heads, optional n-step returns, and prioritized
    replay (ray parity: rllib/algorithms/dqn)."""

    _learner_cls = DQNLearner
    # trains from plain (obs, a, r, obs', done) transitions: external-env
    # policy servers can feed it (ray parity: PolicyServerInput examples)
    _supports_external_env = True

    def setup(self, config):
        super().setup(config)
        cfg = self._algo_config
        if getattr(cfg, "prioritized_replay", False):
            self.buffer = PrioritizedReplayBuffer(
                cfg.replay_buffer_capacity,
                alpha=getattr(cfg, "prioritized_replay_alpha", 0.6),
                beta=getattr(cfg, "prioritized_replay_beta", 0.4),
                seed=cfg.seed,
            )
        else:
            self.buffer = ReplayBuffer(cfg.replay_buffer_capacity,
                                       seed=cfg.seed)
        self._since_target_sync = 0

    def training_step(self) -> Dict:
        cfg = self.config
        n_step = int(getattr(cfg, "n_step", 1))
        self._sync_weights()
        for frag in self._sample_all():
            self._timesteps += frag.count
            self.buffer.add(n_step_transform(frag, n_step, cfg.gamma))
        if len(self.buffer) < cfg.num_steps_sampled_before_learning:
            return {"buffer_size": len(self.buffer)}
        metrics = {}
        for _ in range(cfg.num_epochs):
            batch = self.buffer.sample(cfg.minibatch_size)
            metrics = self.learner.update(batch)
            # last_td_abs is set by DQNLearner only; under LearnerGroup
            # there is no such attribute (multi-learner DQN is rejected at
            # setup since DQNLearner has no DDP step), so a learner that
            # doesn't expose it leaves priorities unrefreshed rather than
            # crashing.
            td_abs = getattr(self.learner, "last_td_abs", None)
            if (td_abs is not None and "batch_indexes" in batch
                    and hasattr(self.buffer, "update_priorities")):
                # truncate defensively: a learner returning fewer TDs than
                # the batch must not misalign index->priority pairs
                self.buffer.update_priorities(
                    batch["batch_indexes"][:len(td_abs)], td_abs
                )
            self._since_target_sync += 1
            if self._since_target_sync >= max(
                1, cfg.target_network_update_freq // cfg.minibatch_size
            ):
                self.learner.sync_target()
                self._since_target_sync = 0
        metrics["buffer_size"] = len(self.buffer)
        return metrics


class SAC(Algorithm):
    """Discrete soft actor-critic — off-policy like DQN, but the learner
    carries twin Q towers + auto temperature (ray parity:
    rllib/algorithms/sac, discrete variant)."""

    _learner_cls = SACLearner
    _supports_external_env = True  # plain-transition off-policy, like DQN

    def setup(self, config):
        super().setup(config)
        self.buffer = ReplayBuffer(self._algo_config.replay_buffer_capacity,
                                   seed=self._algo_config.seed)

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        for frag in self._sample_all():
            self._timesteps += frag.count
            self.buffer.add(frag)
        if len(self.buffer) < cfg.num_steps_sampled_before_learning:
            return {"buffer_size": len(self.buffer)}
        metrics = {}
        for _ in range(cfg.num_epochs):
            batch = self.buffer.sample(cfg.minibatch_size)
            metrics = self.learner.update(batch)
        metrics["buffer_size"] = len(self.buffer)
        return metrics


class TD3(Algorithm):
    """Twin-delayed DDPG for continuous action spaces (ray parity:
    rllib/algorithms/td3; with DDPGConfig's knobs, rllib/algorithms/ddpg).
    Off-policy: continuous runners fill a replay buffer; the learner does
    clipped double-Q critic steps with delayed actor/target updates."""

    _learner_cls = TD3Learner

    def setup(self, _config):
        from ray_tpu_torch.rllib.env import env_action_info, env_obs_shape
        from ray_tpu_torch.rllib.env_runner import ContinuousEnvRunner
        from ray_tpu_torch.rllib.rl_module import ContinuousRLModule

        cfg = self._algo_config
        if getattr(cfg, "num_learners", 0) >= 1:
            # this setup builds its own single in-driver learner; silently
            # ignoring the option would fake a multi-learner run
            raise ValueError(
                "num_learners>=1 is not supported for TD3/DDPG "
                "(twin-optimizer learner has no DDP split); use "
                "num_learners=0"
            )
        probe = make_env(cfg.env, cfg.env_config)
        try:
            obs_shape = env_obs_shape(probe)
            action_info = env_action_info(probe)
            if action_info["kind"] != "continuous":
                raise ValueError(
                    f"TD3/DDPG need a continuous action space; {cfg.env!r} "
                    f"is {action_info['kind']}"
                )
        finally:
            if hasattr(probe, "close"):
                probe.close()
        hiddens = tuple(cfg.model.get("hiddens", (64, 64)))
        self.module = ContinuousRLModule(
            obs_shape, action_info, hiddens=hiddens, seed=cfg.seed,
            device=learner_device(getattr(cfg, "num_gpus_per_learner", 1)),
        )
        self.learner = self._learner_cls(self.module, cfg)
        runner_cls = ray_tpu_torch.remote(
            num_cpus=0.5,
            max_restarts=2,
            max_task_retries=2,
            runtime_env=RUNNER_RUNTIME_ENV,
        )(ContinuousEnvRunner)
        # a REPLACEMENT runner mid-training must not redo its uniform-
        # random warmup: it gets the current (trained) weights pushed and
        # should explore around them immediately
        self._runner_factory = lambda i, replacement=False: runner_cls.remote(
            cfg.env, cfg.env_config, {"hiddens": hiddens},
            seed=cfg.seed + i,
            noise_scale=getattr(cfg, "exploration_noise", 0.1),
            warmup_steps=0 if replacement else getattr(cfg, "warmup_steps", 500),
        )
        self.runners = [
            self._runner_factory(i) for i in range(cfg.num_env_runners)
        ]
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._timesteps = 0

    def training_step(self) -> Dict:
        cfg = self.config
        self._sync_weights()
        for frag in self._sample_all():
            self._timesteps += frag.count
            self.buffer.add(frag)
        if len(self.buffer) < cfg.num_steps_sampled_before_learning:
            return {"buffer_size": len(self.buffer)}
        metrics = {}
        for _ in range(cfg.num_epochs):
            metrics = self.learner.update(
                self.buffer.sample(cfg.minibatch_size)
            )
        metrics["buffer_size"] = len(self.buffer)
        return metrics

    def compute_single_action(self, obs, explore: bool = False):
        obs = np.asarray(obs, np.float32)[None, :]
        if explore:
            return self.module.action_exploration(
                obs, _clock_generator(self.module.device))[0]
        return self.module.action_greedy(obs)[0]


class DDPG(TD3):
    """DDPG = TD3 minus twin critics, target smoothing, and policy delay
    (the DDPGConfig defaults flip those knobs)."""


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PG)
        self.lr = 1e-2
        self.num_epochs = 1


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(A2C)
        self.lr = 1e-2
        self.entropy_coeff = 0.01


class APPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(APPO)
        self.entropy_coeff = 0.01


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(IMPALA)
        self.lr = 1e-3
        self.entropy_coeff = 0.01


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(DQN)
        self.lr = 1e-3
        # rainbow-family knobs (ray parity: rllib/algorithms/dqn/dqn.py
        # DQNConfig — double_q/dueling/n_step/prioritized replay)
        self.double_q = True
        self.dueling = True
        self.n_step = 1
        self.prioritized_replay = True
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(SAC)
        self.lr = 3e-4
        self.tau = 0.01
        self.target_entropy = None  # default: 0.6 * log(num_actions)


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(TD3)
        self.env = "Reacher1D-native"
        self.lr = 1e-3
        self.tau = 0.005
        self.twin_q = True
        self.policy_delay = 2
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.exploration_noise = 0.1
        self.warmup_steps = 500
        self.num_steps_sampled_before_learning = 500
        self.num_epochs = 20
        self.minibatch_size = 128


class DDPGConfig(TD3Config):
    def __init__(self):
        super().__init__()
        self.algo_class = DDPG
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
