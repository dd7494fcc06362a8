"""TuneController — the experiment event loop (ray parity:
python/ray/tune/execution/tune_controller.py:50).

Each trial runs as one actor (`_TrialActor` wrapping a Trainable). The
controller is a single-threaded loop: ask the searcher for new trials,
launch actors up to the concurrency cap, `wait()` on in-flight futures,
feed results to scheduler/searcher/stoppers/callbacks, checkpoint trials,
restart failed ones (FailureConfig.max_failures), and drive PBT exploits.
"""

from __future__ import annotations

import logging
import os
import time
import traceback
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.stopper import TimeoutStopper, resolve_stopper
from ray_tpu_torch.tune.trainable import (
    RESULT_DONE,
    Trainable,
    is_function_trainable,
    wrap_function,
)

logger = logging.getLogger(__name__)


class _TrialActor:
    """The per-trial actor: hosts one Trainable instance."""

    def __init__(self, trainable_cls, config, trial_info):
        # keyword: subclasses (e.g. rllib Algorithm) put extra positional
        # params between config and trial_info, mirroring the reference
        self._t: Trainable = trainable_cls(config, trial_info=trial_info)

    def train(self):
        return self._t.train()

    def save(self):
        return self._t.save()

    def restore(self, payload):
        self._t.restore(payload)
        return True

    def reset(self, new_config, trial_info=None):
        return self._t.reset(new_config, trial_info)

    def stop(self):
        self._t.stop()
        return True


class TuneController:
    def __init__(
        self,
        trainable,
        param_space: Optional[Dict] = None,
        *,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        num_samples: int = 1,
        search_alg: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        max_concurrent_trials: int = 0,
        time_budget_s: Optional[float] = None,
        run_config: Optional[RunConfig] = None,
        trial_resources: Optional[Dict[str, float]] = None,
        nested_resources: Optional[Dict[str, float]] = None,
        reuse_actors: bool = False,
        callbacks: Optional[list] = None,
        experiment_dir: Optional[str] = None,
    ):
        self._experiment_dir_override = experiment_dir
        if mode and mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self._name = getattr(trainable, "__name__", "trainable")
        if is_function_trainable(trainable):
            self._trainable_cls = wrap_function(trainable)
        else:
            self._trainable_cls = trainable
        self._param_space = param_space or {}
        self._metric = metric
        self._mode = mode or "max"
        self._num_samples = num_samples
        self._searcher = search_alg or BasicVariantGenerator()
        self._scheduler = scheduler or FIFOScheduler()
        self._searcher.set_search_properties(metric, self._mode, self._param_space)
        self._scheduler.set_search_properties(metric, self._mode)
        # Unwrap meta-searchers: a BasicVariantGenerator at the core means
        # grid expansion decides the trial count, not num_samples alone.
        core = self._searcher
        while hasattr(core, "searcher"):
            core = core.searcher
        if isinstance(core, BasicVariantGenerator):
            core.set_space(self._param_space, num_samples)
            self._expected = core.total_samples
        else:
            self._expected = num_samples
        self._run_config = run_config or RunConfig()
        self._stopper = resolve_stopper(self._run_config.stop)
        if time_budget_s:
            budget = TimeoutStopper(time_budget_s)
            from ray_tpu_torch.tune.stopper import CombinedStopper

            self._stopper = (
                CombinedStopper(self._stopper, budget) if self._stopper else budget
            )
        self._resources = dict(trial_resources or {"CPU": 1.0})
        # Resources claimed by actors the trial spawns internally (train
        # workers under a trainer-built trainable). The trial actor itself
        # must NOT claim these — they are only used to cap concurrency.
        self._nested_resources = dict(nested_resources or {})
        self._reuse_actors = reuse_actors
        self._callbacks = list(callbacks or [])
        self._max_concurrent = max_concurrent_trials or self._default_concurrency()
        self._ckpt_freq = self._run_config.checkpoint_config.checkpoint_frequency
        self._ckpt_at_end = self._run_config.checkpoint_config.checkpoint_at_end

        self._experiment_dir = self._make_experiment_dir()
        self.trials: List[Trial] = []
        self._actors: Dict[str, object] = {}  # trial_id -> handle
        self._live: Dict[object, tuple] = {}  # future -> (trial, kind)
        self._reusable_actors: List[object] = []
        self._searcher_done = False
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._state_interval_s = GLOBAL_CONFIG.tune_experiment_snapshot_period_s
        self._last_state_save = 0.0

    # ------------------------------------------------------------------
    # experiment state snapshot/resume (ray parity:
    # tune/execution/experiment_state.py _ExperimentCheckpointManager)
    # ------------------------------------------------------------------
    STATE_FILE = "experiment_state.pkl"

    def save_experiment_state(self):
        """Atomic snapshot of everything needed to resume: trials (incl.
        checkpoint payloads), searcher + scheduler internals, and progress
        counters. Actor handles live only in self._actors and are not
        persisted."""
        import pickle

        import dataclasses

        try:
            run_config = dataclasses.replace(self._run_config, callbacks=None)
        except Exception:  # noqa: BLE001
            run_config = None
        state = {
            "trials": self.trials,
            "searcher": self._searcher,
            "scheduler": self._scheduler,
            "searcher_done": self._searcher_done,
            "expected": self._expected,
            "name": self._name,
            "metric": self._metric,
            "mode": self._mode,
            "num_samples": self._num_samples,
            "param_space": self._param_space,
            "run_config": run_config,
        }
        path = os.path.join(self._experiment_dir, self.STATE_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(state, f, protocol=5)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 — snapshot is best-effort
            logger.warning("experiment state snapshot failed: %s", e)
        self._last_state_save = time.monotonic()

    def restore_experiment_state(self, state: dict, *,
                                 resume_errored: bool = False,
                                 restart_errored: bool = False):
        """Adopt a snapshot: in-flight trials restart from their latest
        checkpoint (RUNNING maps to PENDING; the actor is gone)."""
        self.trials = list(state["trials"])
        self._searcher = state["searcher"]
        self._scheduler = state["scheduler"]
        self._searcher_done = state["searcher_done"]
        self._expected = state["expected"]
        for t in self.trials:
            if t.status in (Trial.RUNNING,):
                t.status = Trial.PENDING
            elif t.status == Trial.ERROR:
                if restart_errored:
                    t.status = Trial.PENDING
                    t.checkpoint = None
                    t.num_failures = 0
                elif resume_errored:
                    t.status = Trial.PENDING
                    t.num_failures = 0
            t.restore_pending = False
            t.experiment_dir = self._experiment_dir

    # ------------------------------------------------------------------
    def _default_concurrency(self) -> int:
        try:
            cluster = ray_tpu_torch.cluster_resources()
            bounds = []
            for key in set(self._resources) | set(self._nested_resources):
                per_trial = self._resources.get(key, 0.0) + self._nested_resources.get(
                    key, 0.0
                )
                if per_trial > 0:
                    bounds.append(int(cluster.get(key, 0) / per_trial))
            if not bounds:
                bounds.append(int(cluster.get("CPU", 0) / 0.5))
            return max(1, min(bounds))
        except Exception:
            return max(os.cpu_count() or 4, 1)

    def _make_experiment_dir(self) -> str:
        if self._experiment_dir_override:
            os.makedirs(self._experiment_dir_override, exist_ok=True)
            return self._experiment_dir_override
        base = self._run_config.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results"
        )
        name = self._run_config.name or f"{self._name}_{int(time.time())}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    @property
    def experiment_dir(self) -> str:
        return self._experiment_dir

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    # ------------------------------------------------------------------
    def _create_trials(self):
        """Pull new configs from the searcher until it's exhausted/paced."""
        while not self._searcher_done and len(self.trials) < self._expected:
            trial_id = f"{len(self.trials):05d}"
            config = self._searcher.suggest(trial_id)
            if config == Searcher.FINISHED:
                self._searcher_done = True
                break
            if config is None:
                break
            config = dict(config)
            resolved = config.pop("__resolved_vars__", "")
            trial = Trial(
                self._name,
                config=config,
                trial_id=trial_id,
                experiment_dir=self._experiment_dir,
                resources=self._resources,
                evaluated_params=resolved,
                max_failures=self._run_config.failure_config.max_failures,
            )
            self.trials.append(trial)
            self._scheduler.on_trial_add(self, trial)
            for cb in self._callbacks:
                cb.on_trial_add(trial)

    def _actor_options(self, trial: Optional[Trial] = None) -> dict:
        res = dict(trial.resources) if trial is not None and trial.resources \
            else dict(self._resources)
        opts = {"num_cpus": res.pop("CPU", 1.0), "max_restarts": 0}
        if res:
            opts["resources"] = res
        return opts

    def _is_base_footprint(self, trial: Trial) -> bool:
        """Pool-eligibility invariant: only actors at the experiment's
        base resource request may enter/leave the reuse pool."""
        return dict(trial.resources or {}) == dict(self._resources)

    def _start_trial(self, trial: Trial):
        trial_info = {
            "trial_id": trial.trial_id,
            "trial_name": f"{trial.trainable_name}_{trial.trial_id}",
            "experiment_dir": self._experiment_dir,
            "resources": dict(trial.resources),
        }
        handle = None
        # actor reuse only at the experiment's base resource footprint: a
        # resource-changed trial needs a FRESH actor with its own options
        if (self._reuse_actors and self._reusable_actors
                and self._is_base_footprint(trial)):
            cand = self._reusable_actors.pop()
            try:
                ok = ray_tpu_torch.get(cand.reset.remote(trial.config, trial_info))
            except Exception:
                ok = False
            if ok:
                handle = cand
            else:
                self._kill_actor_handle(cand)
        if handle is None:
            actor_cls = ray_tpu_torch.remote(
                **self._actor_options(trial)
            )(_TrialActor)
            handle = actor_cls.remote(
                self._trainable_cls, trial.config, trial_info
            )
        self._actors[trial.trial_id] = handle
        trial.status = Trial.RUNNING
        trial.generation += 1
        if trial.checkpoint is not None:
            trial.restore_pending = True
            ref = handle.restore.remote(trial.checkpoint)
            self._live[ref] = (trial, "restore")
        else:
            self._issue_train(trial)
        for cb in self._callbacks:
            cb.on_trial_start(trial)

    def _issue_train(self, trial: Trial):
        handle = self._actors[trial.trial_id]
        ref = handle.train.remote()
        self._live[ref] = (trial, "train")

    def _issue_save(self, trial: Trial):
        handle = self._actors[trial.trial_id]
        ref = handle.save.remote()
        self._live[ref] = (trial, "save")

    def _kill_actor_handle(self, handle):
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def _teardown_trial_actor(self, trial: Trial, graceful: bool = True):
        handle = self._actors.pop(trial.trial_id, None)
        # Void in-flight futures of this trial.
        for ref, (t, _) in list(self._live.items()):
            if t.trial_id == trial.trial_id:
                del self._live[ref]
        if handle is None:
            return
        if (graceful and self._reuse_actors
                and self._is_base_footprint(trial)):
            # only base-footprint actors enter the reuse pool — a
            # resource-upsized actor would silently hold its larger
            # reservation under the next trial
            try:
                ray_tpu_torch.get(handle.stop.remote(), timeout=5.0)
                self._reusable_actors.append(handle)
                return
            except Exception:
                pass
        if graceful:
            try:
                handle.stop.remote()
            except Exception:
                pass
        self._kill_actor_handle(handle)

    # ------------------------------------------------------------------
    def _complete_trial(self, trial: Trial, result: Optional[Dict], error: bool = False):
        if self._ckpt_at_end and not error and trial.trial_id in self._actors:
            try:
                payload = ray_tpu_torch.get(self._actors[trial.trial_id].save.remote())
                trial.checkpoint = payload
            except Exception:
                pass
        trial.status = Trial.ERROR if error else Trial.TERMINATED
        self._teardown_trial_actor(trial)
        self._searcher.on_trial_complete(
            trial.trial_id, result=result, error=error
        )
        self._scheduler.on_trial_complete(self, trial, result or {})
        for cb in self._callbacks:
            if error:
                cb.on_trial_error(trial)
            else:
                cb.on_trial_complete(trial)

    def _handle_failure(self, trial: Trial, err: Exception):
        trial.num_failures += 1
        trial.error_msg = f"{type(err).__name__}: {err}"
        logger.warning(
            "trial %s failed (%d/%d): %s",
            trial.trial_id,
            trial.num_failures,
            trial.max_failures,
            trial.error_msg,
        )
        self._teardown_trial_actor(trial, graceful=False)
        if trial.max_failures < 0 or trial.num_failures <= trial.max_failures:
            # Retry from the latest checkpoint.
            trial.status = Trial.PENDING
        else:
            self._complete_trial(trial, None, error=True)

    def _process_result(self, trial: Trial, result: Dict):
        trial.last_result = result
        trial.metric_history.append(result)
        for cb in self._callbacks:
            cb.on_trial_result(trial, result)
        self._searcher.on_trial_result(trial.trial_id, result)
        if result.get(RESULT_DONE):
            self._complete_trial(trial, trial.last_result)
            return
        stop_trial = self._stopper(trial.trial_id, result) if self._stopper else False
        if stop_trial:
            self._complete_trial(trial, result)
            return
        generation = trial.generation
        decision = self._scheduler.on_trial_result(self, trial, result)
        if trial.trial_id not in self._actors or trial.generation != generation:
            # Scheduler stopped or restarted/exploited the trial out from
            # under us — the restarted actor already has its own futures.
            return
        if decision == TrialScheduler.STOP:
            self._complete_trial(trial, result)
        elif decision == TrialScheduler.PAUSE:
            self._issue_save(trial)
            trial.status = Trial.PAUSED
        else:
            it = result.get("training_iteration", 0)
            if self._ckpt_freq and it and it % self._ckpt_freq == 0:
                self._issue_save(trial)
            self._issue_train(trial)

    def _process_ready(self, ref):
        trial, kind = self._live.pop(ref)
        try:
            value = ray_tpu_torch.get(ref)
        except Exception as e:  # noqa: BLE001 — trial fault boundary
            if kind == "save" and trial.status != Trial.PAUSED:
                # Periodic checkpoint failed; training continues without it.
                logger.warning("checkpoint save failed for %s: %s", trial.trial_id, e)
                return
            # A failed pause-save (or train/restore) means the actor is gone
            # or broken — route through failure handling so the trial doesn't
            # wedge in PAUSED with no live futures.
            self._handle_failure(trial, e)
            return
        if kind == "train":
            self._process_result(trial, value)
        elif kind == "save":
            trial.checkpoint = value
            trial.checkpoint_iter = value.get("iteration", 0)
            if trial.status == Trial.PAUSED:
                self._teardown_trial_actor(trial)
        elif kind == "restore":
            trial.restore_pending = False
            self._issue_train(trial)

    # ------------------------------------------------------------------
    def stop_trial(self, trial: Trial, result: Optional[Dict] = None):
        """Scheduler-facing termination (ray parity:
        TuneController.stop_trial): used by synchronous schedulers to stop
        trials OTHER than the one whose result is being processed (e.g.
        HyperBand eliminating a cohort's losers)."""
        if trial.status in (Trial.TERMINATED, Trial.ERROR):
            return
        self._complete_trial(trial, result or trial.last_result or {})

    # ------------------------------------------------------------------
    def exploit_trial(self, trial: Trial, donor: Trial, new_config: Dict):
        """PBT: adopt donor's checkpoint + mutated config, restart trial."""
        donor_handle = self._actors.get(donor.trial_id)
        if donor_handle is None:
            return
        try:
            payload = ray_tpu_torch.get(donor_handle.save.remote(), timeout=60.0)
        except Exception as e:  # noqa: BLE001
            logger.warning("exploit: donor save failed: %s", e)
            return
        donor.checkpoint = payload
        self._teardown_trial_actor(trial, graceful=False)
        trial.config = dict(new_config)
        trial.checkpoint = payload
        trial.evaluated_params = f"exploited_from={donor.trial_id}"
        self._start_trial(trial)

    def change_trial_resources(self, trial: Trial,
                               resources: Dict[str, float]) -> bool:
        """Checkpoint, tear down, and restart ``trial`` with a new
        resource allocation (ray parity: the controller support behind
        ResourceChangingScheduler). Returns False if the trial has no
        live actor to checkpoint."""
        handle = self._actors.get(trial.trial_id)
        if handle is None or trial.status != Trial.RUNNING:
            return False
        try:
            payload = ray_tpu_torch.get(handle.save.remote(), timeout=60.0)
        except Exception as e:  # noqa: BLE001
            logger.warning("resource change: save failed: %s", e)
            return False
        self._teardown_trial_actor(trial, graceful=False)
        trial.checkpoint = payload
        trial.resources = dict(resources)
        self._start_trial(trial)
        return True

    # ------------------------------------------------------------------
    def _startable(self) -> List[Trial]:
        running = len(self._actors)
        slots = self._max_concurrent - running
        out = []
        # PENDING trials first; a PAUSED trial only resumes into a slot no
        # pending trial wants, so PAUSE actually yields the actor (reference:
        # scheduler choose_trial_to_run prefers fresh trials over paused).
        may_resume = getattr(self._scheduler, "may_resume", None)
        for status in (Trial.PENDING, Trial.PAUSED):
            for t in self.trials:
                if slots <= 0:
                    return out
                if t.status == status and t.trial_id not in self._actors:
                    if (status == Trial.PAUSED and may_resume is not None
                            and not may_resume(t)):
                        # synchronous scheduler is holding this trial for
                        # its cohort — the slot goes to someone else
                        continue
                    out.append(t)
                    slots -= 1
        return out

    def step(self):
        self._create_trials()
        for trial in self._startable():
            try:
                self._start_trial(trial)
            except Exception as e:  # noqa: BLE001
                self._handle_failure(trial, e)
        if not self._live:
            time.sleep(0.01)
            return
        ready, _ = ray_tpu_torch.wait(
            list(self._live.keys()), num_returns=1, timeout=1.0
        )
        for ref in ready:
            if ref in self._live:
                self._process_ready(ref)
        if time.monotonic() - self._last_state_save > self._state_interval_s:
            self.save_experiment_state()

    def is_finished(self) -> bool:
        if self._stopper and self._stopper.stop_all():
            return True
        no_more_new = self._searcher_done or len(self.trials) >= self._expected
        return (
            no_more_new
            and all(t.is_finished() for t in self.trials)
            and not self._live
        )

    def run(self) -> List[Trial]:
        for cb in self._callbacks:
            cb.on_experiment_start(self)
        try:
            while not self.is_finished():
                self.step()
            if self._stopper and self._stopper.stop_all():
                for t in self.trials:
                    if not t.is_finished():
                        self._complete_trial(t, t.last_result or None)
        finally:
            self.save_experiment_state()
            self.cleanup()
            for cb in self._callbacks:
                cb.on_experiment_end(self)
        return self.trials

    def cleanup(self):
        for trial in list(self.trials):
            if trial.trial_id in self._actors:
                self._teardown_trial_actor(trial, graceful=False)
        for handle in self._reusable_actors:
            self._kill_actor_handle(handle)
        self._reusable_actors.clear()
