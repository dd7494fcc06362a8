"""BackendExecutor: worker-gang lifecycle + training loop pump.

ray parity: python/ray/train/_internal/backend_executor.py:46 — create the
placement group (:165), start the WorkerGroup, wire ranks (:273), run the
backend's process-group setup, pump reports/checkpoints (:343-466), restart
on failure (:647). One worker per CUDA card, as in the reference; each
learns its rank, its local rank among the gang's workers on its node and its
node rank.

Elastic fault tolerance (the recovery loop ray's :647 restart sketch grew
into): the pump doubles as a gang supervisor — short-interval result polls
piggyback per-rank session health, so a dead rank surfaces as a prompt
actor-death error and a wedged-but-alive rank trips the per-step progress
watchdog in seconds instead of at collective-timeout. On a recoverable
failure the executor plants the collective abort marker (unwedging
survivors with CollectiveWorldChangedError), drains steptrace, tears the
gang down, re-requests placement, and restarts the user loop from the
latest reported checkpoint at the next gang generation — decrementing
``FailureConfig.max_failures``. A SIGTERM drain (spot preemption)
checkpoints at the next step boundary and requeues WITHOUT burning a
failure-budget slot. Every transition is measured:
``train_worker_failures_total{cause=}``, ``train_restarts_total``, and a
detection→ready ``train_recovery_seconds`` histogram, plus a restart span
in the merged train timeline.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import steptrace
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)

TRAIN_GROUP_NAME = "train_dp"


class TrainingFailedError(RuntimeError):
    pass


class FailureBudgetExhaustedError(TrainingFailedError):
    """A recoverable gang failure landed with no ``max_failures`` budget
    left. Terminal: the trainer's outer retry loop must not re-run it."""


class ProgressWatchdog:
    """Per-rank step-progress watchdog (pure; unit-testable).

    A rank ARMS at its first observed progress (first report or first
    health snapshot showing a completed step) — before that it may
    legitimately sit in trace/compile for minutes. Once armed, a rank
    whose progress timestamp goes stale by more than ``timeout_s`` is
    declared wedged. ``timeout_s <= 0`` disables the watchdog entirely.
    """

    def __init__(self, num_workers: int, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self._steps = [0] * num_workers
        self._last: List[Optional[float]] = [None] * num_workers

    def touch(self, rank: int, now: Optional[float] = None):
        """Direct progress evidence (a report arrived from this rank)."""
        self._last[rank] = time.monotonic() if now is None else now

    def observe(self, rank: int, step: int, now: Optional[float] = None):
        """Health-snapshot evidence: arms/refreshes only when the rank's
        completed-step count has advanced past what we last saw."""
        if step > self._steps[rank]:
            self._steps[rank] = step
            self._last[rank] = time.monotonic() if now is None else now

    def disarm(self, rank: int):
        self._last[rank] = None

    def wedged(self, now: Optional[float] = None) -> List[int]:
        if self.timeout_s <= 0:
            return []
        now = time.monotonic() if now is None else now
        return [
            r for r, last in enumerate(self._last)
            if last is not None and now - last > self.timeout_s
        ]


def _ft_metrics():
    """The executor's fault-tolerance metric families on the process
    registry (driver-side, so they ride the merged /metrics cluster
    scrape). Families are registered idempotently."""
    from ray_tpu_torch._private import metrics_core

    reg = metrics_core.registry()
    return (
        reg.counter("train_worker_failures_total",
                    "train gang failures by cause "
                    "(actor_died/wedged/unresponsive/drain)"),
        reg.counter("train_restarts_total",
                    "gang recovery restarts (teardown -> re-place -> "
                    "restore from checkpoint)"),
        reg.histogram("train_recovery_seconds",
                      "failure detection -> new generation training-ready",
                      scale=metrics_core.LATENCY),
    )


class _CheckpointBook:
    """Keep top-K checkpoints (ray parity: air/_internal/checkpoint_manager.py:251)."""

    def __init__(self, trial_dir: str, config: CheckpointConfig):
        self.trial_dir = trial_dir
        self.config = config
        self.saved: List[tuple] = []  # (score, index, path)
        self.index = 0

    def persist(self, data: Optional[dict], src_path: Optional[str],
                metrics: dict) -> Checkpoint:
        path = os.path.join(self.trial_dir, f"checkpoint_{self.index:06d}")
        self.index += 1
        ckpt = Checkpoint(_data=data) if data is not None else Checkpoint(path=src_path)
        ckpt.to_directory(path)
        final = Checkpoint(path=path)
        score = None
        attr = self.config.checkpoint_score_attribute
        if attr and attr in metrics:
            score = metrics[attr]
        self.saved.append((score, self.index - 1, path))
        self._evict()
        return final

    def _evict(self):
        keep = self.config.num_to_keep
        if keep is None or len(self.saved) <= keep:
            return
        attr = self.config.checkpoint_score_attribute
        if attr:
            reverse = self.config.checkpoint_score_order == "max"
            ranked = sorted(
                self.saved,
                key=lambda t: (t[0] is not None, t[0] if t[0] is not None else 0),
                reverse=reverse,
            )
        else:
            ranked = sorted(self.saved, key=lambda t: -t[1])  # newest first
        for score, idx, path in ranked[keep:]:
            import shutil

            shutil.rmtree(path, ignore_errors=True)
            self.saved.remove((score, idx, path))

    def latest(self) -> Optional[Checkpoint]:
        if not self.saved:
            return None
        path = max(self.saved, key=lambda t: t[1])[2]
        return Checkpoint(path=path)


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        run_config: Optional[RunConfig] = None,
        trial_dir: Optional[str] = None,
        trial_id: str = "train",
    ):
        self.backend_config = backend_config
        self.backend = backend_config.backend_cls()
        self.scaling = scaling_config
        self.run_config = run_config or RunConfig()
        self.trial_id = trial_id
        storage = self.run_config.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        name = self.run_config.name or f"train_{time.strftime('%Y%m%d-%H%M%S')}"
        self.trial_dir = trial_dir or os.path.join(storage, name, trial_id)
        os.makedirs(self.trial_dir, exist_ok=True)
        self.pg = None
        self.worker_group: Optional[WorkerGroup] = None
        self._ckpts = _CheckpointBook(self.trial_dir, self.run_config.checkpoint_config)
        self._runtime_env: Optional[dict] = None
        self._last_metrics = None

    # ------------------------------------------------------------------
    def start(self, runtime_env: Optional[dict] = None,
              checkpoint: Optional[Checkpoint] = None, generation: int = 0):
        from ray_tpu_torch.util.placement_group import placement_group

        self._runtime_env = runtime_env
        bundles = self.scaling.as_placement_group_bundles()
        strategy = self.scaling.placement_strategy
        self.pg = placement_group(bundles, strategy=strategy)
        if not self.pg.wait(120):
            raise TrainingFailedError(
                f"placement group infeasible: {bundles} ({strategy})"
            )
        self.worker_group = WorkerGroup(
            self.scaling.num_workers,
            self.scaling.worker_resources(),
            placement_group=self.pg,
            runtime_env=runtime_env,
            generation=generation,
        )
        # rank wiring (ray parity: backend_executor.py:273)
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            refs.append(
                w.setup_session.remote(
                    rank, self.scaling.num_workers,
                    self.worker_group.local_ranks[rank],
                    self.worker_group.node_ranks[rank],
                    self.run_config.name or "experiment", self.trial_id,
                    self.trial_dir, checkpoint,
                    self.worker_group.local_world_sizes[rank],
                )
            )
        ray_tpu_torch.get(refs, timeout=GLOBAL_CONFIG.train_worker_start_timeout_s)
        self.backend.on_start(self.worker_group, self.backend_config)

    # ------------------------------------------------------------------
    def run(self, train_fn: Callable, config: Optional[dict] = None,
            result_callback=None) -> Result:
        assert self.worker_group is not None, "start() must be called first"
        self._last_metrics = None
        budget = self.run_config.failure_config.max_failures
        failures, restarts, recovery_hist = _ft_metrics()
        while True:
            outcome = self._run_attempt(train_fn, config, result_callback)
            status = outcome["status"]
            if status == "done":
                return self._result(error=None)
            if status == "app_error":
                return self._result(error=outcome["error"])
            # recoverable gang failure (actor_died / unresponsive /
            # wedged) or a clean preemption drain
            cause = outcome["cause"]
            detected = outcome["detected"]
            failures.labels(cause=cause).inc()
            if not GLOBAL_CONFIG.train_recovery_enabled:
                return self._result(
                    error=outcome["error"]
                    or TrainingFailedError(f"gang failure: {cause}")
                )
            if cause != "drain":
                # drain (spot preemption with a clean checkpoint handoff)
                # is free; real failures spend the budget. max_failures<0
                # means unlimited, ray semantics.
                if budget == 0:
                    return self._result(error=FailureBudgetExhaustedError(
                        f"gang failure ({cause}) with no max_failures "
                        f"budget left: {outcome['error']}"
                    ))
                if budget > 0:
                    budget -= 1
            old_gen = self.worker_group.generation if self.worker_group else 0
            try:
                self._recover(old_gen)
            except Exception as e:
                return self._result(error=TrainingFailedError(
                    f"gang recovery after {cause} failed: {e}"
                ))
            ready = time.time()
            restarts.inc()
            recovery_hist.record(ready - detected)
            steptrace.record_restart(cause, detected, ready, old_gen + 1)
            logger.warning(
                "train gang recovered from %s in %.2fs (generation %d, "
                "restored from %s)", cause, ready - detected, old_gen + 1,
                "latest checkpoint" if self._ckpts.latest() else "scratch",
            )

    def _result(self, error) -> Result:
        return Result(
            metrics=self._last_metrics,
            checkpoint=self._ckpts.latest(),
            error=error,
            path=self.trial_dir,
        )

    def _run_attempt(self, train_fn: Callable, config: Optional[dict],
                     result_callback) -> dict:
        """One gang generation's pump. Returns a terminal outcome dict:
        ``{"status": "done"}``, ``{"status": "app_error", "error"}``, or
        ``{"status": "failed", "cause", "error", "detected"}`` where
        ``detected`` is the wall-clock failure-detection instant the
        recovery histogram measures from."""
        wg = self.worker_group
        try:
            self.backend.on_training_start(wg, self.backend_config)
            ray_tpu_torch.get(
                [w.start_training.remote(train_fn, dict(config or {}))
                 for w in wg.workers],
                timeout=GLOBAL_CONFIG.train_worker_start_timeout_s,
            )
        except Exception as e:
            # a rank that dies during gang setup is a gang failure, not a
            # user-code error: the recovery loop should re-place it
            if "died" in f"{type(e).__name__}: {e}".lower():
                return {"status": "failed", "cause": "actor_died",
                        "error": TrainingFailedError(
                            f"worker died during startup: {e}"),
                        "detected": time.time()}
            return {"status": "app_error",
                    "error": TrainingFailedError(f"worker startup failed: {e}")}
        n = len(wg.workers)
        done = [False] * n
        interval = max(0.1, GLOBAL_CONFIG.train_health_check_interval_s)
        watchdog = ProgressWatchdog(n, GLOBAL_CONFIG.train_progress_timeout_s)
        while not all(done):
            # Short-interval polls double as liveness probes: a dead rank
            # fails the in-flight call promptly (ActorDiedError), and an
            # empty poll returns within ``interval`` carrying the rank's
            # session health for the progress watchdog.
            polls = [
                (i, wg.workers[i].next_result.remote(interval))
                for i in range(n) if not done[i]
            ]
            try:
                results = ray_tpu_torch.get([r for _, r in polls],
                                      timeout=interval + 60.0)
            except Exception as e:
                cause = ("actor_died"
                         if "died" in f"{type(e).__name__}: {e}".lower()
                         else "unresponsive")
                return {"status": "failed", "cause": cause,
                        "error": TrainingFailedError(f"train worker died: {e}"),
                        "detected": time.time()}
            for (i, _), res in zip(polls, results):
                kind = res.get("type")
                if kind == "done":
                    done[i] = True
                    watchdog.disarm(i)
                elif kind == "error":
                    return {"status": "app_error",
                            "error": TrainingFailedError(
                                f"worker {i} failed: {res['error']}\n"
                                f"{res.get('traceback', '')}")}
                elif kind == "report":
                    watchdog.touch(i)
                    self._handle_report(i, res, result_callback)
                    if res.get("drain"):
                        # the rank checkpointed at this step boundary and
                        # is exiting for preemption: requeue the gang
                        return {"status": "failed", "cause": "drain",
                                "error": None, "detected": time.time()}
                elif kind == "timeout":
                    h = res.get("health") or {}
                    if h.get("active"):
                        watchdog.observe(i, int(h.get("step", 0)))
            wedged = watchdog.wedged()
            if wedged:
                return {"status": "failed", "cause": "wedged",
                        "error": TrainingFailedError(
                            f"rank(s) {wedged} made no step progress for "
                            f"{watchdog.timeout_s}s (progress watchdog)"),
                        "detected": time.time()}
        return {"status": "done"}

    def _handle_report(self, rank: int, res: dict, result_callback):
        """Rank-0 reports are canonical for metrics/checkpoints (ray
        semantics); a drain report from ANY rank persists its checkpoint —
        that checkpoint is exactly what recovery restores from."""
        if rank != 0 and not res.get("drain"):
            return
        metrics = res["metrics"]
        if rank == 0:
            self._last_metrics = metrics
        ck_data = res.get("checkpoint_data")
        ck_path = res.get("checkpoint_path")
        if ck_data is not None or ck_path is not None:
            self._ckpts.persist(ck_data, ck_path, metrics)
        if rank == 0 and result_callback:
            result_callback(metrics, self._ckpts.latest())

    # ------------------------------------------------------------------
    def _recover(self, old_generation: int):
        """Teardown + re-place + restore: the recovery half of the loop.

        Order matters: plant the collective abort marker FIRST so
        surviving ranks blocked in a rendezvous fail over with
        ``CollectiveWorldChangedError`` within a poll interval instead of
        sitting out collective_timeout_s while we tear down around them.
        """
        from ray_tpu_torch.util import collective as col

        try:
            col.abort_group(TRAIN_GROUP_NAME, epoch=old_generation)
        except Exception:
            pass
        self._teardown_gang()
        # the dead generation's rendezvous keys (and its abort marker —
        # every survivor that could see it is gone now) serve no one
        try:
            col.destroy_collective_group(TRAIN_GROUP_NAME)
        except Exception:
            pass
        self.start(
            runtime_env=self._runtime_env,
            checkpoint=self._ckpts.latest(),
            generation=old_generation + 1,
        )

    def _drain_steptrace(self):
        """Drain the gang's step-telemetry rings into the GCS aggregator
        while the workers still exist: the merged train timeline
        (`ray_tpu_torch train timeline`, util.state.train_timeline) must
        outlive the run — and on the recovery path, outlive the dead
        generation, so its wedged rank shows as missing instead of
        vanishing. Best-effort — an unreachable GCS or a disabled
        steptrace plane costs nothing here."""
        if self.worker_group and self.worker_group.workers:
            try:
                from ray_tpu_torch.util import state

                if steptrace.is_enabled():
                    # limit=1: the fold (ring drain) is the point — skip
                    # building + shipping the full merged timeline here
                    state.steptrace_summary(limit=1)
            except Exception:
                pass

    def _teardown_gang(self):
        """Shared by shutdown() and the recovery path: steptrace drain,
        then kill the workers and release the placement."""
        self._drain_steptrace()
        if self.worker_group:
            self.worker_group.shutdown()
            self.worker_group = None
        if self.pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None

    # ------------------------------------------------------------------
    def shutdown(self):
        try:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
        except Exception:
            pass
        self._teardown_gang()
