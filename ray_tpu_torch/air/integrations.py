"""AIR experiment-tracking integrations: MLflow and Weights & Biases.

Reference parity: ray python/ray/air/integrations/mlflow.py
(MLflowLoggerCallback / setup_mlflow) and wandb.py (WandbLoggerCallback /
setup_wandb). Each callback mirrors Tune trial lifecycle into the
tracking backend: one run per trial, metrics on every report, params at
start, terminal status at completion. Imports are lazy and validated at
CONSTRUCTION so a missing client library fails loudly up front instead
of silently dropping experiment history mid-run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.logger import Callback, _flatten


def _numeric_only(result: Dict) -> Dict[str, float]:
    out = {}
    for k, v in _flatten(result).items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[k] = float(v)
    return out


class MLflowLoggerCallback(Callback):
    """Logs each trial as an MLflow run (ray parity:
    air/integrations/mlflow.py MLflowLoggerCallback)."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: str = "ray_tpu_torch",
                 tags: Optional[Dict[str, Any]] = None,
                 save_artifact: bool = False):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MLflowLoggerCallback requires the `mlflow` package"
            ) from e
        self._tracking_uri = tracking_uri
        self._experiment_name = experiment_name
        self._tags = dict(tags or {})
        self._save_artifact = save_artifact
        self._runs: Dict[str, Any] = {}  # trial_id -> mlflow run_id
        self._client_obj = None

    def _client(self):
        # one client for the experiment (construction already validated
        # the import); rebuilding per report would reset the global
        # tracking URI on the controller hot path
        if self._client_obj is None:
            import mlflow

            if self._tracking_uri:
                mlflow.set_tracking_uri(self._tracking_uri)
            from mlflow.tracking import MlflowClient

            self._client_obj = MlflowClient(tracking_uri=self._tracking_uri)
        return self._client_obj

    def on_trial_start(self, trial):
        client = self._client()
        exp = client.get_experiment_by_name(self._experiment_name)
        exp_id = exp.experiment_id if exp else client.create_experiment(
            self._experiment_name
        )
        run = client.create_run(
            exp_id, tags={**self._tags, "trial_name": str(trial)},
        )
        self._runs[trial.trial_id] = run.info.run_id
        for k, v in _flatten(trial.config or {}).items():
            try:
                client.log_param(run.info.run_id, k, v)
            except Exception:
                pass  # non-stringable param: tracking is best-effort

    def on_trial_result(self, trial, result: Dict):
        run_id = self._runs.get(trial.trial_id)
        if run_id is None:
            return
        client = self._client()
        step = int(result.get("training_iteration", 0))
        for k, v in _numeric_only(result).items():
            client.log_metric(run_id, k, v, step=step)

    def _finish(self, trial, status: str):
        run_id = self._runs.pop(trial.trial_id, None)
        if run_id is None:
            return
        client = self._client()
        trial_dir = getattr(trial, "local_path", None) or getattr(
            trial, "local_dir", None
        )
        if self._save_artifact and trial_dir:
            try:
                client.log_artifacts(run_id, trial_dir)
            except Exception:
                pass
        client.set_terminated(run_id, status=status)

    def on_trial_complete(self, trial):
        self._finish(trial, "FINISHED")

    def on_trial_error(self, trial):
        self._finish(trial, "FAILED")


class WandbLoggerCallback(Callback):
    """Logs each trial as a W&B run (ray parity:
    air/integrations/wandb.py WandbLoggerCallback)."""

    def __init__(self, project: str = "ray_tpu_torch",
                 group: Optional[str] = None, **init_kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbLoggerCallback requires the `wandb` package"
            ) from e
        self._project = project
        self._group = group
        self._init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def on_trial_start(self, trial):
        import wandb

        # reinit="create_new": independent concurrent Run objects, one
        # per live trial — plain reinit=True would FINISH the previous
        # trial's run while it is still reporting (Tune runs trials
        # concurrently; the reference isolates runs in subprocesses for
        # the same reason)
        self._runs[trial.trial_id] = wandb.init(
            project=self._project, group=self._group,
            name=str(trial), config=dict(trial.config or {}),
            reinit="create_new", **self._init_kwargs,
        )

    def on_trial_result(self, trial, result: Dict):
        run = self._runs.get(trial.trial_id)
        if run is not None:
            run.log(_numeric_only(result))

    def _finish(self, trial, exit_code: int):
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish(exit_code=exit_code)

    def on_trial_complete(self, trial):
        self._finish(trial, 0)

    def on_trial_error(self, trial):
        self._finish(trial, 1)
