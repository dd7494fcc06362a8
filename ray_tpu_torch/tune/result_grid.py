"""ResultGrid (ray parity: python/ray/tune/result_grid.py:17)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.trainable import FN_CHECKPOINT_KEY


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: Optional[str] = None, experiment_dir: Optional[str] = None):
        self._trials = trials
        self._metric = metric
        self._mode = mode or "max"
        self.experiment_path = experiment_dir
        self._results = [self._trial_to_result(t) for t in trials]

    @staticmethod
    def _trial_to_result(trial: Trial) -> Result:
        ckpt = None
        if trial.checkpoint is not None:
            state = trial.checkpoint.get("state")
            if isinstance(state, dict) and FN_CHECKPOINT_KEY in state:
                # Function-trainable wrapper: unwrap what tune.report shipped;
                # a trial that never reported a checkpoint yields None, not a
                # truthy-but-empty Checkpoint.
                data = state[FN_CHECKPOINT_KEY]
                ckpt = Checkpoint.from_dict(data) if data is not None else None
            elif isinstance(state, dict) and state:
                # Class trainable: hand back exactly what save_checkpoint
                # returned (same shape load_checkpoint receives).
                ckpt = Checkpoint.from_dict(state)
        err = RuntimeError(trial.error_msg) if trial.error_msg else None
        return Result(
            metrics=trial.last_result or None,
            checkpoint=ckpt,
            error=err,
            path=trial.local_path,
        )

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials if t.status == Trial.TERMINATED)

    def get_best_result(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        scope: str = "last",
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if not metric:
            raise ValueError("get_best_result requires a metric")
        sign = 1.0 if mode == "max" else -1.0

        def score(trial: Trial):
            if scope == "last":
                vals = [trial.last_result] if trial.last_result else []
            else:
                vals = trial.metric_history
            best = None
            for r in vals:
                if metric in r:
                    v = sign * float(r[metric])
                    best = v if best is None else max(best, v)
            return best

        scored = [
            (s, i)
            for i, t in enumerate(self._trials)
            if (s := score(t)) is not None
        ]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        _, idx = max(scored)
        return self._results[idx]

    def get_dataframe(self):
        try:
            import pandas as pd
        except ImportError as e:  # pragma: no cover
            raise ImportError("pandas is required for get_dataframe()") from e
        rows = []
        for t in self._trials:
            row = dict(t.last_result or {})
            row["trial_id"] = t.trial_id
            row["status"] = t.status
            rows.append(row)
        return pd.DataFrame(rows)
