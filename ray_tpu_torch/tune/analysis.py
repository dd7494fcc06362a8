"""ExperimentAnalysis: offline analysis of a finished (or running)
experiment directory.

Reference parity: ray python/ray/tune/analysis/experiment_analysis.py —
load what Tune persisted to disk WITHOUT re-running anything: per-trial
``result.json`` (one JSON line per report, written by the default
JsonLoggerCallback) and ``params.json``, plus the experiment state
snapshot when present. Answers the standard post-hoc questions: best
trial/config/result for a metric, per-trial dataframes, a summary
dataframe."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional


class ExperimentAnalysis:
    def __init__(self, experiment_dir: str,
                 default_metric: Optional[str] = None,
                 default_mode: Optional[str] = None):
        self._dir = os.path.abspath(os.path.expanduser(experiment_dir))
        if not os.path.isdir(self._dir):
            raise FileNotFoundError(self._dir)
        self.default_metric = default_metric
        self.default_mode = default_mode
        self._results: Dict[str, List[dict]] = {}
        self._configs: Dict[str, dict] = {}
        for entry in sorted(os.listdir(self._dir)):
            tdir = os.path.join(self._dir, entry)
            rfile = os.path.join(tdir, "result.json")
            if not os.path.isfile(rfile):
                continue
            rows = []
            with open(rfile) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            rows.append(json.loads(line))
                        except json.JSONDecodeError:
                            continue  # torn tail line of a live run
            self._results[entry] = rows
            pfile = os.path.join(tdir, "params.json")
            if os.path.isfile(pfile):
                try:
                    with open(pfile) as f:
                        self._configs[entry] = json.load(f)
                except (OSError, json.JSONDecodeError):
                    self._configs[entry] = {}
        if not self._results:
            raise ValueError(
                f"no trial result.json files under {self._dir} — is this "
                "an experiment directory produced by Tuner.fit()?"
            )
        # experiment snapshot, when present, provides metric/mode defaults
        state_file = os.path.join(self._dir, "experiment_state.pkl")
        if os.path.isfile(state_file) and (
            self.default_metric is None or self.default_mode is None
        ):
            try:
                with open(state_file, "rb") as f:
                    state = pickle.load(f)
                self.default_metric = self.default_metric or state.get("metric")
                self.default_mode = self.default_mode or state.get("mode")
            except Exception:  # noqa: BLE001 — snapshot optional
                pass

    # -- accessors ------------------------------------------------------
    @property
    def experiment_dir(self) -> str:
        return self._dir

    @property
    def trials(self) -> List[str]:
        return list(self._results)

    def trial_results(self, trial: str) -> List[dict]:
        return list(self._results[trial])

    def get_all_configs(self) -> Dict[str, dict]:
        return dict(self._configs)

    def trial_dataframes(self):
        import pandas as pd

        return {t: pd.DataFrame(rows) for t, rows in self._results.items()}

    # -- best-of queries ------------------------------------------------
    def _metric_mode(self, metric, mode):
        metric = metric or self.default_metric
        mode = mode or self.default_mode or "max"
        if metric is None:
            raise ValueError("pass metric= (no default recorded)")
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        return metric, mode

    @staticmethod
    def _best_row(rows: List[dict], metric: str, mode: str):
        """The row with the best numeric ``metric`` (None if no row has
        one) — the single selection rule shared by every query."""
        with_metric = [
            r for r in rows if isinstance(r.get(metric), (int, float))
        ]
        if not with_metric:
            return None
        return (max if mode == "max" else min)(
            with_metric, key=lambda r: r[metric]
        )

    def _trial_score(self, rows: List[dict], metric: str, mode: str):
        row = self._best_row(rows, metric, mode)
        return None if row is None else row[metric]

    def best_trial(self, metric: Optional[str] = None,
                   mode: Optional[str] = None) -> str:
        metric, mode = self._metric_mode(metric, mode)
        scored = [
            (t, self._trial_score(rows, metric, mode))
            for t, rows in self._results.items()
        ]
        scored = [(t, s) for t, s in scored if s is not None]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda ts: ts[1]
        )[0]

    def best_config(self, metric: Optional[str] = None,
                    mode: Optional[str] = None) -> dict:
        return self._configs.get(self.best_trial(metric, mode), {})

    def best_result(self, metric: Optional[str] = None,
                    mode: Optional[str] = None) -> dict:
        metric, mode = self._metric_mode(metric, mode)
        rows = self._results[self.best_trial(metric, mode)]
        return self._best_row(rows, metric, mode)

    def dataframe(self, metric: Optional[str] = None,
                  mode: Optional[str] = None):
        """One row per trial: its best (or last, without a metric) result
        merged with ``config/...`` columns."""
        import pandas as pd

        rows = []
        for t, results in self._results.items():
            if not results:
                continue
            if metric or self.default_metric:
                m, md = self._metric_mode(metric, mode)
                row = self._best_row(results, m, md) or results[-1]
            else:
                row = results[-1]
            out = dict(row)
            out["trial"] = t
            for k, v in self._configs.get(t, {}).items():
                out[f"config/{k}"] = v
            rows.append(out)
        return pd.DataFrame(rows)
