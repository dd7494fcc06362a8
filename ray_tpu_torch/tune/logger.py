"""Callbacks + CSV/JSON loggers (ray parity: python/ray/tune/callback.py,
tune/logger/{csv,json,tensorboardx}.py).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, TextIO


class Callback:
    def on_experiment_start(self, controller):
        pass

    def on_experiment_end(self, controller):
        pass

    def on_trial_add(self, trial):
        pass

    def on_trial_start(self, trial):
        pass

    def on_trial_result(self, trial, result: Dict):
        pass

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass


def _flatten(d: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[key] = v
    return out


class _PerTrialFileCallback(Callback):
    def __init__(self):
        self._files: Dict[str, TextIO] = {}

    def _open(self, trial, filename) -> Optional[TextIO]:
        if trial.trial_id in self._files:
            return self._files[trial.trial_id]
        path = trial.local_path
        if not path:
            return None
        os.makedirs(path, exist_ok=True)
        f = open(os.path.join(path, filename), "a")
        self._files[trial.trial_id] = f
        return f

    def _close(self, trial):
        f = self._files.pop(trial.trial_id, None)
        if f:
            f.close()

    def on_trial_complete(self, trial):
        self._close(trial)

    def on_trial_error(self, trial):
        self._close(trial)

    def on_experiment_end(self, controller):
        for f in self._files.values():
            f.close()
        self._files.clear()


class JsonLoggerCallback(_PerTrialFileCallback):
    """result.json — one JSON line per result."""

    def on_trial_start(self, trial):
        path = trial.local_path
        if path:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "params.json"), "w") as f:
                json.dump(trial.config, f, default=str)

    def on_trial_result(self, trial, result):
        f = self._open(trial, "result.json")
        if f:
            json.dump(_flatten(result), f, default=str)
            f.write("\n")
            f.flush()


class CSVLoggerCallback(_PerTrialFileCallback):
    """progress.csv — header from the first result's keys."""

    def __init__(self):
        super().__init__()
        self._writers: Dict[str, csv.DictWriter] = {}

    def on_trial_result(self, trial, result):
        f = self._open(trial, "progress.csv")
        if not f:
            return
        flat = _flatten(result)
        if trial.trial_id not in self._writers:
            w = csv.DictWriter(f, fieldnames=list(flat.keys()), extrasaction="ignore")
            w.writeheader()
            self._writers[trial.trial_id] = w
        self._writers[trial.trial_id].writerow(flat)
        f.flush()


class TBXLoggerCallback(Callback):
    """TensorBoard event files per trial (ray parity:
    tune/logger/tensorboardx.py TBXLoggerCallback — same event-file
    layout: one writer per trial directory, numeric leaves of the result
    dict become scalars keyed by their flattened path). Uses
    torch.utils.tensorboard where tensorboard is installed; constructing
    the callback without it raises ImportError up front."""

    def __init__(self):
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401

        self._writers: Dict[str, "SummaryWriter"] = {}

    def _writer(self, trial):
        w = self._writers.get(trial.trial_id)
        if w is None and trial.local_path:
            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(trial.local_path, exist_ok=True)
            w = SummaryWriter(log_dir=trial.local_path)
            self._writers[trial.trial_id] = w
        return w

    def on_trial_result(self, trial, result: Dict):
        w = self._writer(trial)
        if w is None:
            return
        step = result.get("training_iteration") or result.get(
            "timesteps_total"
        ) or 0
        for key, v in _flatten(result).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            w.add_scalar(key, v, global_step=int(step))
        w.flush()

    def _close(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()

    def on_trial_complete(self, trial):
        self._close(trial)

    def on_trial_error(self, trial):
        self._close(trial)

    def on_experiment_end(self, controller):
        for w in self._writers.values():
            w.close()
        self._writers.clear()


def _default_callbacks():
    """CSV + JSON always; TensorBoard when available (ray parity:
    DEFAULT_LOGGERS includes TBX when the dependency is present).
    Availability is probed with find_spec, NOT an import: this module is
    (un)pickled into every worker, and importing torch+tensorboard there
    costs tens of seconds on small hosts — enough to time out actor
    creation. The real import happens lazily in the driver when the
    first writer is built."""
    import importlib.util

    cbs = [CSVLoggerCallback, JsonLoggerCallback]
    try:
        # top-level names only: find_spec on a dotted path IMPORTS the
        # parent packages, which would pull torch into every worker
        if importlib.util.find_spec("torch") is not None and \
                importlib.util.find_spec("tensorboard") is not None:
            cbs.append(TBXLoggerCallback)
    except (ImportError, ModuleNotFoundError, ValueError):
        pass
    return tuple(cbs)


DEFAULT_CALLBACKS = _default_callbacks()
