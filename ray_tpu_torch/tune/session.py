"""Per-trial session for function trainables — backs ``tune.report`` /
``tune.get_checkpoint`` (ray parity: the tune side of air/session.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


class _TuneSession:
    def __init__(self, reporter, checkpoint, stop_event, trial_info):
        self.reporter = reporter
        self.loaded_checkpoint = checkpoint
        self.stop_event = stop_event
        self.trial_info = trial_info or {}


_session: Optional[_TuneSession] = None
_lock = threading.Lock()


def _init(
    reporter: Callable,
    checkpoint: Optional[Checkpoint],
    stop_event: threading.Event,
    trial_info: Dict,
):
    global _session
    with _lock:
        _session = _TuneSession(reporter, checkpoint, stop_event, trial_info)


def _shutdown():
    global _session
    with _lock:
        _session = None


def get_session() -> Optional[_TuneSession]:
    return _session


def report(metrics: Dict, *, checkpoint: Optional[Checkpoint] = None):
    """Ship one intermediate result to the trial driver. Falls through to the
    Train session when running inside a Train worker rather than a Tune
    function trainable."""
    s = _session
    if s is None:
        from ray_tpu_torch.train import session as train_session

        return train_session.report(metrics, checkpoint=checkpoint)
    s.reporter(metrics, checkpoint)
    if s.stop_event.is_set():
        raise SystemExit("tune: trial stop requested")


def get_checkpoint() -> Optional[Checkpoint]:
    s = _session
    if s is None:
        from ray_tpu_torch.train import session as train_session

        return train_session.get_checkpoint()
    return s.loaded_checkpoint


def get_trial_id() -> Optional[str]:
    s = _session
    return s.trial_info.get("trial_id") if s else None


def get_trial_name() -> Optional[str]:
    s = _session
    return s.trial_info.get("trial_name") if s else None


def get_trial_resources():
    s = _session
    return s.trial_info.get("resources") if s else None
