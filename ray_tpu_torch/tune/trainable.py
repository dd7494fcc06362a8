"""Trainable — the unit of execution for a Tune trial (ray parity:
python/ray/tune/trainable/trainable.py:73 class API;
function_trainable.py:302 function API via thread + report queue).

One Trainable instance lives inside one trial actor. The controller drives
it with ``train()`` (one step → one result dict), ``save()``/``restore()``
(checkpoints as in-memory dicts riding the object store, so PBT exploit and
fault-tolerant restore need no shared filesystem), and ``stop()``.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"
# Marks a FunctionTrainable wrapper checkpoint; consumers (ResultGrid)
# unwrap it rather than handing the wrapper dict to the user.
FN_CHECKPOINT_KEY = "__fn_checkpoint__"
FN_LAST_METRICS_KEY = "__fn_last_metrics__"


class Trainable:
    def __init__(self, config: Optional[Dict] = None, trial_info: Optional[Dict] = None):
        self.config = dict(config or {})
        self.trial_info = trial_info or {}
        self._iteration = 0
        self._time_total = 0.0
        self._start_time = time.time()
        self.setup(self.config)

    # -- subclass API -------------------------------------------------------
    def setup(self, config: Dict):
        pass

    def step(self) -> Dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: Optional[str] = None) -> Optional[Dict]:
        return None

    def load_checkpoint(self, checkpoint: Optional[Dict]):
        pass

    def cleanup(self):
        pass

    def reset_config(self, new_config: Dict) -> bool:
        """Return True if the trainable supports in-place config reset
        (enables actor reuse under PBT)."""
        return False

    # -- controller-facing API ---------------------------------------------
    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> Dict:
        t0 = time.time()
        result = self.step() or {}
        self._iteration += 1
        self._time_total += time.time() - t0
        result.setdefault(TRAINING_ITERATION, self._iteration)
        result.setdefault("time_this_iter_s", time.time() - t0)
        result.setdefault("time_total_s", self._time_total)
        result.setdefault("timestamp", time.time())
        result.setdefault("config", self.config)
        result.setdefault(RESULT_DONE, False)
        return result

    def save(self) -> Dict:
        state = self.save_checkpoint() or {}
        return {
            "state": state,
            "iteration": self._iteration,
            "time_total": self._time_total,
        }

    def restore(self, payload: Dict):
        self._iteration = payload.get("iteration", 0)
        self._time_total = payload.get("time_total", 0.0)
        self.load_checkpoint(payload.get("state"))

    def reset(self, new_config: Dict, trial_info: Optional[Dict] = None) -> bool:
        if trial_info:
            self.trial_info = trial_info
        if self.reset_config(new_config):
            self.config = dict(new_config)
            # A reused actor starts a fresh trial: counters must not leak
            # from the previous one (reference Trainable.reset does the same).
            self._iteration = 0
            self._time_total = 0.0
            self._start_time = time.time()
            return True
        return False

    def stop(self):
        self.cleanup()


class FunctionTrainable(Trainable):
    """Wraps ``def train_fn(config)`` — runs it on a thread; every
    ``tune.report`` ships one result through a queue, consumed by ``train()``.
    """

    _fn: Callable = None  # bound by wrap_function subclass

    def setup(self, config: Dict):
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._stop_event = threading.Event()
        self._restore_checkpoint: Optional[Dict] = None
        self._thread: Optional[threading.Thread] = None
        self._last_checkpoint: Optional[Dict] = None
        self._last_metrics: Optional[Dict] = None

    def _run(self):
        from ray_tpu_torch.tune import session as tune_session

        tune_session._init(
            reporter=self._report_from_fn,
            checkpoint=(
                Checkpoint.from_dict(self._restore_checkpoint[FN_CHECKPOINT_KEY])
                if self._restore_checkpoint
                and self._restore_checkpoint.get(FN_CHECKPOINT_KEY) is not None
                else None
            ),
            stop_event=self._stop_event,
            trial_info=self.trial_info,
        )
        try:
            fn = type(self)._fn
            params = inspect.signature(fn).parameters
            if len(params) > 1 and "checkpoint_dir" in params:
                fn(self.config, checkpoint_dir=None)
            else:
                fn(self.config)
            self._queue.put({"__fn_done__": True})
        except SystemExit:
            self._queue.put({"__fn_done__": True})
        except BaseException as e:  # noqa: BLE001 — shipped to driver
            self._error = e
            self._queue.put(
                {"__fn_error__": traceback.format_exc(), "__exc__": e}
            )
        finally:
            tune_session._shutdown()

    def _report_from_fn(self, metrics: Dict, checkpoint: Optional[Checkpoint]):
        item = {"metrics": dict(metrics)}
        if checkpoint is not None:
            item["checkpoint"] = checkpoint.to_dict()
        self._queue.put(item)

    def step(self) -> Dict:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        item = self._queue.get()
        if item.get("__fn_done__"):
            # Duplicate the last reported metrics so the terminal result is
            # not a bare sentinel (reference: RESULT_DUPLICATE).
            return {**(self._last_metrics or {}), RESULT_DONE: True}
        if "__fn_error__" in item:
            raise item["__exc__"]
        if "checkpoint" in item:
            self._last_checkpoint = item["checkpoint"]
        result = item["metrics"]
        self._last_metrics = dict(result)
        result[RESULT_DONE] = False
        return result

    def save_checkpoint(self, checkpoint_dir: Optional[str] = None) -> Optional[Dict]:
        # Sentinel key so downstream consumers (ResultGrid) can tell this
        # wrapper apart from a user-authored checkpoint dict. The last
        # reported metrics ride along so a restored trial that finishes
        # WITHOUT reporting again (restored right at its end — e.g. after
        # a PBT exploit or a resource-change restart) still ends with its
        # real metrics instead of a bare done sentinel.
        return {FN_CHECKPOINT_KEY: self._last_checkpoint,
                FN_LAST_METRICS_KEY: self._last_metrics}

    def load_checkpoint(self, checkpoint: Optional[Dict]):
        self._restore_checkpoint = checkpoint
        if checkpoint and checkpoint.get(FN_CHECKPOINT_KEY) is not None:
            self._last_checkpoint = checkpoint[FN_CHECKPOINT_KEY]
        if checkpoint and checkpoint.get(FN_LAST_METRICS_KEY) is not None:
            self._last_metrics = dict(checkpoint[FN_LAST_METRICS_KEY])

    def cleanup(self):
        self._stop_event.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)


def wrap_function(train_fn: Callable) -> type:
    """Build a FunctionTrainable subclass bound to ``train_fn``
    (ray parity: function_trainable.py wrap_function)."""

    class _WrappedFunc(FunctionTrainable):
        _fn = staticmethod(train_fn)

    _WrappedFunc.__name__ = getattr(train_fn, "__name__", "func")
    return _WrappedFunc


def is_function_trainable(trainable: Any) -> bool:
    return callable(trainable) and not (
        inspect.isclass(trainable) and issubclass(trainable, Trainable)
    )
