"""Train session: worker↔driver report plumbing.

ray parity: python/ray/train/_internal/session.py:84 (_TrainSession),
air/session.py (report/get_checkpoint/get_context). Inside a train worker the
user loop calls ``report(metrics, checkpoint=...)``; results flow through a
queue polled by the BackendExecutor on the driver.

Step observatory hooks (_private/steptrace.py): ``init_session`` stamps
the worker's rank/world onto the process steptrace context,
``step_phase("data"|"h2d"|"compute"|"optimizer")`` records intra-step
phase intervals, and every ``report()`` auto-delimits a step boundary —
so a multi-rank trainer gets a merged per-step timeline
(``util.state.train_timeline()``) without any explicit instrumentation
beyond its existing report loop.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private import steptrace
from ray_tpu_torch.air.checkpoint import Checkpoint


class TrainContext:
    def __init__(self, rank: int, world_size: int, local_rank: int = 0,
                 local_world_size: int = 1, node_rank: int = 0,
                 experiment_name: str = "", trial_name: str = "",
                 trial_id: str = "", trial_dir: str = ""):
        self._rank = rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self._trial_id = trial_id
        self._trial_dir = trial_dir

    def get_world_size(self) -> int:
        return self._world_size

    def get_world_rank(self) -> int:
        return self._rank

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_trial_name(self) -> str:
        return self._trial_name

    def get_trial_id(self) -> str:
        return self._trial_id

    def get_trial_dir(self) -> str:
        return self._trial_dir


class _Session:
    def __init__(self, ctx: TrainContext, loaded_checkpoint: Optional[Checkpoint]):
        self.ctx = ctx
        self.queue: "queue.Queue" = queue.Queue()
        self.loaded_checkpoint = loaded_checkpoint
        self.stop_requested = threading.Event()
        self.dataset_shards: Dict[str, Any] = {}
        # gang-supervision surface: progress heartbeat for the driver-side
        # watchdog (stamped at every report) and the SIGTERM drain latch
        self.drain_requested = threading.Event()
        self.step_count = 0
        self.last_progress = time.monotonic()
        # TorchTrainer(overlap_grads=True): GradSync dispatches gradient
        # allreduces on a background thread so collective chunk spans
        # interleave with the step's compute phase spans
        self.overlap_grads = False


_session: Optional[_Session] = None
_lock = threading.Lock()
# process default for overlap_grads: the backend's on_start runs before the
# worker enters its train loop (and so before init_session), so the trainer
# flag lands here and every subsequent session inherits it
_overlap_default = False


def init_session(ctx: TrainContext, loaded_checkpoint: Optional[Checkpoint]) -> _Session:
    global _session
    with _lock:
        _session = _Session(ctx, loaded_checkpoint)
        _session.overlap_grads = _overlap_default
    # steptrace records (phases, step boundaries, compiles) carry this
    # worker's rank from here on; step 0 starts now. The compile listener
    # records every kernel build (nvcc) of this process into the ring, so
    # a first step that builds the kernels shows it in the timeline.
    steptrace.set_train_context(ctx.get_world_rank(), ctx.get_world_size())
    steptrace.install_compile_listener()
    return _session


def shutdown_session():
    global _session
    with _lock:
        _session = None
    steptrace.clear_train_context()


def get_session() -> Optional[_Session]:
    return _session


def request_drain() -> bool:
    """Ask the active session to drain: checkpoint at the next step boundary
    (the next ``report()``) and exit cleanly. Returns whether a session was
    there to accept — the SIGTERM handler falls back to immediate exit when
    no training is in flight."""
    s = _session
    if s is None:
        return False
    s.drain_requested.set()
    return True


def health() -> Dict[str, Any]:
    """Progress snapshot for the driver-side gang watchdog."""
    s = _session
    if s is None:
        return {"active": False}
    return {
        "active": True,
        "step": s.step_count,
        "since_progress_s": time.monotonic() - s.last_progress,
        "draining": s.drain_requested.is_set(),
    }


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
    """ray parity: ray.train.report — ship metrics (+ checkpoint) to the
    driver. Outside a session, a no-op with the metrics returned for
    testability."""
    s = _session
    if s is None:
        return metrics
    # step observatory: a report IS the natural step boundary — close the
    # current step interval and open the next (steptrace no-ops when off)
    steptrace.step_mark()
    s.step_count += 1
    s.last_progress = time.monotonic()
    payload = {"type": "report", "metrics": dict(metrics)}
    if checkpoint is not None:
        # Materialize to a directory so the driver (possibly another node)
        # persists it from shared storage; in-memory dicts ride the queue.
        payload["checkpoint_data"] = (
            checkpoint._data if checkpoint._data is not None else None
        )
        payload["checkpoint_path"] = checkpoint._path
    draining = s.drain_requested.is_set()
    if draining:
        # spot preemption: this report is the step boundary the drain was
        # waiting for — tag it so the executor requeues WITHOUT burning a
        # failure-budget slot, then exit the loop cleanly
        payload["drain"] = True
    s.queue.put(payload)
    if draining:
        raise SystemExit("drain requested (preemption)")
    if s.stop_requested.is_set():
        raise SystemExit("training stop requested")


def step_phase(name: str):
    """Context manager delimiting one phase of the current training step
    — canonical phases are ``"data"`` (host-side batch prep), ``"h2d"``
    (host-to-device transfer), ``"compute"`` (the train step), and
    ``"optimizer"`` (update/apply); free-form names render too. Records
    into the step observatory ring (zero-cost when steptrace is
    disabled); the merged multi-rank view comes back through
    ``util.state.train_timeline()`` / ``ray_tpu_torch train timeline``::

        with train.step_phase("data"):
            batch = next(it)
        with train.step_phase("compute"):
            params, opt_state, loss = step(params, opt_state, batch)
        train.report({"loss": float(loss)})   # step boundary
    """
    return steptrace.phase(name)


def set_overlap_grads(enabled: bool) -> bool:
    """Arm (or disarm) gradient/compute overlap — the trainer's
    ``overlap_grads=True`` lands here on each worker (at backend
    ``on_start``, i.e. usually before the session exists, hence the
    sticky process default). Returns whether a live session took it."""
    global _overlap_default
    _overlap_default = bool(enabled)
    s = _session
    if s is None:
        return False
    s.overlap_grads = bool(enabled)
    return True


class GradSync:
    """Per-tensor gradient allreduce with optional compute overlap.

    ``submit(name, grad)`` hands one gradient tensor to the collective
    backend; ``results()`` waits for everything submitted and returns
    ``{name: reduced}`` in submission order. With overlap on (the
    session's ``overlap_grads`` flag, or ``overlap=True`` explicitly),
    submits dispatch on ONE background thread so the store-path chunked
    allreduce runs under the remaining backward/step compute — its
    collective + chunk spans interleave with ``step_phase("compute")``
    spans in the train timeline (T3-style, arxiv 2401.16677). With
    overlap off, submit reduces inline (same results, serial timeline).

    Ordering contract: all ranks must submit the same tensor names in
    the same order (the usual DDP bucket contract) — the single
    dispatch thread preserves submission order, so the group's seq
    numbers stay aligned across ranks. Don't run other collectives on
    the same group concurrently with a live GradSync.
    """

    def __init__(self, group_name: str = "train_dp", op: str = "mean",
                 overlap: Optional[bool] = None,
                 timeout: Optional[float] = None):
        s = _session
        if overlap is None:
            overlap = bool(s and s.overlap_grads)
        self.group_name = group_name
        self.op = op
        self.overlap = overlap
        self.timeout = timeout
        self._pending: list = []  # (name, result | Future)
        self._pool = None
        if overlap:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gradsync")

    def _reduce(self, tensor):
        from ray_tpu_torch.util import collective as col

        kwargs = {}
        if self.timeout is not None:
            kwargs["timeout"] = self.timeout
        return col.allreduce(tensor, self.group_name, op=self.op, **kwargs)

    def submit(self, name: str, tensor) -> None:
        if self._pool is not None:
            self._pending.append((name, self._pool.submit(self._reduce,
                                                          tensor)))
        else:
            self._pending.append((name, self._reduce(tensor)))

    def results(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        pending, self._pending = self._pending, []
        for name, r in pending:
            out[name] = r.result() if hasattr(r, "result") else r
        return out

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.results()
        self.close()
        return False


def get_checkpoint() -> Optional[Checkpoint]:
    s = _session
    return s.loaded_checkpoint if s else None


def get_dataset_shard(dataset_name: str = "train"):
    """ray parity: ray.train.get_dataset_shard — this worker's streaming
    split of the Dataset passed to the trainer's ``datasets=``."""
    s = _session
    if s is None:
        return None
    return s.dataset_shards.get(dataset_name)


def get_context() -> TrainContext:
    s = _session
    if s is None:
        return TrainContext(rank=0, world_size=1)
    return s.ctx
