"""Workflow: durable DAG execution with per-step checkpointing + resume.

ray parity: python/ray/workflow — `workflow.run(dag)` executes a
`ray_tpu_torch.dag` DAG with every step's result checkpointed to storage
(workflow_executor.py:32 WorkflowExecutor, workflow_storage.py), so a
crashed/killed run resumes from completed steps instead of recomputing
them. Storage is a filesystem directory (pluggable via ``storage``/the
RAY_TPU_TORCH_WORKFLOW_STORAGE env var); step identity is the DAG-structural
hash of the node (function name + argument structure), which is stable
across processes.

API: run / run_async, resume, get_status, get_output, list_all, delete.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.dag import ClassMethodNode, ClassNode, DAGNode, FunctionNode, InputNode
from ray_tpu_torch.workflow.events import (
    EventListener,
    EventNode,
    TimerListener,
    wait_for_event,
)

logger = logging.getLogger(__name__)

# statuses (ray parity: workflow.WorkflowStatus)
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
RESUMABLE = "RESUMABLE"
CANCELED = "CANCELED"


class WorkflowNotFoundError(KeyError):
    def __init__(self, workflow_id: str):
        super().__init__(f"no workflow {workflow_id!r} in storage")


class WorkflowCancellationError(RuntimeError):
    def __init__(self, workflow_id: str):
        super().__init__(f"workflow {workflow_id!r} was canceled")


def _storage_root(storage: Optional[str] = None) -> str:
    root = storage or os.environ.get(
        "RAY_TPU_TORCH_WORKFLOW_STORAGE",
        os.path.expanduser("~/ray_tpu_torch_workflows"),
    )
    os.makedirs(root, exist_ok=True)
    return root


def _step_id(node: DAGNode, cache: Dict[int, str]) -> str:
    """Deterministic structural id: function/method name + the step ids /
    repr of bound args, disambiguated by occurrence number so two sibling
    calls with identical signatures get distinct checkpoints (ray gives
    each bind a unique step id). Stable across processes because DAG
    traversal order is deterministic."""
    if id(node) in cache:
        return cache[id(node)]
    h = hashlib.sha256()
    if isinstance(node, FunctionNode):
        h.update(getattr(node._fn, "__name__", "fn").encode())
    elif isinstance(node, ClassMethodNode):
        h.update(node._method.encode())
        if isinstance(node._target, DAGNode):
            h.update(_step_id(node._target, cache).encode())
    elif isinstance(node, ClassNode):
        h.update(getattr(node._cls, "__name__", "cls").encode())
    elif isinstance(node, InputNode):
        h.update(b"__input__")
    elif isinstance(node, EventNode):
        h.update(node.name.encode())
    def feed(value):
        if isinstance(value, DAGNode):
            h.update(_step_id(value, cache).encode())
        else:
            h.update(repr(value).encode())

    for a in node._bound_args:
        feed(a)
    for k in sorted(node._bound_kwargs):
        h.update(k.encode())
        feed(node._bound_kwargs[k])
    base = h.hexdigest()[:16]
    counts = cache.setdefault("__counts__", {})
    k = counts.get(base, 0)
    counts[base] = k + 1
    sid = base if k == 0 else f"{base}-{k}"
    cache[id(node)] = sid
    return sid


class _WorkflowRun:
    def __init__(self, workflow_id: str, storage: Optional[str]):
        self.workflow_id = workflow_id
        self.storage = _storage_root(storage)
        self.dir = os.path.join(self.storage, workflow_id)
        os.makedirs(self.dir, exist_ok=True)

    # -- metadata ------------------------------------------------------
    def _meta_path(self):
        return os.path.join(self.dir, "meta.pkl")

    def write_meta(self, **kw):
        meta = self.read_meta()
        meta.update(kw, ts=time.time())
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def read_meta(self) -> dict:
        try:
            with open(self._meta_path(), "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError):
            return {"workflow_id": self.workflow_id}

    # -- step checkpoints ---------------------------------------------
    def step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, f"step_{step_id}.pkl")

    def load_step(self, step_id: str):
        path = self.step_path(step_id)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            return None

    def save_step(self, step_id: str, value: Any):
        tmp = self.step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"value": value}, f, protocol=5)
        os.replace(tmp, self.step_path(step_id))

    # -- execution -----------------------------------------------------
    def execute(self, node: DAGNode, dag_input: Any = None) -> Any:
        """Walk the DAG: checkpointed steps are skipped, others submit as
        cluster tasks whose results checkpoint on completion."""
        import ray_tpu_torch

        self.write_meta(status=RUNNING, owner_pid=os.getpid(),
                        owner_host=os.uname().nodename)
        from ray_tpu_torch.workflow import workflow_access

        workflow_access.notify(
            "register", self.workflow_id, self.storage, os.getpid(),
            os.uname().nodename,
        )
        ids: Dict[int, str] = {}
        memo: Dict[int, Any] = {}

        def resolve(n: DAGNode):
            if id(n) in memo:
                return memo[id(n)]
            if isinstance(n, InputNode):
                memo[id(n)] = dag_input
                return dag_input
            sid = _step_id(n, ids)
            # Actor handles aren't durable: ClassNode re-executes on resume.
            if not isinstance(n, ClassNode):
                ckpt = self.load_step(sid)
                if ckpt is not None:
                    memo[id(n)] = ckpt["value"]
                    return ckpt["value"]
            args = [resolve(a) if isinstance(a, DAGNode) else a
                    for a in n._bound_args]
            kwargs = {k: resolve(v) if isinstance(v, DAGNode) else v
                      for k, v in n._bound_kwargs.items()}
            # check AFTER dependencies resolved, right before the step
            # launches: a cancel landing while upstream steps execute
            # must stop the unwind (a descent-time check would run at
            # t~0 for every node and catch nothing)
            if self.read_meta().get("status") == CANCELED:
                raise WorkflowCancellationError(self.workflow_id)
            if isinstance(n, EventNode):
                # event steps run in-process: the listener blocks until
                # the event arrives, the payload checkpoints, and only
                # then is event_checkpointed acked (at-least-once)
                listener, value = n.poll(args, kwargs)
                self.save_step(sid, value)
                try:
                    listener.event_checkpointed(value)
                except Exception:
                    logger.warning(
                        "event_checkpointed failed for %s in workflow %s; "
                        "the event is checkpointed and will NOT be "
                        "re-acked on resume", n.name, self.workflow_id,
                        exc_info=True,
                    )
                memo[id(n)] = value
                return value
            if isinstance(n, FunctionNode):
                value = ray_tpu_torch.get(n._fn.remote(*args, **kwargs))
            elif isinstance(n, ClassNode):
                value = n._cls.remote(*args, **kwargs)
            elif isinstance(n, ClassMethodNode):
                target = n._target
                if isinstance(target, DAGNode):
                    target = resolve(target)
                value = ray_tpu_torch.get(
                    getattr(target, n._method).remote(*args, **kwargs)
                )
            else:
                raise TypeError(f"unsupported DAG node {type(n).__name__}")
            if not isinstance(n, ClassNode):
                self.save_step(sid, value)
            memo[id(n)] = value
            return value

        try:
            result = resolve(node)
        except WorkflowCancellationError:
            workflow_access.notify("mark", self.workflow_id, CANCELED)
            raise
        except Exception as e:
            self.write_meta(status=FAILED, error=f"{type(e).__name__}: {e}")
            workflow_access.notify("mark", self.workflow_id, FAILED)
            raise
        self.write_meta(status=SUCCESSFUL)
        workflow_access.notify("mark", self.workflow_id, SUCCESSFUL)
        self.save_step("__output__", result)
        return result


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None, dag_input: Any = None) -> Any:
    """Execute a DAG durably; returns the output value. If ``workflow_id``
    names a previous (possibly crashed) run in the same storage, completed
    steps are reused (ray parity: workflow.run)."""
    workflow_id = workflow_id or f"workflow_{uuid.uuid4().hex[:12]}"
    wf = _WorkflowRun(workflow_id, storage)
    # A DAG that already ran to completion returns its stored output.
    out = wf.load_step("__output__")
    if out is not None and wf.read_meta().get("status") == SUCCESSFUL:
        return out["value"]
    return wf.execute(dag, dag_input)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              storage: Optional[str] = None, dag_input: Any = None):
    """Like run() but returns a concurrent.futures.Future."""
    import concurrent.futures
    import threading

    fut: "concurrent.futures.Future" = concurrent.futures.Future()

    def worker():
        try:
            fut.set_result(run(dag, workflow_id=workflow_id, storage=storage,
                               dag_input=dag_input))
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=worker, daemon=True).start()
    return fut


def resume(workflow_id: str, dag: DAGNode, *,
           storage: Optional[str] = None, dag_input: Any = None) -> Any:
    """Resume an interrupted workflow: completed steps load from storage,
    the rest execute. The DAG must be re-supplied (code isn't persisted;
    step identity is structural, so the same DAG maps onto its
    checkpoints)."""
    return run(dag, workflow_id=workflow_id, storage=storage,
               dag_input=dag_input)


def get_status(workflow_id: str, storage: Optional[str] = None) -> str:
    meta = _WorkflowRun(workflow_id, storage).read_meta()
    status = meta.get("status")
    if status == RUNNING:
        # Only a RUNNING record whose owner process is gone is a crashed
        # (resumable) run; a live owner is genuinely still executing.
        pid = meta.get("owner_pid")
        same_host = meta.get("owner_host") == os.uname().nodename
        if pid and same_host:
            try:
                os.kill(pid, 0)
                return RUNNING
            except OSError:
                return RESUMABLE
        return RESUMABLE
    return status or RESUMABLE


def get_output(workflow_id: str, storage: Optional[str] = None) -> Any:
    wf = _WorkflowRun(workflow_id, storage)
    out = wf.load_step("__output__")
    if out is None:
        raise ValueError(f"workflow {workflow_id!r} has no output yet")
    return out["value"]


def cancel(workflow_id: str, storage: Optional[str] = None) -> None:
    """Cancel a running workflow (ray parity: workflow.cancel): the
    durable meta flips to CANCELED and the executing driver's step loop
    raises WorkflowCancellationError before its next step. Works from a
    different driver via the management actor; falls back to writing
    storage directly."""
    from ray_tpu_torch.workflow import workflow_access

    meta_path = os.path.join(_storage_root(storage), workflow_id,
                             "meta.pkl")
    if not os.path.exists(meta_path):
        raise WorkflowNotFoundError(workflow_id)
    actor = workflow_access.get_management_actor()
    if actor is not None:
        try:
            import ray_tpu_torch

            if ray_tpu_torch.get(actor.cancel.remote(workflow_id), timeout=30):
                return
        except Exception:
            pass
    run = _WorkflowRun(workflow_id, storage)
    if run.read_meta().get("status") == RUNNING:
        # never clobber a terminal SUCCESSFUL/FAILED record: a canceled
        # finished workflow would re-execute on the next run() call
        run.write_meta(status=CANCELED)


def list_all(storage: Optional[str] = None):
    root = _storage_root(storage)
    out = []
    for name in sorted(os.listdir(root)):
        if os.path.isdir(os.path.join(root, name)):
            out.append((name, get_status(name, storage)))
    return out


def delete(workflow_id: str, storage: Optional[str] = None):
    import shutil

    shutil.rmtree(os.path.join(_storage_root(storage), workflow_id),
                  ignore_errors=True)


from ray_tpu_torch.workflow.workflow_access import (  # noqa: E402
    WorkflowManagementActor,
    get_management_actor,
)
