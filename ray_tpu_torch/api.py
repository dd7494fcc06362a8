"""Public API: init/remote/get/put/wait + actors.

Mirrors the reference's user-facing surface (ray: python/ray/_private/worker.py
init:1108 get:2417 put:2546 wait:2609 remote:2952, remote_function.py:245,
actor.py) on top of the port's runtime.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private.common import SchedulingStrategy
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import (
    ActorDiedError,
    CoreWorker,
    GetTimeoutError,
    TaskCancelledError,
    WorkerDiedError,
    global_worker,
)
from ray_tpu_torch._private.serialization import TaskError

logger = logging.getLogger(__name__)

_init_lock = threading.Lock()


# ---------------------------------------------------------------------------
# init / shutdown
# ---------------------------------------------------------------------------


class RayContext:
    def __init__(self, address: str, node_id: str):
        self.address_info = {"address": address, "node_id": node_id}

    def __getitem__(self, k):
        return self.address_info[k]


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    namespace: Optional[str] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    _system_config: Optional[dict] = None,
    log_to_driver: bool = True,
) -> RayContext:
    """Start (or connect to) a cluster and connect this driver.

    ray parity: ray.init (python/ray/_private/worker.py:1108). With no
    address, starts a head node (GCS + raylet) owned by this process.
    """
    with _init_lock:
        if global_worker.connected:
            if ignore_reinit_error:
                cw = global_worker.core_worker
                return RayContext("existing", cw.node_id)
            raise RuntimeError("ray_tpu_torch.init() called twice")
        if _system_config:
            cfg.update(_system_config)
        if object_store_memory:
            cfg.update({"object_store_memory": object_store_memory})
        if address == "auto":
            # Inside a cluster (worker/job-entrypoint subprocess): the
            # raylet stamps the GCS address into the env (ray parity:
            # RAY_ADDRESS/auto-discovery).
            address = os.environ.get("RAY_TPU_TORCH_GCS_ADDR")
            if not address:
                raise ConnectionError(
                    "address='auto' but RAY_TPU_TORCH_GCS_ADDR is not set"
                )
        if address is None:
            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            from ray_tpu_torch._private.node import NodeProcesses

            node = NodeProcesses(head=True, resources=res or None, labels=labels)
            global_worker.node = node
            address = node.address
            raylet_host, raylet_port = "127.0.0.1", node.raylet_port
            gcs_host, gcs_port = address.rsplit(":", 1)
        else:
            gcs_host, gcs_port = address.rsplit(":", 1)
            # Separately launched driver: pick up the head's persisted
            # cluster token (session dir / CLI state file) when the env
            # doesn't already carry one, else rpcio auth silently drops us.
            from ray_tpu_torch._private.node import load_cluster_token

            load_cluster_token()
            # Connecting to an existing cluster: find/start a local raylet is
            # out of scope round 1 — connect to the head's raylet via GCS.
            import asyncio

            from ray_tpu_torch._private.rpcio import EventLoopThread, connect as rpc_connect

            tmp_io = EventLoopThread("init-probe")
            conn = tmp_io.run(rpc_connect(gcs_host, int(gcs_port)))
            nodes = tmp_io.run(conn.request("get_nodes", {}))
            tmp_io.run(conn.close())
            tmp_io.stop()
            alive = [n for n in nodes if n["alive"]]
            if not alive:
                raise ConnectionError(f"no alive nodes in cluster at {address}")
            raylet_host, raylet_port = alive[0]["host"], alive[0]["port"]
        cw = CoreWorker(
            raylet_host=raylet_host,
            raylet_port=int(raylet_port),
            gcs_host=gcs_host,
            gcs_port=int(gcs_port),
            is_driver=True,
            namespace=namespace,
        )
        global_worker.core_worker = cw
        global_worker.mode = "driver"
        # both gates must agree: the init() kwarg and the config flag
        # (RAY_TPU_TORCH_LOG_TO_DRIVER=0 kills streaming cluster-wide without
        # touching code; with no subscribers, raylets skip tailing too)
        if log_to_driver and cfg.log_to_driver:
            _subscribe_worker_logs(cw)
        # local usage snapshot (reference: usage_lib's session report;
        # this build never phones home — see usage_lib docstring)
        if global_worker.node is not None:
            try:
                from ray_tpu_torch._private import usage_lib

                if usage_lib.usage_stats_enabled():
                    usage_lib.write_usage_stats(
                        global_worker.node.session_dir
                    )
            except Exception:
                pass
        return RayContext(address, cw.node_id)


# per-worker prefix colors (ray parity: worker.py cycles colors by pid so
# interleaved workers stay tellable apart); 36=cyan first for continuity
_LOG_COLORS = (36, 35, 33, 32, 34, 31)


def _subscribe_worker_logs(cw):
    """Print worker stdout/stderr on the driver (ray parity:
    _private/log_monitor.py + worker.py print_logs — lines arrive over
    GCS pubsub from each raylet's log tailer, attributed to tasks by
    byte-offset spans, and render as ``(<TaskName> pid=<pid>
    node=<id8>)``-prefixed lines; identical lines fanning in from many
    workers collapse through a dedup window into one ``[repeated Nx]``
    summary. Entries are tagged with the worker's job so concurrent
    drivers only see their own job's output)."""
    import sys
    import time as _time

    from ray_tpu_torch._private import logplane, metrics_core

    my_job = cw.job_id.hex() if cw.job_id else None
    dedup = logplane.LogDeduplicator(window_s=cfg.log_dedup_window_s)
    # self-measurement: printed-line count + handler CPU for the
    # BENCH_LOG_OVERHEAD lane (snapshot-time callbacks, zero hot-path
    # cost beyond the dict writes below)
    stats = {"lines": 0, "seconds": 0.0}
    reg = metrics_core.registry()
    ltags = {"channel": "logs"}
    reg.counter("driver_log_lines_printed_total",
                "Streamed worker log lines printed by this driver"
                ).labels(**ltags).set_fn(lambda: stats["lines"])
    reg.counter("driver_log_handler_seconds_total",
                "CPU seconds in the driver's log-print handler"
                ).labels(**ltags).set_fn(lambda: stats["seconds"])

    def on_logs(msg):
        # thread_time: CPU actually burned here, not GIL-contended wall
        t0 = _time.thread_time()
        node = (msg.get("node_id") or "")[:8]
        out = []
        for entry in msg.get("workers", ()):
            job = entry.get("job_id")
            if job is not None and my_job is not None and job != my_job:
                continue
            pid = entry.get("pid")
            color = _LOG_COLORS[(pid or 0) % len(_LOG_COLORS)]
            # "segs" groups consecutive lines by attributed task name
            for name, lines in entry.get("segs") or ():
                label = f"{name} pid={pid} node={node}" if name \
                    else f"pid={pid} node={node}"
                prefix = f"\x1b[{color}m({label})\x1b[0m "
                for line in lines:
                    out.extend(dedup.feed(prefix, line))
        out.extend(dedup.flush())
        if out:
            print("\n".join(out), file=sys.stderr)
            stats["lines"] += len(out)
        stats["seconds"] += _time.thread_time() - t0

    async def _summary_flusher():
        # a quiet stream must still surface its pending [repeated Nx]
        # summaries: without this tick they would wait for the NEXT log
        # message (or shutdown), hiding how many workers really printed
        import asyncio

        while True:
            await asyncio.sleep(max(0.25, cfg.log_dedup_window_s))
            try:
                out = dedup.flush()
                if out:
                    print("\n".join(out), file=sys.stderr)
                    stats["lines"] += len(out)
            except Exception:
                pass

    try:
        cw.subscribe("logs", on_logs)
        cw._log_dedup = dedup  # shutdown drains the last summaries
        import asyncio as _asyncio

        cw._log_flush_task = _asyncio.run_coroutine_threadsafe(
            _summary_flusher(), cw.io.loop)
    except Exception:
        pass  # logs stay in session files


def shutdown():
    with _init_lock:
        cw = global_worker.core_worker
        if cw is not None:
            task = getattr(cw, "_log_flush_task", None)
            if task is not None:
                task.cancel()
            dedup = getattr(cw, "_log_dedup", None)
            if dedup is not None:
                # drain pending [repeated Nx] summaries before the pubsub
                # subscription dies with the connection
                import sys

                tail = dedup.flush(force=True)
                if tail:
                    print("\n".join(tail), file=sys.stderr)
            try:
                cw.disconnect()
            except Exception:
                pass
            global_worker.core_worker = None
        if global_worker.node is not None:
            global_worker.node.shutdown()
            global_worker.node = None


def is_initialized() -> bool:
    return global_worker.connected


# ---------------------------------------------------------------------------
# core object API
# ---------------------------------------------------------------------------


def put(value: Any) -> ObjectRef:
    global_worker.check_connected()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put on an ObjectRef is not allowed")
    return global_worker.core_worker.put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    global_worker.check_connected()
    if isinstance(refs, list):
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
    elif not isinstance(refs, ObjectRef):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    return global_worker.core_worker.get(refs, timeout=timeout)


def wait(
    refs: List[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    global_worker.check_connected()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(f"num_returns must be in 1..{len(refs)}")
    return global_worker.core_worker.wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    global_worker.check_connected()
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    global_worker.core_worker.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    global_worker.check_connected()
    global_worker.core_worker.cancel_task(ref, force=force)


def nodes() -> list:
    """Cluster node table (ray parity: ray.nodes())."""
    global_worker.check_connected()
    return global_worker.core_worker.get_nodes()


def cluster_resources() -> Dict[str, float]:
    """Total resources across alive nodes (ray parity: ray.cluster_resources)."""
    totals: Dict[str, float] = {}
    for n in nodes():
        if not n.get("alive", True):
            continue
        for k, v in (n.get("resources_total") or {}).items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def available_resources() -> Dict[str, float]:
    """Currently-free resources (ray parity: ray.available_resources)."""
    avail: Dict[str, float] = {}
    for n in nodes():
        if not n.get("alive", True):
            continue
        for k, v in (n.get("resources_available") or {}).items():
            avail[k] = avail.get(k, 0.0) + v
    return avail


def get_actor(name: str, namespace: Optional[str] = None) -> "ActorHandle":
    global_worker.check_connected()
    table = global_worker.core_worker.get_actor_table(name=name, namespace=namespace)
    if table is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(table["actor_id"], methods=None)


# ---------------------------------------------------------------------------
# options / resource translation
# ---------------------------------------------------------------------------


def _prepare_runtime_env(runtime_env: Optional[dict]) -> Optional[dict]:
    """Package working_dir/py_modules into GCS-stored URIs before the spec
    ships (ray: runtime_env packaging at submission time)."""
    if not runtime_env:
        return runtime_env
    from ray_tpu_torch._private.runtime_env import prepare_runtime_env

    global_worker.check_connected()
    return prepare_runtime_env(global_worker.core_worker, runtime_env)


def _build_resources(opts: dict, default_cpu: float) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        res["CPU"] = float(opts["num_cpus"])
    elif "CPU" not in res:
        res["CPU"] = default_cpu
    if opts.get("num_gpus") is not None:
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("memory") is not None:
        res["memory"] = float(opts["memory"])
    return {k: v for k, v in res.items() if v}


def _build_scheduling(opts: dict) -> SchedulingStrategy:
    strategy = opts.get("scheduling_strategy")
    if strategy is None or strategy == "DEFAULT":
        # legacy PG options (ray parity: .options(placement_group=pg,
        # placement_group_bundle_index=i) without an explicit strategy)
        pg = opts.get("placement_group")
        if pg is not None:
            idx = opts.get("placement_group_bundle_index")
            return SchedulingStrategy(
                kind="PLACEMENT_GROUP",
                pg_id=pg.id_hex,
                pg_bundle_index=None if idx in (None, -1) else idx,
            )
        return SchedulingStrategy()
    if strategy == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if isinstance(strategy, SchedulingStrategy):
        return strategy
    # util.scheduling_strategies objects
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        NodeLabelSchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )

    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return SchedulingStrategy(
            kind="NODE_AFFINITY", node_id=strategy.node_id, soft=strategy.soft
        )
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return SchedulingStrategy(
            kind="NODE_LABEL", labels_hard=strategy.hard,
            labels_soft=strategy.soft,
        )
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            pg_id=pg.id_hex,
            pg_bundle_index=(
                None
                if strategy.placement_group_bundle_index in (None, -1)
                else strategy.placement_group_bundle_index
            ),
            pg_capture_child_tasks=strategy.placement_group_capture_child_tasks,
        )
    raise TypeError(f"unsupported scheduling_strategy: {strategy!r}")


_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "memory", "resources", "num_returns",
    "max_retries", "retry_exceptions", "max_restarts", "max_task_retries",
    "max_concurrency", "concurrency_groups", "name", "namespace", "lifetime",
    "scheduling_strategy", "runtime_env", "max_calls", "get_if_exists",
    "placement_group", "placement_group_bundle_index",
}


def _check_options(opts: dict):
    for k in opts:
        if k not in _VALID_OPTIONS:
            raise ValueError(f"Invalid option keyword: {k!r}")


# ---------------------------------------------------------------------------
# RemoteFunction
# ---------------------------------------------------------------------------


class RemoteFunction:
    """ray parity: python/ray/remote_function.py:245 (_remote)."""

    def __init__(self, func, options: dict):
        import cloudpickle

        self._function = func
        self._options = options
        self._func_blob = cloudpickle.dumps(func)
        self._template = None  # per-callsite submit template (lazy)
        self.__name__ = getattr(func, "__name__", "remote_function")
        self.__doc__ = getattr(func, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use '{self.__name__}.remote()'."
        )

    def options(self, **opts):
        _check_options(opts)
        merged = {**self._options, **opts}
        rf = RemoteFunction.__new__(RemoteFunction)
        rf._function = self._function
        rf._options = merged
        rf._func_blob = self._func_blob
        rf._template = None  # new options set -> new template
        rf.__name__ = self.__name__
        rf.__doc__ = self.__doc__
        return rf

    def _build_template(self, cw):
        """Resolve options into a CoreWorker submit template — the
        constant per-call work (resource/scheduling translation, runtime
        env packaging) paid once per (RemoteFunction, options, worker)."""
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        if num_returns == "dynamic":
            # ray parity: num_returns="dynamic" — the single visible ref
            # resolves to a list of per-item ObjectRefs (task_manager.h
            # ObjectRefStream / legacy dynamic generators)
            num_returns = -1
        return cw.task_template(
            func=self._function,
            num_returns=num_returns,
            resources=_build_resources(opts, default_cpu=1.0),
            scheduling=_build_scheduling(opts),
            max_retries=opts.get("max_retries", 3),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            name=self.__name__,
            func_blob=self._func_blob,
            runtime_env=_prepare_runtime_env(opts.get("runtime_env")),
        )

    def remote(self, *args, **kwargs):
        global_worker.check_connected()
        cw = global_worker.core_worker
        tmpl = self._template
        if tmpl is None or tmpl.worker is not cw:
            # first call, new options, or a reconnect swapped the worker
            tmpl = self._template = self._build_template(cw)
        refs = cw.submit_from_template(tmpl, args, kwargs)
        if tmpl.num_returns in (1, -1):  # -1 = dynamic: one visible ref
            return refs[0]
        return refs

    def __getstate__(self):
        # a RemoteFunction captured in a task closure ships by value; the
        # template pins the local CoreWorker and must never ride along
        state = self.__dict__.copy()
        state["_template"] = None
        return state

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)


# ---------------------------------------------------------------------------
# Actors
# ---------------------------------------------------------------------------


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group
        self._template = None  # per-method submit template (lazy)

    def options(self, **opts):
        num_returns = opts.get("num_returns", self._num_returns)
        if num_returns == "dynamic":
            raise ValueError(
                "num_returns='dynamic' is not supported for actor tasks"
            )
        return ActorMethod(
            self._handle, self._name, num_returns=num_returns,
            concurrency_group=opts.get(
                "concurrency_group", self._concurrency_group
            ),
        )

    def remote(self, *args, **kwargs):
        return self._handle._invoke(
            self, args, kwargs
        )

    def __getstate__(self):
        # the template pins the local CoreWorker: never serialized (an
        # unpickled method rebuilds it lazily on first .remote())
        state = self.__dict__.copy()
        state["_template"] = None
        return state

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; "
            f"use '.{self._name}.remote()'."
        )


class ActorHandle:
    """ray parity: python/ray/actor.py ActorHandle."""

    def __init__(self, actor_id: bytes, methods: Optional[dict] = None,
                 max_task_retries: int = 0,
                 method_groups: Optional[dict] = None,
                 concurrency_groups: Optional[dict] = None):
        self._actor_id = actor_id
        self._methods = methods or {}
        self._max_task_retries = max_task_retries
        self._method_groups = method_groups or {}
        self._concurrency_groups = concurrency_groups or {}

    def _invoke(self, method: "ActorMethod", args, kwargs):
        global_worker.check_connected()
        cw = global_worker.core_worker
        tmpl = method._template
        if tmpl is None or tmpl.worker is not cw:
            group = (method._concurrency_group
                     or self._method_groups.get(method._name))
            if group is not None and self._concurrency_groups and (
                group not in self._concurrency_groups
            ):
                raise ValueError(
                    f"concurrency group {group!r} not declared on this actor "
                    f"(declared: {sorted(self._concurrency_groups)})"
                )
            tmpl = method._template = cw.actor_task_template(
                self._actor_id,
                method._name,
                num_returns=method._num_returns,
                max_task_retries=self._max_task_retries,
                concurrency_group=group,
            )
        refs = cw.submit_actor_from_template(tmpl, args, kwargs)
        if method._num_returns == 1:
            return refs[0]
        return refs

    def __getattr__(self, name):
        # Underscore attributes must miss normally (pickle/IPython probe
        # private hooks like _repr_html_, and duck-typed hasattr checks rely
        # on AttributeError). Exception: the "_rt_" prefix is this framework's
        # convention for internal remote methods (e.g. _rt_init_collective).
        if name.startswith("_") and not name.startswith("_rt_"):
            raise AttributeError(name)
        method = ActorMethod(
            self, name, num_returns=self._methods.get(name, 1),
            concurrency_group=self._method_groups.get(name),
        )
        # memoize on the instance: later `handle.<name>` lookups hit the
        # instance dict directly (no __getattr__, no fresh ActorMethod per
        # call) and reuse the method's cached submit template. __reduce__
        # rebuilds handles from ids, so the cache never rides a pickle.
        self.__dict__[name] = method
        return method

    def __repr__(self):
        return f"ActorHandle({ActorID(self._actor_id).hex()[:16]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._methods,
                              self._max_task_retries, self._method_groups,
                              self._concurrency_groups))

    def _actor_id_hex(self):
        return ActorID(self._actor_id).hex()


class ActorClass:
    """ray parity: python/ray/actor.py ActorClass (remote/options)."""

    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = options
        self.__name__ = cls.__name__

    def __call__(self, *a, **k):
        raise TypeError(
            f"Actor class '{self.__name__}' cannot be instantiated directly; "
            f"use '{self.__name__}.remote()'."
        )

    def options(self, **opts):
        _check_options(opts)
        return ActorClass(self._cls, {**self._options, **opts})

    def remote(self, *args, **kwargs):
        global_worker.check_connected()
        opts = self._options
        cw = global_worker.core_worker
        if opts.get("get_if_exists") and opts.get("name"):
            table = cw.get_actor_table(name=opts["name"], namespace=opts.get("namespace"))
            if table is not None:
                return ActorHandle(table["actor_id"],
                                   max_task_retries=opts.get("max_task_retries", 0))
        # Collect @ray_tpu_torch.method(num_returns=N) annotations for the handle.
        method_returns = {
            name: getattr(m, "__ray_num_returns__")
            for name, m in vars(self._cls).items()
            if callable(m) and hasattr(m, "__ray_num_returns__")
        }
        # @ray_tpu_torch.method(concurrency_group="io") annotations + the declared
        # groups (ray parity: concurrency_group_manager.h; groups are
        # enforced by per-group semaphores in executor.py).
        method_groups = {
            name: getattr(m, "__ray_concurrency_group__")
            for name, m in vars(self._cls).items()
            if callable(m) and hasattr(m, "__ray_concurrency_group__")
        }
        groups = dict(opts.get("concurrency_groups") or {})
        for gname, cap in groups.items():
            if not isinstance(cap, int) or cap < 1:
                raise ValueError(
                    f"concurrency_groups[{gname!r}] must be a positive int, "
                    f"got {cap!r}"
                )
        for mname, gname in method_groups.items():
            if gname not in groups:
                raise ValueError(
                    f"method {mname!r} declares concurrency_group {gname!r} "
                    f"but the actor only declares {sorted(groups)}"
                )
        actor_id = cw.create_actor(
            self._cls,
            args,
            kwargs,
            resources=_build_resources(opts, default_cpu=0.0),
            scheduling=_build_scheduling(opts),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=groups,
            lifetime=opts.get("lifetime"),
            name=opts.get("name"),
            namespace=opts.get("namespace"),
            runtime_env=_prepare_runtime_env(opts.get("runtime_env")),
        )
        return ActorHandle(actor_id, methods=method_returns,
                           max_task_retries=opts.get("max_task_retries", 0),
                           method_groups=method_groups,
                           concurrency_groups=groups)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)


# ---------------------------------------------------------------------------
# @remote decorator
# ---------------------------------------------------------------------------


def remote(*args, **kwargs):
    """ray parity: ray.remote (python/ray/_private/worker.py:2952)."""

    def decorate(target, opts):
        import inspect

        if inspect.isclass(target):
            return ActorClass(target, opts)
        if callable(target):
            return RemoteFunction(target, opts)
        raise TypeError("@remote can only decorate functions or classes")

    if len(args) == 1 and not kwargs and callable(args[0]):
        return decorate(args[0], {})
    if args:
        raise TypeError("@remote takes keyword arguments only, e.g. @remote(num_cpus=2)")
    _check_options(kwargs)
    return lambda target: decorate(target, kwargs)


def method(**opts):
    """ray parity: ray.method — annotate num_returns / concurrency_group
    on actor methods."""

    def decorator(m):
        m.__ray_num_returns__ = opts.get("num_returns", 1)
        if "concurrency_group" in opts:
            m.__ray_concurrency_group__ = opts["concurrency_group"]
        return m

    return decorator
