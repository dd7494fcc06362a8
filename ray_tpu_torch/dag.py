"""Lazy task DAG API (ray parity: python/ray/dag/ — .bind()/.execute()).

DAG nodes capture a remote callable plus bound args (which may themselves be
nodes); ``execute`` walks the graph depth-first, submitting each node and
threading ObjectRefs through as dependencies — the substrate for the Serve
deployment-graph DSL and the workflow engine.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class DAGNode:
    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve_inputs(self, cache):
        args = [
            a.execute(_cache=cache) if isinstance(a, DAGNode) else a
            for a in self._bound_args
        ]
        kwargs = {
            k: (v.execute(_cache=cache) if isinstance(v, DAGNode) else v)
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    def execute(self, *args, _cache=None):
        cache = _cache if _cache is not None else {}
        if args:
            for node in self._collect_input_nodes():
                node._value = args[0]
        if id(self) in cache:
            return cache[id(self)]
        result = self._execute_impl(cache)
        cache[id(self)] = result
        return result

    def _children(self):
        """Every DAGNode this node depends on (bound args + kwargs, plus
        a ClassMethodNode's target) — the single edge definition shared
        by all graph walkers."""
        children = list(self._bound_args) + list(self._bound_kwargs.values())
        if isinstance(self, ClassMethodNode) and isinstance(self._target, DAGNode):
            children.append(self._target)
        return [c for c in children if isinstance(c, DAGNode)]

    def _collect_input_nodes(self, seen=None):
        seen = seen if seen is not None else set()
        if id(self) in seen:
            return []
        seen.add(id(self))
        found = [self] if isinstance(self, InputNode) else []
        for child in self._children():
            found.extend(child._collect_input_nodes(seen))
        return found

    def _execute_impl(self, cache):
        raise NotImplementedError


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _execute_impl(self, cache):
        args, kwargs = self._resolve_inputs(cache)
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._cls = actor_cls

    def _execute_impl(self, cache):
        args, kwargs = self._resolve_inputs(cache)
        return self._cls.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, handle_or_node, method_name, args, kwargs):
        super().__init__(args, kwargs)
        self._target = handle_or_node
        self._method = method_name

    def _execute_impl(self, cache):
        target = self._target
        if isinstance(target, DAGNode):
            target = target.execute(_cache=cache)
        args, kwargs = self._resolve_inputs(cache)
        return getattr(target, self._method).remote(*args, **kwargs)


class InputNode(DAGNode):
    """Placeholder for the DAG's runtime input (ray: dag/input_node.py)."""

    def __init__(self):
        super().__init__((), {})
        self._value = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, cache):
        return self._value


class _DagRunner:
    """Cluster-side orchestrator for a compiled DAG: holds the graph and
    drives every node from INSIDE the cluster, so one driver RPC covers
    the whole execution."""

    def __init__(self, blob: bytes):
        import cloudpickle

        self._dag = cloudpickle.loads(blob)

    def run(self, input_value):
        import ray_tpu_torch

        ref = self._dag.execute(input_value)
        # resolve in-cluster: the caller gets the VALUE back through this
        # actor's single return instead of a second fetch round trip
        return ray_tpu_torch.get(ref)


class CompiledDAG:
    """Repeated-execution form of a DAG (ray parity: the accelerated /
    compiled DAG of python/ray/dag — ``experimental_compile()``).

    ``DAGNode.execute`` walks the graph on the DRIVER: k nodes cost k
    submission round trips per call. Compiling ships the graph ONCE to a
    ``_DagRunner`` actor; each ``execute`` is then a single actor call
    and the internal hops ride the cluster's direct actor transport.
    Worth it for small graphs called many times (inference chains,
    per-step pipelines)."""

    def __init__(self, runner):
        self._runner = runner

    def execute(self, input_value=None):
        """Returns an ObjectRef of the DAG's final result value."""
        return self._runner.run.remote(input_value)

    def teardown(self):
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(self._runner)
        except Exception:
            pass


def _check_compilable(node: DAGNode, seen: Optional[set] = None):
    seen = seen if seen is not None else set()
    if id(node) in seen:
        return
    seen.add(id(node))
    if isinstance(node, ClassNode):
        raise ValueError(
            "compiled DAGs require pre-created actors: call "
            ".remote() and bind methods on the HANDLE, not on the class "
            "(matching the reference's compiled-graph restriction)"
        )
    for child in node._children():
        _check_compilable(child, seen)


def experimental_compile(dag: DAGNode, *, num_cpus: float = 0.1
                         ) -> CompiledDAG:
    """Compile a DAG for repeated low-overhead execution (see
    CompiledDAG). The graph must be static: actors already created,
    functions/args picklable."""
    import cloudpickle

    import ray_tpu_torch

    _check_compilable(dag)
    runner_cls = ray_tpu_torch.remote(num_cpus=num_cpus)(_DagRunner)
    runner = runner_cls.remote(cloudpickle.dumps(dag))
    return CompiledDAG(runner)
