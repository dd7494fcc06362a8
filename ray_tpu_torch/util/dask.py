"""Dask-on-ray_tpu_torch scheduler shim.

ray parity: python/ray/util/dask (ray_dask_get) — a dask *scheduler*: it
executes a dask task graph by turning every graph task into a ray_tpu_torch
task, with inter-task edges as ObjectRefs so intermediates never
round-trip through the driver. The graph format is plain data (dicts and
``(callable, *args)`` tuples), so the scheduler needs no dask import —
pass it to ``dask.compute(..., scheduler=ray_dask_get)`` when dask is
installed, or feed it hand-built graphs.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List


def _is_task(x) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _execute_task(fn, args):
    # refs nested inside the args list arrive as ObjectRefs (only
    # top-level task args auto-materialize); resolve them here so the
    # user callable sees plain values
    import ray_tpu_torch

    def mat(a):
        if isinstance(a, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(a)
        if isinstance(a, list):
            return [mat(i) for i in a]
        if isinstance(a, tuple):
            return tuple(mat(i) for i in a)
        return a

    return fn(*[mat(a) for a in args])


def _materialize_refs(v):
    """ObjectRefs (possibly nested in containers) -> values, driver-side."""
    import ray_tpu_torch

    if isinstance(v, ray_tpu_torch.ObjectRef):
        return ray_tpu_torch.get(v)
    if isinstance(v, list):
        return [_materialize_refs(i) for i in v]
    if isinstance(v, tuple):
        return tuple(_materialize_refs(i) for i in v)
    return v


def _resolve_arg(arg, futures: Dict[Hashable, Any], dsk: Dict):
    """Replace graph keys with their (possibly remote) results; recurse
    through lists/tuples the way dask's local scheduler does."""
    if isinstance(arg, list):
        return [_resolve_arg(a, futures, dsk) for a in arg]
    if _is_task(arg):
        # nested task: runs inline driver-side, so its key-args must be
        # VALUES here, not ObjectRefs
        fn, *rest = arg
        return fn(*[
            _materialize_refs(_resolve_arg(a, futures, dsk)) for a in rest
        ])
    if isinstance(arg, tuple):
        return tuple(_resolve_arg(a, futures, dsk) for a in arg)
    try:
        if arg in futures:
            return futures[arg]
    except TypeError:
        return arg  # unhashable literal
    return arg


def _toposort(dsk: Dict) -> List:
    """Dependency-ordered keys (dask.order is an optimization, not a
    correctness requirement)."""
    seen: set = set()
    out: List = []

    def deps_of(v, acc):
        if isinstance(v, (list, tuple)):
            if _is_task(v):
                v = v[1:]
            for item in v:
                deps_of(item, acc)
            return
        try:
            if v in dsk:
                acc.append(v)
        except TypeError:
            pass

    def visit(key, stack):
        if key in seen:
            return
        if key in stack:
            raise ValueError(f"cycle in dask graph at {key!r}")
        stack.add(key)
        acc: List = []
        deps_of(dsk[key], acc)
        for d in acc:
            visit(d, stack)
        stack.discard(key)
        seen.add(key)
        out.append(key)

    for key in dsk:
        visit(key, set())
    return out


def ray_dask_get(dsk: Dict, keys, **_kwargs):
    """Execute a dask graph on the cluster; returns materialized values
    in the shape of ``keys`` (ray parity: ray.util.dask.ray_dask_get).

    Every graph task becomes one ray_tpu_torch task; arguments that are graph
    keys are passed as ObjectRefs and materialize worker-side, so chains
    and fan-ins transfer directly between workers."""
    import ray_tpu_torch

    task = ray_tpu_torch.remote(_execute_task)
    futures: Dict[Hashable, Any] = {}
    for key in _toposort(dsk):
        val = dsk[key]
        if _is_task(val):
            fn, *args = val
            args = [_resolve_arg(a, futures, dsk) for a in args]
            futures[key] = task.remote(fn, args)
        else:
            futures[key] = _resolve_arg(val, futures, dsk)

    def materialize(k):
        if isinstance(k, list):
            return [materialize(i) for i in k]
        v = futures.get(k, k) if isinstance(k, Hashable) else k
        # a non-task graph value may be a container holding refs
        # (e.g. {"b": ["a"]}): resolve refs wherever they sit
        return _materialize_refs(v)

    if isinstance(keys, list):
        return [materialize(k) for k in keys]
    return materialize(keys)
