"""Streaming executor: runs a logical plan as pipelined stages of remote
tasks over the cluster.

Each stage is a pull-based generator of ``(block_ref, BlockMetadata)``:
map stages keep a bounded window of in-flight tasks per stage (backpressure)
and yield results as tasks finish, so downstream stages start before
upstream ones drain — the behavior of the reference's StreamingExecutor
(ray python/ray/data/_internal/execution/streaming_executor.py:49,
streaming_executor_state.py) without its standalone control thread: the
consumer's own pull drives scheduling.

All-to-all stages (shuffle/sort/repartition/groupby) are barriers, as in the
reference's exchange ops (_internal/planner/exchange/).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata, concat_blocks
from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data._internal.stats import ExecStats, OpStats

logger = logging.getLogger(__name__)

RefBundle = Tuple[Any, BlockMetadata]  # (ObjectRef[Block], meta)


class ExecutionOptions:
    def __init__(self, max_in_flight: Optional[int] = None,
                 preserve_order: Optional[bool] = None,
                 resources: Optional[dict] = None,
                 op_memory_budget: Optional[int] = None):
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        self.max_in_flight = max_in_flight if max_in_flight is not None \
            else ctx.max_in_flight_tasks
        self.preserve_order = preserve_order if preserve_order is not None \
            else ctx.preserve_order
        self.resources = resources or {}
        self.op_memory_budget = op_memory_budget if op_memory_budget \
            is not None else ctx.op_memory_budget
        self.block_size_seed = ctx.target_max_block_size


# ----------------------------------------------------------------------
# remote task bodies (stateless; shipped per call)
# ----------------------------------------------------------------------

def _run_read_task(read_task) -> tuple:
    block = read_task()
    if not isinstance(block, Block):
        from ray_tpu_torch.data.block import _to_table

        block = _to_table(block)
    return block, BlockMetadata.for_block(block)


def _run_block_fn(fn, block: Block) -> tuple:
    out = fn(block)
    return out, BlockMetadata.for_block(out)


class _MapWorker:
    """Actor-pool worker hosting a stateful transform (ray parity:
    ActorPoolMapOperator's _MapWorker)."""

    def __init__(self, fn_factory):
        self._fn = fn_factory()

    def apply(self, block: Block) -> tuple:
        out = self._fn(block)
        return out, BlockMetadata.for_block(out)


# ----------------------------------------------------------------------
# stage iterators
# ----------------------------------------------------------------------

def _windowed(task_iter: Iterator[Callable[[], List[Any]]],
              opts: ExecutionOptions,
              stats: Optional[OpStats] = None,
              window: Optional[int] = None) -> Iterator[RefBundle]:
    """Submit thunks from ``task_iter`` under DOUBLE backpressure: at most
    ``window`` tasks in flight AND an estimated in-flight output-byte
    budget (ray parity: streaming_executor_state.py:100,376 — per-operator
    memory budgets, not just task counts). Output size is estimated from
    the running mean of this operator's completed blocks (seeded with
    target_max_block_size); at least one task is always admitted so a
    single huge block still flows."""
    import time as _time

    import ray_tpu_torch

    window = window or opts.max_in_flight
    budget = opts.op_memory_budget
    avg_bytes = float(opts.block_size_seed)
    done_count = 0
    bp_started: Optional[float] = None
    in_flight: List[Tuple[Any, Any]] = []  # (meta_ref, block_ref)
    exhausted = False
    while in_flight or not exhausted:
        while not exhausted and len(in_flight) < window:
            if in_flight and avg_bytes * (len(in_flight) + 1) > budget:
                # over the memory budget: drain one completion first
                if bp_started is None:
                    bp_started = _time.perf_counter()
                break
            try:
                thunk = next(task_iter)
            except StopIteration:
                exhausted = True
                break
            block_ref, meta_ref = thunk()
            in_flight.append((meta_ref, block_ref))
            if stats is not None:
                stats.peak_inflight_tasks = max(
                    stats.peak_inflight_tasks, len(in_flight)
                )
        if not in_flight:
            break
        if opts.preserve_order:
            meta_ref, block_ref = in_flight.pop(0)
            meta = ray_tpu_torch.get(meta_ref)
        else:
            ready, _ = ray_tpu_torch.wait(
                [m for m, _ in in_flight], num_returns=1, timeout=None
            )
            idx = next(i for i, (m, _) in enumerate(in_flight) if m in ready)
            meta_ref, block_ref = in_flight.pop(idx)
            meta = ray_tpu_torch.get(meta_ref)
        if bp_started is not None:
            if stats is not None:
                stats.backpressure_s += _time.perf_counter() - bp_started
            bp_started = None
        if stats is not None:
            stats.record_output(meta)
        # refine the per-task output estimate with the observed mean
        done_count += 1
        size = meta.size_bytes or 0
        avg_bytes += (size - avg_bytes) / done_count
        yield block_ref, meta


def _read_stage(op: L.Read, opts: ExecutionOptions,
                stats: Optional[OpStats] = None) -> Iterator[RefBundle]:
    import ray_tpu_torch

    read_remote = ray_tpu_torch.remote(num_returns=2)(_run_read_task)

    def thunks():
        for rt in op.read_tasks:
            yield lambda rt=rt: read_remote.remote(rt)

    return _windowed(thunks(), opts, stats=stats)


def _map_stage(op: L.MapBlocks, upstream: Iterator[RefBundle],
               opts: ExecutionOptions,
               stats: Optional[OpStats] = None) -> Iterator[RefBundle]:
    import ray_tpu_torch

    if op.compute is None:
        res = dict(op.resources)
        num_cpus = res.pop("CPU", 1.0)
        map_remote = ray_tpu_torch.remote(
            num_returns=2, num_cpus=num_cpus, **({"resources": res} if res else {})
        )(_run_block_fn)
        fn = op.block_fn

        def thunks():
            for block_ref, _meta in upstream:
                yield lambda b=block_ref: map_remote.remote(fn, b)

        return _windowed(thunks(), opts, stats=stats)

    # actor pool
    _, pool_size = op.compute
    res = dict(op.resources)
    num_cpus = res.pop("CPU", 1.0)
    worker_cls = ray_tpu_torch.remote(
        num_cpus=num_cpus, **({"resources": res} if res else {})
    )(_MapWorker)
    actors = [worker_cls.remote(op.block_fn) for _ in range(pool_size)]
    rr = [0]

    def thunks():
        try:
            for block_ref, _meta in upstream:
                def call(b=block_ref):
                    a = actors[rr[0] % len(actors)]
                    rr[0] += 1
                    ref = a.apply.options(num_returns=2).remote(b)
                    return ref
                yield call
        finally:
            pass

    def run():
        try:
            yield from _windowed(
                thunks(), opts, stats=stats,
                window=max(opts.max_in_flight, pool_size),
            )
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    return run()


def _limit_stage(op: L.Limit, upstream: Iterator[RefBundle]) -> Iterator[RefBundle]:
    import ray_tpu_torch

    remaining = op.limit
    for block_ref, meta in upstream:
        if remaining <= 0:
            break
        if meta.num_rows <= remaining:
            remaining -= meta.num_rows
            yield block_ref, meta
        else:
            sliced = BlockAccessor(ray_tpu_torch.get(block_ref)).slice(0, remaining)
            remaining = 0
            yield ray_tpu_torch.put(sliced), BlockMetadata.for_block(sliced)
            break


def _zip_stage(left: List[RefBundle], right: List[RefBundle]) -> Iterator[RefBundle]:
    """Align two materialized sides row-for-row and concat columns."""
    import ray_tpu_torch

    def _zip_slices(l_blocks, r_blocks, n_rows):
        import ray_tpu_torch
        from ray_tpu_torch.data.block import Table

        # refs arrive nested inside lists: resolve them in-task
        lt = concat_blocks(ray_tpu_torch.get(list(l_blocks)))
        rt = concat_blocks(ray_tpu_torch.get(list(r_blocks)))
        lt, rt = lt.slice(0, n_rows), rt.slice(0, n_rows)
        cols = {c: lt.column(c) for c in lt.column_names}
        for c in rt.column_names:
            name = c if c not in cols else f"{c}_1"
            cols[name] = rt.column(c)
        out = Table(cols)
        return out, BlockMetadata.for_block(out)

    zip_remote = ray_tpu_torch.remote(num_returns=2)(_zip_slices)
    n = min(sum(m.num_rows for _, m in left), sum(m.num_rows for _, m in right))
    # v1: one task zips everything; fine for moderate datasets, and the
    # all-to-all barrier semantics match the reference.
    block_ref, meta_ref = zip_remote.remote(
        [r for r, _ in left], [r for r, _ in right], n
    )
    yield block_ref, ray_tpu_torch.get(meta_ref)


# ----------------------------------------------------------------------
# all-to-all helpers (used by Dataset to build AllToAll ops)
# ----------------------------------------------------------------------

def shuffle_exchange(bundles: List[RefBundle], n_out: int,
                     partition_fn: Callable[[Block, int], List[Block]],
                     reduce_fn: Optional[Callable[[List[Block]], Block]] = None,
                     ) -> List[RefBundle]:
    """Generic 2-stage map/reduce exchange (ray parity: exchange/
    shuffle_task_scheduler). partition_fn splits one block into n_out parts;
    reduce_fn (default concat) merges part i of every map output."""
    import ray_tpu_torch

    if not bundles:
        return []

    def _map(block, n):
        parts = partition_fn(block, n)
        assert len(parts) == n, (len(parts), n)
        return tuple(parts) if n > 1 else parts[0]

    def _reduce(*parts):
        block = (reduce_fn or concat_blocks)(list(parts))
        return block, BlockMetadata.for_block(block)

    map_remote = ray_tpu_torch.remote(num_returns=n_out)(_map)
    red_remote = ray_tpu_torch.remote(num_returns=2)(_reduce)

    map_out = [map_remote.remote(ref, n_out) for ref, _ in bundles]
    if n_out == 1:
        cols = [[r] for r in map_out]
    else:
        cols = [[row[i] for row in map_out] for i in range(n_out)]
    out: List[RefBundle] = []
    pending = []
    for col in cols:
        block_ref, meta_ref = red_remote.remote(*col)
        pending.append((block_ref, meta_ref))
    for block_ref, meta_ref in pending:
        out.append((block_ref, ray_tpu_torch.get(meta_ref)))
    return out


# ----------------------------------------------------------------------
# plan execution
# ----------------------------------------------------------------------

def execute_streaming(plan: L.LogicalPlan,
                      opts: Optional[ExecutionOptions] = None,
                      stats: Optional[ExecStats] = None
                      ) -> Iterator[RefBundle]:
    """Yield output (block_ref, meta) pairs of the optimized plan; fill
    ``stats`` (one OpStats per operator) while running."""
    opts = opts or ExecutionOptions()
    out = _exec_op(plan.optimized().dag, opts, stats)

    if stats is None:
        return out

    def finalize():
        try:
            for bundle in out:
                stats.record_yield(bundle[1])
                yield bundle
        finally:
            stats.finalize()

    return finalize()


def execute(plan: L.LogicalPlan,
            opts: Optional[ExecutionOptions] = None,
            stats: Optional[ExecStats] = None) -> List[RefBundle]:
    return list(execute_streaming(plan, opts, stats))


def _stat(stats: Optional[ExecStats], name: str) -> Optional[OpStats]:
    if stats is None:
        return None
    st = stats.op(name)
    st.start()
    return st


def _exec_op(op: L.LogicalOp, opts: ExecutionOptions,
             stats: Optional[ExecStats] = None) -> Iterator[RefBundle]:
    if isinstance(op, L.InputData):
        return iter(list(zip(op.refs, op.metas)))
    if isinstance(op, L.Read):
        return _read_stage(op, opts, _stat(stats, op.name))
    if isinstance(op, L.MapBlocks):
        return _map_stage(
            op, _exec_op(op.inputs[0], opts, stats), opts,
            _stat(stats, op.name),
        )
    if isinstance(op, L.Limit):
        return _limit_stage(op, _exec_op(op.inputs[0], opts, stats))
    if isinstance(op, L.AllToAll):
        bundles = list(_exec_op(op.inputs[0], opts, stats))
        st = _stat(stats, op.name)
        out = op.fn(bundles)
        if st is not None:
            for _, meta in out:
                st.record_output(meta)
            st.finish()
        return iter(out)
    if isinstance(op, L.Union):
        def chain():
            for child in op.inputs:
                yield from _exec_op(child, opts, stats)
        return chain()
    if isinstance(op, L.Zip):
        left = list(_exec_op(op.inputs[0], opts, stats))
        right = list(_exec_op(op.inputs[1], opts, stats))
        return _zip_stage(left, right)
    raise TypeError(f"unknown logical op {op!r}")
