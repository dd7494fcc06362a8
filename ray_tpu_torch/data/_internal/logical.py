"""Logical plan: lazy operator DAG a Dataset accumulates, optimized (map
fusion) before physical planning.

Reference parity: ray python/ray/data/_internal/logical/interfaces/
{logical_operator,logical_plan,optimizer}.py and rules/operator_fusion.py —
collapsed to the handful of node types the executor distinguishes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


class LogicalOp:
    """Base node. ``inputs`` are upstream ops (linear chains mostly)."""

    def __init__(self, name: str, inputs: List["LogicalOp"]):
        self.name = name
        self.inputs = inputs

    def __repr__(self):
        return f"{self.name}({', '.join(repr(i) for i in self.inputs)})"


class Read(LogicalOp):
    def __init__(self, read_tasks: List[Callable], parallelism: int):
        super().__init__("Read", [])
        self.read_tasks = read_tasks
        self.parallelism = parallelism


class InputData(LogicalOp):
    """Pre-existing block refs (from_blocks / materialized datasets)."""

    def __init__(self, refs: List[Any], metas: List[Any]):
        super().__init__("InputData", [])
        self.refs = refs
        self.metas = metas


class MapBlocks(LogicalOp):
    """One block-level transform: fn(Block) -> Block.

    ``compute`` is None (stateless tasks) or ("actors", n) for an actor pool
    running a stateful callable class. ``fn_factory`` builds the transform —
    for actor compute it constructs the user class once per actor.
    """

    def __init__(self, name: str, input_op: LogicalOp,
                 block_fn: Callable, compute: Optional[tuple] = None,
                 resources: Optional[dict] = None):
        super().__init__(name, [input_op])
        self.block_fn = block_fn
        self.compute = compute
        self.resources = resources or {}


class AllToAll(LogicalOp):
    """Barrier op: fn(refs, metas, ctx) -> (refs, metas)."""

    def __init__(self, name: str, input_op: LogicalOp, fn: Callable,
                 sub_progress: Optional[List[str]] = None):
        super().__init__(name, [input_op])
        self.fn = fn


class Limit(LogicalOp):
    def __init__(self, input_op: LogicalOp, limit: int):
        super().__init__("Limit", [input_op])
        self.limit = limit


class Union(LogicalOp):
    def __init__(self, inputs: List[LogicalOp]):
        super().__init__("Union", inputs)


class Zip(LogicalOp):
    def __init__(self, left: LogicalOp, right: LogicalOp):
        super().__init__("Zip", [left, right])


@dataclass
class LogicalPlan:
    dag: LogicalOp

    def optimized(self) -> "LogicalPlan":
        return LogicalPlan(_fuse(self.dag))


def _fuse(op: LogicalOp) -> LogicalOp:
    """Fuse chains of stateless MapBlocks into one (operator fusion rule)."""
    op.inputs = [_fuse(i) for i in op.inputs]
    if (
        isinstance(op, MapBlocks)
        and op.compute is None
        and isinstance(op.inputs[0], MapBlocks)
        and op.inputs[0].compute is None
        and op.resources == op.inputs[0].resources
    ):
        inner = op.inputs[0]
        inner_fn, outer_fn = inner.block_fn, op.block_fn

        def fused(block, _a=inner_fn, _b=outer_fn):
            return _b(_a(block))

        fused_op = MapBlocks(
            f"{inner.name}->{op.name}", inner.inputs[0], fused,
            compute=None, resources=op.resources,
        )
        return _fuse(fused_op)
    return op
