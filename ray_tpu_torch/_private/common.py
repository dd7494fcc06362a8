"""Shared runtime data structures: task/actor specs, resources, policies.

TaskSpec mirrors the reference's TaskSpecification
(ray: src/ray/common/task/task_spec.h) — everything a raylet needs to
schedule and a worker needs to execute. Resource maps are plain
``{name: float}`` dicts with 4-decimal fixed-point semantics
(ray: src/ray/common/scheduling/fixed_point.h). Scheduling policies mirror
ray: src/ray/raylet/scheduling/policy/ (hybrid pack/spread, spread,
node-affinity, placement-group bundle PACK/SPREAD/STRICT_*).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

RESOURCE_QUANT = 1e-4  # 4-decimal fixed point


def quantize(v: float) -> float:
    return round(v / RESOURCE_QUANT) * RESOURCE_QUANT


def res_fits(demand: Dict[str, float], available: Dict[str, float]) -> bool:
    for k, v in demand.items():
        if v > available.get(k, 0.0) + RESOURCE_QUANT / 2:
            return False
    return True


def res_sub(avail: Dict[str, float], demand: Dict[str, float]):
    for k, v in demand.items():
        avail[k] = quantize(avail.get(k, 0.0) - v)


def res_add(avail: Dict[str, float], demand: Dict[str, float]):
    for k, v in demand.items():
        avail[k] = quantize(avail.get(k, 0.0) + v)


# Placement-group bundle resources are expressed as renamed resources on the
# hosting node, like the reference's formatted resources
# (ray: src/ray/common/placement_group.h FormatPlacementGroupResource).
def pg_resource_name(base: str, pg_id_hex: str, bundle_index: Optional[int]) -> str:
    if bundle_index is None:
        return f"{base}_group_{pg_id_hex}"
    return f"{base}_group_{bundle_index}_{pg_id_hex}"


def rewrite_resources_for_pg(
    resources: Dict[str, float], pg_id_hex: str, bundle_index: Optional[int]
) -> Dict[str, float]:
    out = {}
    for k, v in resources.items():
        out[pg_resource_name(k, pg_id_hex, bundle_index)] = v
        if bundle_index is not None:
            out[pg_resource_name(k, pg_id_hex, None)] = v
    return out


@dataclass
class SchedulingStrategy:
    """DEFAULT | SPREAD | node affinity | node label | placement group."""

    kind: str = "DEFAULT"
    node_id: Optional[str] = None  # NodeAffinity
    soft: bool = False
    pg_id: Optional[str] = None  # PlacementGroup
    pg_bundle_index: Optional[int] = None
    pg_capture_child_tasks: bool = False
    # NodeLabel (ray: node_label_scheduling_policy.h:25): {key: cond} where
    # cond is a str (equals), "!v" (not equals), a list (in), None (exists).
    labels_hard: Optional[Dict[str, Any]] = None
    labels_soft: Optional[Dict[str, Any]] = None


@dataclass
class TaskSpec:
    task_id: bytes
    job_id: bytes
    name: str
    # Function payload: cloudpickled callable, or (actor) method name.
    func_blob: Optional[bytes]
    method_name: Optional[str]
    # Args: list of ("v", serialized bytes) inline values or ("r", id_bytes,
    # owner) object refs; kwargs same encoding by key.
    args: List[Tuple] = field(default_factory=list)
    kwargs: Dict[str, Tuple] = field(default_factory=dict)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    owner: Optional[tuple] = None  # (node_id_hex, client_id_hex)
    max_retries: int = 3
    retry_exceptions: bool = False
    # Actor fields
    actor_id: Optional[bytes] = None  # set for actor tasks
    actor_creation: bool = False
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    # Which declared concurrency group this actor task runs under (None =
    # the default group, capped by max_concurrency). ray parity:
    # src/ray/core_worker/transport/concurrency_group_manager.h
    concurrency_group: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    name_registered: Optional[str] = None  # named actor
    namespace: Optional[str] = None
    runtime_env: Optional[dict] = None
    seq_no: int = 0  # per-caller actor-task ordering
    caller_id: Optional[bytes] = None
    attempt: int = 0
    # Times this task was re-executed to recover a lost return object
    # (ray: object_recovery_manager.h lineage reconstruction budget).
    reconstructions: int = 0
    submit_time: float = field(default_factory=time.time)
    # Propagated tracing context {trace_id, span_id} (ray:
    # tracing_helper.py:105-226 injects span context into task calls).
    tracing_ctx: Optional[dict] = None
    # Node that last spilled this task to its current location; that node
    # tracks the task and resubmits it if the executing node dies
    # (plays the reference's owner-side lease-failure retry role for the
    # fire-and-forget spillback flow).
    origin_node: Optional[str] = None

    def scheduling_class(self) -> tuple:
        return (tuple(sorted(self.resources.items())), self.name)


@dataclass
class NodeInfo:
    node_id: str  # hex
    host: str
    port: int  # raylet rpc port
    store_dir: str
    resources_total: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    # Dynamic view (updated by heartbeats):
    resources_available: Dict[str, float] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    # Autoscaler inputs (ray: monitor.proto ResourceLoad):
    pending_demand: list = field(default_factory=list)
    idle: bool = False
    idle_since: float = 0.0


# ---------------------------------------------------------------------------
# Scheduling policies (cluster-level node selection).
# ---------------------------------------------------------------------------


def _score(node: NodeInfo, demand: Dict[str, float]) -> float:
    """Least-resource scorer: lower = more utilized after placing.

    Mirrors LeastResourceScorer (ray: src/ray/raylet/scheduling/policy/scorer.h:41):
    score each resource by remaining fraction, prefer nodes that stay balanced.
    """
    scores = []
    for k, total in node.resources_total.items():
        if total <= 0:
            continue
        avail = node.resources_available.get(k, 0.0) - demand.get(k, 0.0)
        scores.append(max(avail, 0.0) / total)
    return sum(scores) / len(scores) if scores else 0.0


def pick_node_hybrid(
    nodes: List[NodeInfo],
    demand: Dict[str, float],
    local_node_id: Optional[str],
    spread_threshold: float = 0.5,
) -> Optional[str]:
    """Hybrid pack/spread (ray: hybrid_scheduling_policy.h:50): prefer the
    local node, then pack onto nodes below the critical-utilization threshold
    in traversal order, else pick the least-utilized feasible node."""
    feasible = [n for n in nodes if n.alive and res_fits(demand, _total(n))]
    if not feasible:
        return None
    ordered = sorted(feasible, key=lambda n: (n.node_id != local_node_id, n.node_id))
    best, best_score = None, -1.0
    for n in ordered:
        if not res_fits(demand, n.resources_available):
            continue
        util = 1.0 - _score(n, {})
        if util <= spread_threshold:
            return n.node_id
        sc = _score(n, demand)
        if sc > best_score:
            best, best_score = n.node_id, sc
    return best


def pick_node_spread(
    nodes: List[NodeInfo], demand: Dict[str, float], rr_state: List[int]
) -> Optional[str]:
    """Round-robin over available nodes (ray: spread_scheduling_policy.h:27)."""
    feasible = sorted(
        (n for n in nodes if n.alive and res_fits(demand, n.resources_available)),
        key=lambda n: n.node_id,
    )
    if not feasible:
        feasible = sorted(
            (n for n in nodes if n.alive and res_fits(demand, _total(n))),
            key=lambda n: n.node_id,
        )
    if not feasible:
        return None
    rr_state[0] = (rr_state[0] + 1) % len(feasible)
    return feasible[rr_state[0]].node_id


def _total(n: NodeInfo) -> Dict[str, float]:
    return n.resources_total


def _label_match(labels: Dict[str, str], selector: Optional[Dict[str, Any]]) -> bool:
    """Evaluate a label selector: str = equals, "!v" = not-equals, list =
    in, None = exists (ray: node_label_scheduling_policy.h In/NotIn/Exists).

    Label values are strings by construction; conditions are coerced to
    str so e.g. hard={"slice": [1, 2]} matches a node labeled "1"."""
    if not selector:
        return True
    for k, cond in selector.items():
        v = labels.get(k)
        if cond is None:
            if v is None:
                return False
        elif isinstance(cond, (list, tuple, set)):
            if v is None or v not in {str(c) for c in cond}:
                return False
        elif isinstance(cond, str) and cond.startswith("!"):
            if v == cond[1:]:
                return False
        else:
            if v != str(cond):
                return False
    return True


def pick_node_labels(
    nodes: List[NodeInfo],
    demand: Dict[str, float],
    hard: Optional[Dict[str, Any]],
    soft: Optional[Dict[str, Any]],
) -> Optional[str]:
    """Node-label policy (ray: node_label_scheduling_policy.h:25): hard
    selector filters; prefer soft-matching nodes with available capacity,
    then any available, then any feasible-by-total; least-utilized wins."""
    cands = [
        n for n in nodes
        if n.alive and _label_match(n.labels, hard)
        and res_fits(demand, n.resources_total)
    ]
    if not cands:
        return None
    avail = [n for n in cands if res_fits(demand, n.resources_available)]
    pref = [n for n in avail if _label_match(n.labels, soft)]
    pool = pref or avail or cands
    best, best_score = None, -2.0
    for n in sorted(pool, key=lambda n: n.node_id):
        sc = _score(n, demand)
        if sc > best_score:
            best, best_score = n.node_id, sc
    return best


def pick_node_py(
    nodes: List[NodeInfo],
    spec_resources: Dict[str, float],
    strategy: SchedulingStrategy,
    local_node_id: Optional[str],
    rr_state: List[int],
    spread_threshold: float = 0.5,
) -> Optional[str]:
    """Pure-Python policy dispatch — the oracle the native engine must match."""
    if strategy.kind == "NODE_AFFINITY":
        for n in nodes:
            if n.node_id == strategy.node_id and n.alive:
                if res_fits(spec_resources, n.resources_total):
                    return n.node_id
        if strategy.soft:
            return pick_node_hybrid(nodes, spec_resources, local_node_id, spread_threshold)
        return None
    if strategy.kind == "NODE_LABEL":
        return pick_node_labels(
            nodes, spec_resources, strategy.labels_hard, strategy.labels_soft
        )
    if strategy.kind == "SPREAD":
        return pick_node_spread(nodes, spec_resources, rr_state)
    return pick_node_hybrid(nodes, spec_resources, local_node_id, spread_threshold)


def pick_node(
    nodes: List[NodeInfo],
    spec_resources: Dict[str, float],
    strategy: SchedulingStrategy,
    local_node_id: Optional[str],
    rr_state: List[int],
    spread_threshold: float = 0.5,
) -> Optional[str]:
    from ray_tpu_torch._private import native_sched

    if native_sched.available() and native_sched.encodable(
        nodes, spec_resources, strategy
    ):
        return native_sched.pick_node(
            nodes, spec_resources, strategy, local_node_id, rr_state,
            spread_threshold,
        )
    return pick_node_py(
        nodes, spec_resources, strategy, local_node_id, rr_state,
        spread_threshold,
    )


# ---------------------------------------------------------------------------
# Placement-group bundle placement (ray: policy/bundle_scheduling_policy.h:82-106)
# ---------------------------------------------------------------------------


def place_bundles(
    nodes: List[NodeInfo], bundles: List[Dict[str, float]], strategy: str,
    topology=None, committed_rings=None, max_candidates=None,
) -> Optional[List[str]]:
    """Return node_id per bundle, or None if infeasible.

    ``topology``/``committed_rings`` (topology.py) thread the contention
    scorer through this wrapper: when the cluster advertises torus
    coordinates, candidates are torus-aligned contiguous slices scored
    by ring overlap against already-committed gangs. Topology-less
    clusters (the default: topology=None, or no coords advertised) take
    the resource-fit path below — native engine or Python oracle —
    byte-identical to before the scorer existed."""
    if topology is not None:
        from ray_tpu_torch._private import topology as topo_mod

        if max_candidates is None:
            # live clusters take the config knob; schedsim passes its
            # SimSpec value explicitly so a trace's byte-identity never
            # depends on ambient process config
            from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

            max_candidates = cfg.sched_max_candidates
        scored = topo_mod.place_bundles_topo(
            nodes, bundles, strategy, topology, committed_rings or {},
            max_candidates=max_candidates,
        )
        return None if scored is None else scored[0]
    from ray_tpu_torch._private import native_sched

    if native_sched.available() and native_sched.encodable(
        nodes, {}, bundles=bundles
    ):
        return native_sched.place_bundles(nodes, bundles, strategy)
    return place_bundles_py(nodes, bundles, strategy)


def place_bundles_py(
    nodes: List[NodeInfo], bundles: List[Dict[str, float]], strategy: str
) -> Optional[List[str]]:
    """Pure-Python bundle placement — the oracle the native engine must match."""
    alive = [n for n in nodes if n.alive]
    avail = {n.node_id: dict(n.resources_available) for n in alive}

    def fits_and_take(nid, b):
        if res_fits(b, avail[nid]):
            res_sub(avail[nid], b)
            return True
        return False

    placement: List[Optional[str]] = [None] * len(bundles)
    order = sorted(range(len(bundles)), key=lambda i: -sum(bundles[i].values()))
    if strategy == "STRICT_PACK":
        for n in alive:
            tmp = dict(avail[n.node_id])
            ok = True
            for b in bundles:
                if res_fits(b, tmp):
                    res_sub(tmp, b)
                else:
                    ok = False
                    break
            if ok:
                return [n.node_id] * len(bundles)
        return None
    if strategy == "STRICT_SPREAD":
        used = set()
        for i in order:
            placed = False
            for n in sorted(alive, key=lambda n: n.node_id):
                if n.node_id in used:
                    continue
                if fits_and_take(n.node_id, bundles[i]):
                    placement[i] = n.node_id
                    used.add(n.node_id)
                    placed = True
                    break
            if not placed:
                return None
        return placement  # type: ignore[return-value]
    # PACK: prefer fewest nodes; SPREAD: prefer distinct nodes but allow reuse.
    prefer_distinct = strategy == "SPREAD"
    used: set = set()
    for i in order:
        candidates = sorted(alive, key=lambda n: ((n.node_id in used) == prefer_distinct, n.node_id))
        placed = False
        for n in candidates:
            if fits_and_take(n.node_id, bundles[i]):
                placement[i] = n.node_id
                used.add(n.node_id)
                placed = True
                break
        if not placed:
            return None
    return placement  # type: ignore[return-value]
