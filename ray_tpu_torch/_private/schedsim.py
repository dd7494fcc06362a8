"""schedsim: deterministic discrete-event scheduler simulator.

Scheduling-policy changes need reproducible evidence at a scale no CI
box can boot for real. schedsim simulates 1k-10k raylets in ONE process
under a seeded virtual clock and drives the *same* placement-scoring
code paths the live GCS runs — ``common.place_bundles`` (native engine
or Python oracle) for the baseline policy, ``topology.place_bundles_topo``
+ ``topology.plan_repack`` for the contention policy — so a policy A/B
here is an A/B of the production scorer, not of a model of it.

Determinism contract: same ``SimSpec`` (seed + chaos spec included) ->
byte-identical event trace. Nothing reads the wall clock or an unseeded
RNG; every iteration over cluster state is sorted; chaos decisions come
from each rule's OWN seeded PRNG (faultsim.FaultRule semantics).

Chaos replay reuses faultsim's rule syntax (``pattern:kind:prob:seed
[:param]``), reinterpreted for cluster-level faults — the pattern
matches simulated node ids:

    kill      (``drop``)  the node dies at a seeded time; gangs holding
                          bundles there are requeued for re-placement
    delay     (``delay``) the node's heartbeats stall ``param`` ms at a
                          seeded time: it drops out of the scheduler's
                          placement view for the window (the GCS-side
                          effect of heartbeat delay), keeping its gangs

Virtual scheduling cost: each placement attempt occupies the (serial)
scheduler for ``base + per_node * alive_nodes + per_bundle * bundles``
virtual seconds. The constants are calibrated against the live
ready->dispatch placement-latency histogram
(``raylet_task_placement_latency_seconds`` — sub-ms attempts on
small clusters) and scale with cluster size the way the real view-scan
does; ``sched_cost_scale`` rescales them wholesale when re-calibrating
against a newer live histogram.

Reported per run: p50/p95/p99 placement latency, time-weighted cluster
utilization, aggregate ring-overlap contention (measured with the same
torus geometry for BOTH policies — the baseline ignores it when placing
but is scored by it, which is exactly the A/B), repack count, and the
sha256 of the trace (the determinism gate).
"""

from __future__ import annotations

import hashlib
import heapq
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import faultsim, topology
from ray_tpu_torch._private.common import NodeInfo, place_bundles, res_add, res_sub
from ray_tpu_torch._private.reqtrace import _pct  # one percentile definition

POLICIES = ("baseline", "contention")


@dataclass
class SimSpec:
    """One reproducible simulation run. Every field participates in the
    determinism contract — two equal specs produce identical traces."""

    nodes: int = 1000
    policy: str = "contention"
    seed: int = 0
    dims: Optional[Tuple[int, ...]] = None  # default: near-square 2D
    gangs: int = 0          # 0 -> nodes // 40
    gang_size: int = 8
    strategy: str = "STRICT_SPREAD"
    cpus_per_node: float = 4.0
    big_node_every: int = 16   # every Nth node gets 2x CPU (heterogeneity
                               # gives the repack pass real parking spots)
    arrival_rate: float = 50.0  # gang arrivals per virtual second
    hold_s: float = 30.0        # mean gang lifetime (exponential)
    start_delay_s: float = 1.0  # placed -> running window (bundles idle,
                                # i.e. migratable by the repack pass)
    chaos: str = ""             # faultsim rule syntax (see module doc)
    retry_s: float = 0.2        # gcs_schedule_retry_interval_s analog
    give_up_s: float = 30.0     # worker_lease_timeout analog
    # scheduler tunables SNAPSHOTTED here (not read from GLOBAL_CONFIG):
    # a trace's byte-identity must depend on the spec alone, never on
    # ambient RAY_TPU_TORCH_* env of the replaying process
    max_candidates: int = 32
    repack_max_moves: int = 8
    # virtual scheduler cost model (see module docstring)
    sched_base_s: float = 200e-6
    sched_per_node_s: float = 0.05e-6
    sched_per_bundle_s: float = 50e-6
    sched_cost_scale: float = 1.0

    def n_gangs(self) -> int:
        return self.gangs or max(4, self.nodes // 40)


@dataclass
class _Gang:
    gang_id: str
    bundles: List[Dict[str, float]]
    strategy: str
    arrival_t: float
    hold_s: float
    placement: Optional[List[str]] = None
    placed_t: Optional[float] = None
    running: bool = False
    attempts: int = 0
    requeues: int = 0


class _Trace:
    __slots__ = ("lines",)

    def __init__(self):
        self.lines: List[str] = []

    def emit(self, t: float, kind: str, **kv):
        parts = [f"{t:.6f}", kind]
        parts.extend(f"{k}={kv[k]}" for k in sorted(kv))
        self.lines.append(" ".join(parts))

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"

    def sha256(self) -> str:
        return hashlib.sha256(self.text().encode()).hexdigest()


class SchedSim:
    def __init__(self, spec: SimSpec):
        if spec.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.trace = _Trace()
        self.now = 0.0
        self._seq = 0
        self._events: list = []
        self.pending: List[_Gang] = []
        self.placed: Dict[str, _Gang] = {}
        self.sched_free_at = 0.0
        self.latencies: List[float] = []
        self.failed = 0
        self.repacks = 0
        self.contention_scores: List[float] = []
        self._rings: Dict[str, frozenset] = {}
        # nodes in an hb_delay window: invisible to NEW placement but not
        # dead — their gangs keep their capacity, departures during the
        # window still return it, and a kill landing mid-window still
        # kills (alive=False is reserved for real death)
        self._delayed: set = set()
        # utilization integral
        self._used_cpu = 0.0
        self._util_area = 0.0
        self._util_last_t = 0.0
        self._build_cluster()

    # -- cluster --------------------------------------------------------
    def _build_cluster(self):
        s = self.spec
        coords = topology.synthesize(s.nodes, s.dims)
        dims = tuple(max(c[d] for c in coords) + 1
                     for d in range(len(coords[0])))
        # cloud nodes join in arbitrary order: shuffle the id<->coord
        # assignment so node-id order (what resource-fit iterates in)
        # does not accidentally encode torus adjacency
        order = list(range(s.nodes))
        self.rng.shuffle(order)
        self.nodes: Dict[str, NodeInfo] = {}
        for i in range(s.nodes):
            cpu = s.cpus_per_node * (
                2.0 if s.big_node_every and i % s.big_node_every == 0
                else 1.0)
            nid = f"sim{i:05d}"
            c = coords[order[i]]
            self.nodes[nid] = NodeInfo(
                node_id=nid, host="sim", port=0, store_dir="",
                resources_total={"CPU": cpu},
                resources_available={"CPU": cpu},
                labels={
                    topology.COORD_LABEL: topology.format_coord(c),
                    topology.DIMS_LABEL: topology.format_coord(dims),
                },
            )
        self.total_cpu = sum(
            n.resources_total["CPU"] for n in self.nodes.values())
        self.topo = topology.Topology.from_nodes(
            sorted(self.nodes.values(), key=lambda n: n.node_id))

    # -- event plumbing -------------------------------------------------
    def _push(self, t: float, kind: str, payload=None):
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, payload))

    def _advance(self, t: float):
        self._util_area += self._used_cpu * (t - self._util_last_t)
        self._util_last_t = t
        self.now = t

    def _take(self, placement: List[str], bundles):
        for nid, b in zip(placement, bundles):
            res_sub(self.nodes[nid].resources_available, b)
            self._used_cpu += sum(b.values())

    def _release(self, placement: List[str], bundles):
        for nid, b in zip(placement, bundles):
            node = self.nodes.get(nid)
            if node is not None and node.alive:
                res_add(node.resources_available, b)
            self._used_cpu -= sum(b.values())

    # -- workload + chaos -----------------------------------------------
    def _schedule_workload(self):
        s = self.spec
        t = 0.0
        for i in range(s.n_gangs()):
            t += self.rng.expovariate(s.arrival_rate)
            gang = _Gang(
                gang_id=f"g{i:04d}",
                bundles=[{"CPU": s.cpus_per_node}] * s.gang_size,
                strategy=s.strategy,
                arrival_t=t,
                hold_s=self.rng.expovariate(1.0 / s.hold_s),
            )
            self._push(t, "arrive", gang)
        horizon = t + s.give_up_s
        for rule in faultsim.parse_spec(s.chaos):
            if rule.kind not in ("drop", "delay"):
                continue
            for nid in sorted(self.nodes):
                if not rule.fires(nid):
                    continue  # PRNG advances only on regex matches
                at = rule.rng.uniform(0.0, horizon)
                if rule.kind == "drop":
                    self._push(at, "kill", nid)
                else:
                    dur = (rule.param or 50.0) / 1e3
                    self._push(at, "hb_delay", (nid, dur))

    # -- placement ------------------------------------------------------
    def _attempt_cost(self, n_alive: int, n_bundles: int) -> float:
        s = self.spec
        return s.sched_cost_scale * (
            s.sched_base_s + s.sched_per_node_s * n_alive
            + s.sched_per_bundle_s * n_bundles)

    def _idle_bundles(self) -> list:
        """Placed-but-not-yet-running gangs' bundles (the sim analog of
        reservations nothing consumes yet) — what plan_repack may move."""
        rows = []
        for gid in sorted(self.placed):
            g = self.placed[gid]
            if g.running or g.placement is None:
                continue
            for idx, nid in enumerate(g.placement):
                rows.append((gid, idx, nid, dict(g.bundles[idx])))
        return rows

    def _try_place(self, gang: _Gang):
        s = self.spec
        alive = [self.nodes[nid] for nid in sorted(self.nodes)
                 if self.nodes[nid].alive and nid not in self._delayed]
        gang.attempts += 1
        cost = self._attempt_cost(len(alive), len(gang.bundles))
        done_at = max(self.now, self.sched_free_at) + cost
        self.sched_free_at = done_at

        moves: list = []
        if s.policy == "contention":
            # same dispatch point the GCS uses: the common.place_bundles
            # wrapper with a topology takes the contention scorer
            placement = place_bundles(
                alive, gang.bundles, gang.strategy,
                topology=self.topo, committed_rings=self._rings,
                max_candidates=s.max_candidates)
            if placement is None and gang.strategy == "STRICT_SPREAD":
                plan = topology.plan_repack(
                    alive, gang.bundles, gang.strategy,
                    self._idle_bundles(), max_moves=s.repack_max_moves)
                if plan is not None:
                    placement, moves = plan
        else:
            placement = place_bundles(alive, gang.bundles, gang.strategy)

        if placement is None:
            if done_at - gang.arrival_t + s.retry_s > s.give_up_s:
                self.failed += 1
                self.trace.emit(done_at, "infeasible", gang=gang.gang_id,
                                attempts=gang.attempts)
            else:
                self._push(done_at + s.retry_s, "retry", gang)
            return

        for mv in moves:
            moved = self.placed.get(mv.pg_id)
            if moved is None or moved.placement is None:
                continue
            b = moved.bundles[mv.bundle_index]
            src = self.nodes.get(mv.from_node)
            if src is not None and src.alive:
                res_add(src.resources_available, b)
            res_sub(self.nodes[mv.to_node].resources_available, b)
            moved.placement[mv.bundle_index] = mv.to_node
            self._rings[mv.pg_id] = self.topo.ring_links(moved.placement)
            self.repacks += 1
            self.trace.emit(done_at, "repack", gang=mv.pg_id,
                            bundle=mv.bundle_index,
                            src=mv.from_node, dst=mv.to_node)

        self._take(placement, gang.bundles)
        gang.placement = list(placement)
        gang.placed_t = done_at
        self.placed[gang.gang_id] = gang
        self.latencies.append(done_at - gang.arrival_t)
        ring = self.topo.ring_links(placement)
        # scored with the same geometry under BOTH policies — baseline
        # ignores contention when placing but is measured by it (the A/B)
        score = self.topo.score(placement, self._rings)
        self._rings[gang.gang_id] = ring
        self.contention_scores.append(float(score.contention))
        self.trace.emit(
            done_at, "place", gang=gang.gang_id,
            attempts=gang.attempts, contention=f"{score.contention:g}",
            compact=f"{score.compactness:.3f}",
            nodes=",".join(placement),
        )
        # epoch-stamped: a gang requeued by chaos gets fresh start/depart
        # events; stale ones from the pre-requeue placement must not fire
        self._push(done_at + self.spec.start_delay_s, "start",
                   (gang, gang.requeues))
        self._push(done_at + gang.hold_s, "depart", (gang, gang.requeues))

    # -- event handlers -------------------------------------------------
    def _on_kill(self, nid: str):
        node = self.nodes.get(nid)
        if node is None or not node.alive:
            return
        node.alive = False
        self.trace.emit(self.now, "kill", node=nid)
        for gid in sorted(self.placed):
            g = self.placed[gid]
            if g.placement and nid in g.placement:
                self._release(g.placement, g.bundles)
                self._rings.pop(gid, None)
                del self.placed[gid]
                g.placement = None
                g.placed_t = None
                g.running = False
                g.requeues += 1
                g.arrival_t = self.now  # latency restarts at requeue
                self.trace.emit(self.now, "requeue", gang=gid,
                                reason=f"node_death:{nid}")
                self._push(self.now, "retry", g)

    def _on_hb_delay(self, nid: str, dur: float):
        node = self.nodes.get(nid)
        if node is None or not node.alive or nid in self._delayed:
            return
        self._delayed.add(nid)  # out of the placement view for the window
        self.trace.emit(self.now, "hb_delay", node=nid,
                        ms=f"{dur * 1e3:.0f}")
        self._push(self.now + dur, "hb_restore", nid)

    def _on_hb_restore(self, nid: str):
        if nid in self._delayed:
            self._delayed.discard(nid)
            self.trace.emit(self.now, "hb_restore", node=nid)

    # -- main loop ------------------------------------------------------
    def run(self) -> dict:
        self._schedule_workload()
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self._advance(t)
            if kind == "arrive":
                self.trace.emit(t, "arrive", gang=payload.gang_id,
                                size=len(payload.bundles),
                                strategy=payload.strategy)
                self._try_place(payload)
            elif kind == "retry":
                if payload.placement is None:
                    self._try_place(payload)
            elif kind == "start":
                gang, epoch = payload
                if gang.gang_id in self.placed and epoch == gang.requeues:
                    gang.running = True
            elif kind == "depart":
                gang, epoch = payload
                if gang.gang_id in self.placed and epoch == gang.requeues:
                    self._release(gang.placement, gang.bundles)
                    self._rings.pop(gang.gang_id, None)
                    del self.placed[gang.gang_id]
                    self.trace.emit(t, "depart", gang=gang.gang_id)
            elif kind == "kill":
                self._on_kill(payload)
            elif kind == "hb_delay":
                self._on_hb_delay(*payload)
            elif kind == "hb_restore":
                self._on_hb_restore(payload)
        return self.report()

    # -- reporting ------------------------------------------------------
    def report(self) -> dict:
        lat = sorted(self.latencies)
        mean_cont = (sum(self.contention_scores)
                     / len(self.contention_scores)
                     if self.contention_scores else 0.0)
        return {
            "policy": self.spec.policy,
            "nodes": self.spec.nodes,
            "gangs": self.spec.n_gangs(),
            "placed": len(self.latencies),
            "failed": self.failed,
            "repacks": self.repacks,
            "placement_latency_s": {
                "p50": _pct(lat, 0.50),
                "p95": _pct(lat, 0.95),
                "p99": _pct(lat, 0.99),
                "max": lat[-1] if lat else 0.0,
            },
            "utilization": (
                self._util_area / (self.total_cpu * self._util_last_t)
                if self._util_last_t > 0 else 0.0),
            "mean_contention": mean_cont,
            "total_contention": sum(self.contention_scores),
            "final_ring_overlap_ratio": self.topo.overlap_ratio(
                self._rings),
            "events": len(self.trace.lines),
            "trace_sha256": self.trace.sha256(),
        }


def run(spec: SimSpec) -> dict:
    """Run one simulation; returns the report dict (see SchedSim.report).
    Attach the trace via ``run_with_trace`` when replay/diffing matters."""
    return SchedSim(spec).run()


def run_with_trace(spec: SimSpec) -> Tuple[dict, str]:
    sim = SchedSim(spec)
    report = sim.run()
    return report, sim.trace.text()
