"""Global Control Service: head-node metadata server + cluster-level scheduling.

Analog of the reference's GcsServer (ray: src/ray/gcs/gcs_server/gcs_server.h:79)
composing sub-managers: node membership + health (gcs_node_manager.h,
gcs_health_check_manager.h), cluster resource view (gcs_resource_manager.h),
actor lifetime + fault tolerance (gcs_actor_manager.h, gcs_actor_scheduler.h),
placement groups (gcs_placement_group_manager.h, 2-phase prepare/commit),
jobs (gcs_job_manager.h), internal KV (gcs_kv_manager.h), pubsub
(pubsub_handler.h), and the object directory (here centralized; the reference
uses owner-based lookup). State lives in a pluggable store (in-memory dict
now; the interface allows a persistent backend for GCS fault tolerance).

Raylets and drivers hold persistent duplex connections; the GCS pushes
cluster-view updates and actor/node pubsub over them.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Dict, List, Optional, Set

from ray_tpu_torch._private import faultsim
from ray_tpu_torch._private.common import NodeInfo, TaskSpec, place_bundles, res_fits
from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch._private.rpcio import Connection, RpcServer, own_stall_s, spawn

logger = logging.getLogger(__name__)

# Actor states (ray: gcs.proto ActorTableData.ActorState)
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class ActorRecord:
    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.actor_id: bytes = spec.actor_id
        self.state = PENDING_CREATION
        self.node_id: Optional[str] = None
        self.address: Optional[tuple] = None  # (node_id_hex, worker_client_id)
        # (host, port) of the actor worker's own RPC server; drivers push
        # calls straight there (ray: direct actor call transport)
        self.direct_addr: Optional[tuple] = None
        self.num_restarts = 0
        self.name = spec.name_registered
        self.namespace = spec.namespace or "default"
        self.death_cause: Optional[str] = None
        self.owner_conn_key: Optional[str] = None  # owning driver/worker client id

    def dump(self) -> dict:
        """Persistable form (everything a restarted GCS needs to resume
        managing this actor, incl. the creation spec for restarts)."""
        return {
            "spec": self.spec,
            "state": self.state,
            "node_id": self.node_id,
            "address": self.address,
            "direct_addr": self.direct_addr,
            "num_restarts": self.num_restarts,
            "death_cause": self.death_cause,
            "owner_conn_key": self.owner_conn_key,
        }

    @classmethod
    def restore(cls, d: dict) -> "ActorRecord":
        rec = cls(d["spec"])
        rec.state = d["state"]
        rec.node_id = d["node_id"]
        rec.address = tuple(d["address"]) if d["address"] else None
        rec.direct_addr = tuple(d["direct_addr"]) if d.get("direct_addr") else None
        rec.num_restarts = d["num_restarts"]
        rec.death_cause = d["death_cause"]
        rec.owner_conn_key = d.get("owner_conn_key")
        return rec

    def to_table(self):
        return {
            "actor_id": self.actor_id,
            "state": self.state,
            "node_id": self.node_id,
            "address": self.address,
            "direct_addr": self.direct_addr,
            "name": self.name,
            "namespace": self.namespace,
            "num_restarts": self.num_restarts,
            "class_name": self.spec.name,
            "death_cause": self.death_cause,
            "pid": None,
        }


class PlacementGroupRecord:
    def __init__(self, pg_id: str, bundles, strategy: str, name: str, job_id: bytes,
                 lifetime: Optional[str]):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.job_id = job_id
        self.lifetime = lifetime
        self.state = "PENDING"
        self.bundle_nodes: List[Optional[str]] = [None] * len(bundles)
        # topology-aware scheduling provenance (topology.py): the torus
        # coord per bundle host, the ring-overlap contention score of the
        # chosen placement, which scoring path chose it
        # ("topology-contention" | "resource-fit"), and how many pending
        # bundles the fragmentation repack pass migrated to place it
        self.node_coords: List[Optional[str]] = [None] * len(bundles)
        self.contention_score: Optional[float] = None
        self.sched_strategy: str = "resource-fit"
        self.repack_moves: int = 0
        # client id of the process that created it: the group dies with
        # that process's actor (``_destroy_actor``) unless detached
        self.creator: Optional[str] = None

    def dump(self) -> dict:
        return {
            "pg_id": self.pg_id, "bundles": self.bundles,
            "strategy": self.strategy, "name": self.name,
            "job_id": self.job_id, "lifetime": self.lifetime,
            "state": self.state, "bundle_nodes": self.bundle_nodes,
            "node_coords": self.node_coords,
            "contention_score": self.contention_score,
            "sched_strategy": self.sched_strategy,
            "repack_moves": self.repack_moves,
            "creator": self.creator,
        }

    @classmethod
    def restore(cls, d: dict) -> "PlacementGroupRecord":
        pg = cls(d["pg_id"], d["bundles"], d["strategy"], d["name"],
                 d["job_id"], d["lifetime"])
        pg.state = d["state"]
        pg.bundle_nodes = list(d["bundle_nodes"])
        pg.node_coords = list(d.get("node_coords")
                              or [None] * len(pg.bundles))
        pg.contention_score = d.get("contention_score")
        pg.sched_strategy = d.get("sched_strategy", "resource-fit")
        pg.repack_moves = d.get("repack_moves", 0)
        pg.creator = d.get("creator")
        return pg

    def to_table(self):
        return {
            "placement_group_id": self.pg_id,
            "name": self.name,
            "bundles": self.bundles,
            "strategy": self.strategy,
            "state": self.state,
            "bundle_nodes": self.bundle_nodes,
            "node_coords": self.node_coords,
            "contention_score": self.contention_score,
            "sched_strategy": self.sched_strategy,
            "repack_moves": self.repack_moves,
        }


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None,
                 cluster_id: Optional[str] = None):
        from ray_tpu_torch._private.gcs_store import make_store

        self.server = RpcServer(self, host, port)
        self.nodes: Dict[str, NodeInfo] = {}
        self.node_conns: Dict[str, Connection] = {}
        self.client_conns: Dict[str, Connection] = {}  # drivers/workers subscribed
        self.actors: Dict[bytes, ActorRecord] = {}
        self.named_actors: Dict[tuple, bytes] = {}  # (namespace, name) -> actor_id
        self.jobs: Dict[bytes, dict] = {}
        self.kv: Dict[str, Dict[bytes, bytes]] = {}
        self.pgs: Dict[str, PlacementGroupRecord] = {}
        self.object_dir: Dict[bytes, Set[str]] = {}
        self.object_waiters: Dict[bytes, List[asyncio.Future]] = {}
        self.subscribers: Dict[str, Set[Connection]] = {}  # channel -> conns
        self._pub_buf: Dict[Connection, list] = {}  # batched pubsub outbox
        self._pub_flush: Optional[asyncio.Task] = None
        self._pg_lock = asyncio.Lock()
        # committed gang rings (topology.py): pg_id -> frozenset of torus
        # links its induced allreduce ring occupies; feeds the contention
        # score of every later placement + sched_ring_overlap_ratio
        self._pg_rings: Dict[str, frozenset] = {}
        self._sched_repacks = 0  # bundles migrated by the repack pass
        self._next_job = 1
        self._started = asyncio.Event()
        self._tasks: List[asyncio.Task] = []
        self.task_events: List[dict] = []  # bounded task-event log for state API
        # structured cluster events (ray parity: src/ray/util/event.h:130 —
        # severity/source/label/message + custom fields), bounded ring
        self.events: deque = deque(maxlen=10_000)
        self._store = make_store(persist_path, cluster_id=cluster_id)
        # step observatory: rolling collective-skew fold (steptrace.py),
        # built lazily on the first steptrace_cluster scrape
        self._steptrace_agg = None
        # request observatory: rolling serve-request fold (reqtrace.py),
        # built lazily on the first reqtrace_cluster scrape
        self._reqtrace_agg = None
        self._recovering: Set[bytes] = set()  # actor_ids awaiting raylet reclaim
        self._recovered = self._replay()

    def _replay(self) -> bool:
        """Rebuild tables from the persistent store (ray: gcs_init_data.h —
        a restarted GCS loads all tables before serving)."""
        tables = self._store.load()
        if not tables:
            return False
        for (ns, key), value in tables.get("kv", {}).items():
            self.kv.setdefault(ns, {})[key] = value
        for job_id, job in tables.get("job", {}).items():
            self.jobs[job_id] = job
        self._next_job = tables.get("meta", {}).get("next_job", 1)
        for pg_id, d in tables.get("pg", {}).items():
            if d["state"] != "REMOVED":
                self.pgs[pg_id] = PlacementGroupRecord.restore(d)
        for actor_id, d in tables.get("actor", {}).items():
            rec = ActorRecord.restore(d)
            self.actors[actor_id] = rec
            if rec.name and rec.state != DEAD:
                self.named_actors[(rec.namespace, rec.name)] = actor_id
            if rec.state != DEAD:
                # Raylets reconnect and reclaim still-running actors; the
                # rest are failed over after the reconnect window.
                rec.state = RESTARTING
                self._recovering.add(actor_id)
        logger.info(
            "GCS restarted from store: %d actors (%d recovering), %d pgs, "
            "%d jobs", len(self.actors), len(self._recovering), len(self.pgs),
            len(self.jobs),
        )
        return True

    def _setup_metrics(self):
        """GCS runtime gauges (metrics_core.py): node liveness + control
        tables, evaluated at snapshot time. The remote-KV pipeline's
        queue/breaker gauges register in gcs_store.RemoteKvStore."""
        from ray_tpu_torch._private import metrics_core as mc

        reg = mc.registry()
        nodes = reg.gauge("gcs_node_count", "Cluster nodes by liveness")
        nodes.labels(state="alive").set_fn(
            lambda: sum(1 for n in self.nodes.values() if n.alive))
        nodes.labels(state="dead").set_fn(
            lambda: sum(1 for n in self.nodes.values() if not n.alive))
        reg.gauge("gcs_actor_count", "Actor records in the GCS table"
                  ).set_fn(lambda: len(self.actors))
        reg.gauge("gcs_placement_group_count", "Placement group records"
                  ).set_fn(lambda: len(self.pgs))
        reg.gauge("gcs_subscriber_conns", "Pubsub subscriber connections"
                  ).set_fn(lambda: sum(len(s)
                                       for s in self.subscribers.values()))
        # gang-scheduler health: aggregate ring overlap across committed
        # gangs (0 = every gang owns its torus links) + repack activity
        reg.gauge(
            "sched_ring_overlap_ratio",
            "Pairwise shared torus links / total ring links across "
            "committed placement-group gangs",
        ).set_fn(self._ring_overlap_ratio)
        reg.counter(
            "sched_repack_total",
            "Pending placement-group bundles migrated by the "
            "fragmentation repack pass",
        ).set_fn(lambda: self._sched_repacks)

    def _ring_overlap_ratio(self) -> float:
        from ray_tpu_torch._private import topology

        return topology.overlap_ratio(self._pg_rings)

    async def start(self):
        port = await self.server.start()
        faultsim.set_self_id(f"gcs:{port}")
        self._setup_metrics()
        self._tasks.append(spawn(self._health_loop()))
        if self._recovered:
            self._tasks.append(
                spawn(self._finish_recovery())
            )
        self._started.set()
        logger.info("GCS listening on %s", port)
        return port

    async def _finish_recovery(self):
        """After the failover window, restart recovering actors nobody
        reclaimed and re-place PGs whose nodes never came back (ray:
        gcs_failover_worker_reconnect_timeout, node_manager.proto:358
        NotifyGCSRestart — our raylets reconnect and re-register instead)."""
        await asyncio.sleep(cfg.gcs_failover_reconnect_timeout_s)
        for actor_id in list(self._recovering):
            self._recovering.discard(actor_id)
            rec = self.actors.get(actor_id)
            if rec is not None and rec.state == RESTARTING:
                await self._handle_actor_failure(
                    rec, "actor lost during GCS failover"
                )
        for pg in list(self.pgs.values()):
            if pg.state == "CREATED" and any(
                nid not in self.nodes or not self.nodes[nid].alive
                for nid in pg.bundle_nodes
            ):
                pg.state = "PENDING"
                pg.bundle_nodes = [None] * len(pg.bundles)
                self._reset_pg_provenance(pg)
                self._pg_rings.pop(pg.pg_id, None)
                self._persist_pg(pg)
                spawn(self._schedule_pg(pg))
        # Jobs whose driver never reconnected: treat the driver as dead (its
        # exit raced the GCS outage, so the disconnect cleanup never ran).
        live_jobs = {
            c.meta.get("job_id")
            for c in self.client_conns.values()
            if c.meta.get("is_driver")
        }
        for job_id, job in list(self.jobs.items()):
            if not job["is_dead"] and job_id not in live_jobs:
                await self._on_driver_exit(job_id)

    # -- persistence write-through helpers ------------------------------
    def _persist_actor(self, rec: ActorRecord):
        self._store.put("actor", rec.actor_id, rec.dump())

    def _persist_pg(self, pg: PlacementGroupRecord):
        self._store.put("pg", pg.pg_id, pg.dump())

    def _persist_job(self, job_id: bytes):
        self._store.put("job", job_id, self.jobs[job_id])

    async def stop(self):
        # drain the pubsub outbox first: publishes acked in the final tick
        # (e.g. node-dead from a teardown path) must still reach subscribers
        if self._pub_flush is not None:
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._pub_flush), timeout=2.0
                )
            except Exception:
                pass
        for t in self._tasks:
            t.cancel()
        await self.server.stop()
        self._store.close()

    # ------------------------------------------------------------------
    # Connection lifecycle
    # ------------------------------------------------------------------
    def on_disconnect(self, conn: Connection):
        # drop pubsub subscriptions FIRST: the driver/raylet early
        # returns below used to skip this, leaving dead conns inflating
        # subscriber counts (the heartbeat-reported "logs" count gates
        # raylet log tailing, so a leak here would keep every raylet
        # tailing after the last driver exited)
        for subs in self.subscribers.values():
            subs.discard(conn)
        kind = conn.meta.get("kind")
        if kind == "raylet":
            node_id = conn.meta["node_id"]
            self.node_conns.pop(node_id, None)
            return self._mark_node_dead(node_id, "raylet disconnected")
        if kind == "client":
            self.client_conns.pop(conn.meta.get("client_id"), None)
            job_id = conn.meta.get("job_id")
            if conn.meta.get("is_driver") and job_id is not None:
                return self._on_driver_exit(job_id)

    async def _on_driver_exit(self, job_id: bytes):
        """Driver died/finished: finish job, destroy its non-detached actors."""
        job = self.jobs.get(job_id)
        if job:
            job["is_dead"] = True
            job["end_time"] = time.time()
            self._persist_job(job_id)
        for rec in list(self.actors.values()):
            if rec.spec.job_id == job_id and rec.spec.lifetime != "detached" \
                    and rec.state != DEAD:
                await self._destroy_actor(rec, "owner job finished")
        for pg in list(self.pgs.values()):
            if pg.job_id == job_id and pg.lifetime != "detached":
                await self._remove_pg(pg.pg_id)

    # ------------------------------------------------------------------
    # Node manager (+ health checks)
    # ------------------------------------------------------------------
    async def rpc_register_node(self, conn: Connection, info: dict):
        state = info.pop("state", None)
        node = NodeInfo(**info)
        node.resources_available = dict(node.resources_total)
        self.nodes[node.node_id] = node
        conn.meta.update(kind="raylet", node_id=node.node_id)
        self.node_conns[node.node_id] = conn
        if state:
            await self._reconcile_node_state(node.node_id, state)
        await self._publish("node", {"event": "alive", "node": info})
        self._record_event(
            "INFO", "gcs", "NODE_ADDED",
            f"node {node.node_id[:12]} joined at {node.host}:{node.port}",
            {"node_id": node.node_id},
        )
        await self._broadcast_view()
        # New capacity: placement groups that gave up as INFEASIBLE get
        # another scheduling run (the autoscaler may have just launched
        # the slice their bundles were waiting for).
        for pg in list(self.pgs.values()):
            if pg.state == "INFEASIBLE":
                pg.state = "PENDING"
                self._persist_pg(pg)
                spawn(self._schedule_pg(pg))
        return {"node_id": node.node_id, "nodes": self._view()}

    async def _reconcile_node_state(self, node_id: str, state: dict):
        """A raylet re-registered after a GCS restart (or its own reconnect)
        and reported what it is actually running; fold that back into the
        replayed tables (reference analog: RayletNotifyGCSRestart +
        per-table resubscription, core_worker.proto:417)."""
        for actor_id, client_id in state.get("actors_running", {}).items():
            rec = self.actors.get(actor_id)
            if rec is not None and rec.state != DEAD:
                rec.node_id = node_id
                rec.address = (node_id, client_id)
                # re-registered after GCS restart: the direct endpoint is
                # unknown here; drivers fall back to raylet routing
                rec.direct_addr = None
                rec.state = ALIVE
                self._recovering.discard(actor_id)
                await self._publish_actor(rec)
        for oid in state.get("objects", ()):
            self.object_dir.setdefault(oid, set()).add(node_id)
            for fut in self.object_waiters.pop(oid, []):
                if not fut.done():
                    fut.set_result([node_id])
        for pg_id, bundle_index in state.get("pg_bundles", ()):
            pg = self.pgs.get(pg_id)
            if pg is not None and pg.state == "CREATED" \
                    and 0 <= bundle_index < len(pg.bundle_nodes):
                pg.bundle_nodes[bundle_index] = node_id

    async def rpc_heartbeat(self, conn: Connection, payload: dict):
        node = self.nodes.get(payload["node_id"])
        if node is None:
            return {"reregister": True}
        node.last_heartbeat = time.monotonic()
        node.resources_available = payload["resources_available"]
        if "resources_total" in payload:
            node.resources_total = payload["resources_total"]
        node.pending_demand = payload.get("pending_demand", [])
        idle = payload.get("idle", False)
        if idle and not node.idle:
            node.idle_since = time.monotonic()
        node.idle = idle
        if not node.alive:
            node.alive = True
        # "logs"-channel subscriber count: raylets skip tailing worker
        # logs entirely while nobody is listening (log plane costs
        # nothing on an unwatched cluster)
        return {"log_subscribers": len(self.subscribers.get("logs", ()))}

    async def rpc_get_load_metrics(self, conn: Connection, _):
        """Autoscaler input: per-node demand + idle durations (ray:
        monitor.proto:100 GetAllResourceUsage)."""
        now = time.monotonic()
        nodes = []
        demand = []
        for n in self.nodes.values():
            if not n.alive:
                continue
            nodes.append({
                "node_id": n.node_id,
                "resources_total": n.resources_total,
                "resources_available": n.resources_available,
                "labels": n.labels,
                "idle_s": (now - n.idle_since) if n.idle else 0.0,
            })
            demand.extend(n.pending_demand)
        # Unschedulable actors are demand too (ray: GcsAutoscalerStateManager
        # folds pending actor creations into the load report).
        for rec in self.actors.values():
            if rec.state in (PENDING_CREATION, RESTARTING) and rec.spec.resources:
                demand.append(dict(rec.spec.resources))
        # Unplaced placement groups report every bundle (ray: the
        # autoscaler sees PG demand via placement_group_load) — this is
        # what makes pending TPU PGs launch whole slices.
        for pg in self.pgs.values():
            if pg.state in ("PENDING", "INFEASIBLE"):
                demand.extend(dict(b) for b in pg.bundles)
        return {"nodes": nodes, "pending_demand": demand}

    async def rpc_get_nodes(self, conn: Connection, _):
        return self._view()

    def _view(self):
        return [
            {
                "node_id": n.node_id,
                "host": n.host,
                "port": n.port,
                "store_dir": n.store_dir,
                "resources_total": n.resources_total,
                "resources_available": n.resources_available,
                "labels": n.labels,
                "alive": n.alive,
            }
            for n in self.nodes.values()
        ]

    async def _broadcast_view(self):
        view = self._view()
        for nid, conn in list(self.node_conns.items()):
            try:
                await conn.notify("cluster_view", view)
            except Exception:
                pass

    async def _health_loop(self):
        tick = time.monotonic()
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            now = time.monotonic()
            # the heartbeats sent while this process stalled still wait
            # unread behind this check: its own stall is no node's silence
            stalled = own_stall_s(now - tick, cfg.heartbeat_interval_s)
            tick = now
            for node in list(self.nodes.values()):
                node.last_heartbeat += stalled
                if node.alive and now - node.last_heartbeat > cfg.node_death_timeout_s:
                    await self._mark_node_dead(node.node_id, "heartbeat timeout")
            await self._broadcast_view()

    async def _mark_node_dead(self, node_id: str, reason: str):
        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return
        node.alive = False
        logger.warning("node %s marked dead: %s", node_id[:8], reason)
        self._record_event(
            "WARNING", "gcs", "NODE_DEAD",
            f"node {node_id[:12]} marked dead: {reason}",
            {"node_id": node_id, "reason": reason},
        )
        await self._publish("node", {"event": "dead", "node_id": node_id, "reason": reason})
        # Restart or fail actors that lived there.
        for rec in list(self.actors.values()):
            if rec.node_id == node_id and rec.state in (ALIVE, PENDING_CREATION):
                await self._handle_actor_failure(rec, f"node died: {reason}")
        await self._broadcast_view()

    # ------------------------------------------------------------------
    # Jobs
    # ------------------------------------------------------------------
    async def rpc_register_job(self, conn: Connection, payload: dict):
        job_num = self._next_job
        self._next_job += 1
        from ray_tpu_torch._private.ids import JobID

        job_id = JobID.from_int(job_num).binary()
        self.jobs[job_id] = {
            "job_id": job_id,
            "start_time": time.time(),
            "is_dead": False,
            "driver": payload.get("driver", {}),
            "namespace": payload.get("namespace") or "default",
            "end_time": None,
        }
        self._persist_job(job_id)
        self._store.put("meta", "next_job", self._next_job)
        return {"job_id": job_id}

    async def rpc_register_client(self, conn: Connection, payload: dict):
        conn.meta.update(
            kind="client",
            client_id=payload["client_id"],
            job_id=payload.get("job_id"),
            is_driver=payload.get("is_driver", False),
        )
        self.client_conns[payload["client_id"]] = conn
        return {}

    async def rpc_list_jobs(self, conn: Connection, _):
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # Internal KV (ray: gcs_kv_manager.h)
    # ------------------------------------------------------------------
    async def _persist_kv_awaited(self, key, value):
        """Persist one user-visible KV mutation BEFORE the client sees
        the ack. Internal table writes (_persist_actor/_persist_pg) stay
        fire-and-forget — a slow store must not stall the control plane —
        but a kv_put the client observed succeeding has to survive a
        kill -9 of the GCS (the redis-store durability contract). Stores
        with an awaitable path (RemoteKvStore.aput) flush without
        blocking the event loop; local stores write synchronously (disk,
        microseconds). Returns False when the flush did NOT land (breaker
        open / put timeout) so the ack can say so."""
        aput = getattr(self._store, "aput", None)
        if aput is None:
            self._store.put("kv", key, value)
            return True
        return bool(await aput("kv", key, value))

    async def rpc_kv_put(self, conn: Connection, p):
        nsname = p.get("ns", "")
        ns = self.kv.setdefault(nsname, {})
        existed = p["key"] in ns
        persisted = True
        if p.get("overwrite", True) or not existed:
            ns[p["key"]] = p["value"]
            # volatile: rendezvous-lifetime data (collective chunk
            # payloads) that is useless after a GCS restart — the gang
            # re-forms its group and republishes (elastic recovery path).
            # Skipping the store write keeps multi-MB chunk streams off
            # the disk path entirely.
            if not p.get("volatile"):
                persisted = await self._persist_kv_awaited(
                    (nsname, p["key"]), p["value"])
        # persisted=False = the degraded no-persist posture: the write is
        # live in memory but would not survive a GCS kill -9 right now
        return {"added": not existed, "persisted": persisted}

    async def rpc_kv_get(self, conn: Connection, p):
        return self.kv.get(p.get("ns", ""), {}).get(p["key"])

    async def rpc_kv_del(self, conn: Connection, p):
        nsname = p.get("ns", "")
        ns = self.kv.get(nsname, {})
        if p.get("prefix"):
            keys = [k for k in ns if k.startswith(p["key"])]
            deleted = 0
            for k in keys:
                # pop, not del: the await below suspends the handler, so
                # a concurrent kv_del may have removed (and tombstoned)
                # this key already
                if ns.pop(k, None) is None:
                    continue
                deleted += 1
                await self._persist_kv_awaited((nsname, k), None)
            return deleted
        if ns.pop(p["key"], None) is not None:
            await self._persist_kv_awaited((nsname, p["key"]), None)
            return 1
        return 0

    async def rpc_kv_keys(self, conn: Connection, p):
        ns = self.kv.get(p.get("ns", ""), {})
        return [k for k in ns if k.startswith(p.get("prefix", b""))]

    async def rpc_kv_exists(self, conn: Connection, p):
        return p["key"] in self.kv.get(p.get("ns", ""), {})

    # ------------------------------------------------------------------
    # Pubsub (ray: src/ray/pubsub/)
    # ------------------------------------------------------------------
    # -- structured events (ray parity: util/event.h + event aggregator) --
    def _record_event(self, severity: str, source: str, label: str,
                      message: str, fields: Optional[dict] = None):
        self.events.append({
            "timestamp": time.time(),
            "severity": severity,
            "source": source,
            "label": label,
            "message": message,
            "fields": fields or {},
        })

    async def rpc_add_event(self, conn: Connection, p):
        self._record_event(
            p.get("severity", "INFO"), p.get("source", "user"),
            p.get("label", ""), p.get("message", ""), p.get("fields"),
        )
        return {}

    async def rpc_get_events(self, conn: Connection, p):
        severity = p.get("severity")
        source = p.get("source")
        limit = p.get("limit") or 100
        out = []
        for ev in reversed(self.events):  # newest first
            if severity and ev["severity"] != severity:
                continue
            if source and ev["source"] != source:
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out

    async def rpc_subscribe(self, conn: Connection, p):
        self.subscribers.setdefault(p["channel"], set()).add(conn)
        return {}

    async def rpc_publish(self, conn: Connection, p):
        await self._publish(p["channel"], p["message"])
        return {}

    async def _publish(self, channel: str, message):
        """Queue the message per subscriber and flush in batches.

        The reference batches pubsub delivery (ray: src/ray/pubsub/ — the
        long-poll reply carries every message queued since the last poll).
        Same effect here on duplex connections: messages published in the
        same loop tick coalesce into one "pubsub_batch" notify per
        subscriber, so a burst of table updates (actor churn, PG commits)
        costs one frame per peer instead of one per message.
        """
        for conn in list(self.subscribers.get(channel, ())):
            if conn.closed:
                self.subscribers[channel].discard(conn)
                continue
            self._pub_buf.setdefault(conn, []).append((channel, message))
        if self._pub_buf and self._pub_flush is None:
            self._pub_flush = spawn(
                self._flush_pubsub()
            )

    async def _flush_pubsub(self):
        try:
            # one loop turn lets same-tick publishes pile into the batch
            await asyncio.sleep(0)
            while self._pub_buf:
                buf, self._pub_buf = self._pub_buf, {}
                for conn, batch in buf.items():
                    if conn.closed:
                        continue
                    try:
                        await conn.notify("pubsub_batch", {"batch": batch})
                    except Exception:
                        pass
        finally:
            # reset even if cancelled mid-await so later publishes can
            # schedule a fresh flush
            self._pub_flush = None

    # ------------------------------------------------------------------
    # Object directory (centralized variant of the ownership directory)
    # ------------------------------------------------------------------
    async def rpc_add_object_location(self, conn: Connection, p):
        oid, node_id = p["object_id"], p["node_id"]
        self.object_dir.setdefault(oid, set()).add(node_id)
        waiters = self.object_waiters.pop(oid, [])
        for fut in waiters:
            if not fut.done():
                fut.set_result([node_id])
        return {}

    async def rpc_add_object_locations(self, conn: Connection, p):
        """Batched variant: one frame per slab-accounting burst (the
        arena's batched put path registers many objects per tick)."""
        node_id = p["node_id"]
        for oid in p["object_ids"]:
            self.object_dir.setdefault(oid, set()).add(node_id)
            for fut in self.object_waiters.pop(oid, []):
                if not fut.done():
                    fut.set_result([node_id])
        return {}

    async def rpc_remove_object_location(self, conn: Connection, p):
        locs = self.object_dir.get(p["object_id"])
        if locs:
            locs.discard(p["node_id"])
            if not locs:
                del self.object_dir[p["object_id"]]
        return {}

    async def rpc_get_object_locations(self, conn: Connection, p):
        locs = self.object_dir.get(p["object_id"], set())
        live = [nid for nid in locs if self.nodes.get(nid) and self.nodes[nid].alive]
        if live or not p.get("wait"):
            return live
        fut = asyncio.get_running_loop().create_future()
        self.object_waiters.setdefault(p["object_id"], []).append(fut)
        try:
            return await asyncio.wait_for(fut, p.get("timeout", cfg.object_pull_timeout_s))
        except asyncio.TimeoutError:
            return []

    async def rpc_free_object(self, conn: Connection, p):
        """Owner released the object: tell all holding raylets to delete it."""
        await self._free_objects([p["object_id"]])
        return {}

    async def rpc_free_objects(self, conn: Connection, p):
        """Batched variant: one frame for a release burst (a 10k-object
        teardown as 10k serial RPCs would wedge the raylet loop for
        seconds and starve every free queued behind it)."""
        await self._free_objects(p["object_ids"])
        return {}

    async def _free_objects(self, oids):
        per_node: Dict[bytes, list] = {}
        for oid in oids:
            for nid in self.object_dir.pop(oid, set()):
                per_node.setdefault(nid, []).append(oid)
        for nid, node_oids in per_node.items():
            nconn = self.node_conns.get(nid)
            if nconn:
                try:
                    await nconn.notify(
                        "delete_objects", {"object_ids": node_oids}
                    )
                except Exception:
                    pass

    # ------------------------------------------------------------------
    # Actor manager + scheduler (ray: gcs_actor_manager.h, gcs_actor_scheduler.h)
    # ------------------------------------------------------------------
    async def rpc_register_actor(self, conn: Connection, p):
        spec: TaskSpec = p["spec"]
        rec = ActorRecord(spec)
        rec.owner_conn_key = conn.meta.get("client_id")
        if rec.name:
            key = (rec.namespace, rec.name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != DEAD:
                    return {"error": f"actor name '{rec.name}' already taken"}
            self.named_actors[key] = rec.actor_id
        self.actors[rec.actor_id] = rec
        self._persist_actor(rec)
        spawn(self._schedule_actor(rec))
        return {"actor_id": rec.actor_id}

    async def _schedule_actor(self, rec: ActorRecord):
        # Per-actor scheduling loop; no global lock — concurrent creations
        # race on node resources and rely on raylet-side admission (rejects)
        # plus retry, like the reference's per-actor GcsActorScheduler.
        if rec.state == DEAD:
            return
        rec.state = PENDING_CREATION
        await self._publish_actor(rec)
        spec = rec.spec
        from ray_tpu_torch._private.common import SchedulingStrategy, pick_node

        demand = dict(spec.resources)
        strategy = spec.scheduling or SchedulingStrategy()
        deadline = time.monotonic() + cfg.worker_lease_timeout_ms / 1000.0
        rr = [0]
        while time.monotonic() < deadline:
            if rec.state == DEAD:
                return
            nodes = [n for n in self.nodes.values() if n.alive]
            target = pick_node(nodes, demand, strategy, None, rr,
                               cfg.scheduler_spread_threshold)
            if target is None or self.node_conns.get(target) is None:
                await asyncio.sleep(cfg.gcs_schedule_retry_interval_s)
                continue
            try:
                # No rpc idem token: the scheduling loop legitimately
                # re-asks the same node after a transient rejection, and a
                # token would replay the cached rejection forever. Lost-
                # reply dedup lives in the raylet instead — rpc_create_actor
                # re-answers for an actor_id it already runs.
                # the raylet bounds each step of a creation itself (the
                # worker's registration, then __init__ under
                # gcs_rpc_timeout_s): a shorter wait here gave up on a slow
                # but live creation once the search deadline had passed
                reply = await self.node_conns[target].request(
                    "create_actor", {"spec": spec},
                    timeout=cfg.worker_register_timeout_s
                    + cfg.gcs_rpc_timeout_s,
                )
            except Exception as e:
                logger.warning("actor creation on %s failed: %s", target[:8], e)
                await asyncio.sleep(cfg.gcs_schedule_retry_interval_s)
                continue
            if reply.get("rejected"):
                await asyncio.sleep(0.1)
                continue
            if reply.get("error"):
                rec.state = DEAD
                rec.death_cause = reply["error"]
                await self._publish_actor(rec)
                return
            rec.node_id = target
            rec.address = (target, reply["worker_client_id"])
            rec.direct_addr = tuple(reply["direct_addr"]) if reply.get("direct_addr") else None
            if rec.state == DEAD:
                # killed while its creation was in flight: the raylet runs
                # it now, so kill it there rather than bring it back to
                # life with nobody holding its handle (it kept its lease)
                await self._destroy_actor(rec, rec.death_cause or "ray.kill")
                return
            rec.state = ALIVE
            await self._publish_actor(rec)
            return
        rec.state = DEAD
        rec.death_cause = "actor creation timed out (no feasible node)"
        await self._publish_actor(rec)

    async def _publish_actor(self, rec: ActorRecord):
        self._persist_actor(rec)
        await self._publish("actor", rec.to_table())

    async def rpc_get_actor(self, conn: Connection, p):
        rec = None
        if p.get("actor_id"):
            rec = self.actors.get(p["actor_id"])
        elif p.get("name"):
            aid = self.named_actors.get((p.get("namespace") or "default", p["name"]))
            rec = self.actors.get(aid) if aid else None
            if rec and rec.state == DEAD:
                rec = None
        return rec.to_table() if rec else None

    async def rpc_list_actors(self, conn: Connection, _):
        return [r.to_table() for r in self.actors.values()]

    async def rpc_wait_actor_alive(self, conn: Connection, p):
        """Block until the actor is ALIVE or DEAD; returns its table entry.

        An unknown actor_id is awaited too (not failed immediately): the
        registration may legitimately trail task submission when the actor's
        creation arguments are still being resolved by the owner."""
        deadline = time.monotonic() + p.get("timeout", cfg.gcs_rpc_timeout_s)
        while time.monotonic() < deadline:
            rec = self.actors.get(p["actor_id"])
            if rec is not None and rec.state in (ALIVE, DEAD):
                return rec.to_table()
            await asyncio.sleep(0.02)
        rec = self.actors.get(p["actor_id"])
        return rec.to_table() if rec else None

    async def rpc_actor_died(self, conn: Connection, p):
        """Raylet reports an actor worker exited."""
        rec = self.actors.get(p["actor_id"])
        if rec is None or rec.state == DEAD:
            return {}
        if p.get("intended"):
            await self._destroy_actor(rec, p.get("reason", "killed"))
        else:
            await self._handle_actor_failure(rec, p.get("reason", "worker died"))
        return {}

    async def _handle_actor_failure(self, rec: ActorRecord, reason: str):
        max_restarts = rec.spec.max_restarts
        will_restart = max_restarts == -1 or rec.num_restarts < max_restarts
        self._record_event(
            "WARNING" if will_restart else "ERROR", "gcs",
            "ACTOR_RESTARTING" if will_restart else "ACTOR_DEAD",
            f"actor {rec.actor_id.hex()[:12]} ({rec.spec.name}) failed: "
            f"{reason}" + (" — restarting" if will_restart else ""),
            {"actor_id": rec.actor_id.hex(), "reason": reason},
        )
        if will_restart:
            rec.num_restarts += 1
            rec.state = RESTARTING
            rec.node_id = None
            rec.address = None
            rec.direct_addr = None
            await self._publish_actor(rec)
            await asyncio.sleep(cfg.actor_restart_delay_ms / 1000.0)
            spawn(self._schedule_actor(rec))
        else:
            await self._destroy_actor(rec, reason)

    async def _destroy_actor(self, rec: ActorRecord, reason: str):
        rec.state = DEAD
        rec.death_cause = reason
        if rec.name:
            self.named_actors.pop((rec.namespace, rec.name), None)
        if rec.node_id and rec.address:
            nconn = self.node_conns.get(rec.node_id)
            if nconn:
                try:
                    await nconn.notify(
                        "kill_actor", {"actor_id": rec.actor_id, "no_restart": True}
                    )
                except Exception:
                    pass
        await self._publish_actor(rec)
        # fate sharing (ray parity: an actor's non-detached children and
        # placement groups die with it): a Tune trial actor stopped by its
        # scheduler takes its train gang and the gang's placement group
        # with it, so their resources (a share of a card) return to the
        # cluster instead of staying leased to an orphaned worker
        owner = rec.address[1] if rec.address else None
        if owner is None:
            return
        for child in list(self.actors.values()):
            if child.owner_conn_key == owner and child.state != DEAD \
                    and child.spec.lifetime != "detached":
                await self._destroy_actor(child, "its owner actor died")
        for pg in list(self.pgs.values()):
            if pg.creator == owner and pg.lifetime != "detached":
                await self._remove_pg(pg.pg_id)

    async def rpc_kill_actor(self, conn: Connection, p):
        rec = self.actors.get(p["actor_id"])
        if rec is None:
            return {}
        if p.get("no_restart", True):
            await self._destroy_actor(rec, "ray.kill")
        else:
            await self._handle_actor_failure(rec, "ray.kill(no_restart=False)")
        return {}

    # ------------------------------------------------------------------
    # Placement groups (ray: gcs_placement_group_manager.h — 2-phase commit)
    # ------------------------------------------------------------------
    async def rpc_create_placement_group(self, conn: Connection, p):
        pg = PlacementGroupRecord(
            p["pg_id"], p["bundles"], p["strategy"], p.get("name", ""),
            p.get("job_id"), p.get("lifetime"),
        )
        pg.creator = conn.meta.get("client_id")
        self.pgs[pg.pg_id] = pg
        self._persist_pg(pg)
        spawn(self._schedule_pg(pg))
        return {"pg_id": pg.pg_id}

    async def _schedule_pg(self, pg: PlacementGroupRecord):
        deadline = time.monotonic() + cfg.worker_lease_timeout_ms / 1000.0
        while pg.state == "PENDING" and time.monotonic() < deadline:
            placed = await self._try_place_pg(pg)
            if placed:
                return
            await asyncio.sleep(cfg.gcs_schedule_retry_interval_s)
        if pg.state == "PENDING":
            pg.state = "INFEASIBLE"
            self._persist_pg(pg)
            await self._publish("pg", pg.to_table())

    def _committed_rings(self, but: Optional[str] = None,
                         topo=None) -> dict:
        """Rings of committed gangs, excluding ``but`` (a re-placed PG
        must not contend against its own stale ring). Rings missing from
        the registry (a restarted GCS replays pg tables but not rings)
        are rebuilt from the replayed bundle_nodes when a topology is at
        hand."""
        if topo is not None:
            for pg in self.pgs.values():
                if (pg.state == "CREATED" and pg.pg_id != but
                        and pg.pg_id not in self._pg_rings):
                    self._pg_rings[pg.pg_id] = topo.ring_links(
                        [n for n in pg.bundle_nodes if n])
        return {
            pg_id: ring for pg_id, ring in self._pg_rings.items()
            if pg_id != but
            and (p := self.pgs.get(pg_id)) is not None
            and p.state == "CREATED"
        }

    def _idle_bundles(self, but: str) -> list:
        """Committed bundles with zero consumption — PENDING in the sense
        that nothing runs against their reserved resources yet, so they
        are safe to migrate. The GCS already sees this through the
        heartbeat view: a bundle's pg-formatted resources sit at full
        availability on its host iff no task/actor has claimed any of
        them. Rows: (pg_id, bundle_index, node_id, original_resources)."""
        from ray_tpu_torch._private.common import (RESOURCE_QUANT,
                                             rewrite_resources_for_pg)

        rows = []
        for pg in self.pgs.values():
            if pg.pg_id == but or pg.state != "CREATED":
                continue
            for idx, node_id in enumerate(pg.bundle_nodes):
                node = self.nodes.get(node_id) if node_id else None
                if node is None or not node.alive:
                    continue
                named = rewrite_resources_for_pg(
                    pg.bundles[idx], pg.pg_id, idx)
                if all(abs(node.resources_available.get(k, 0.0) - v)
                       < RESOURCE_QUANT / 2 for k, v in named.items()):
                    rows.append((pg.pg_id, idx, node_id,
                                 dict(pg.bundles[idx])))
        return rows

    async def _prepare_and_commit(self, pg_id: str, placements: list,
                                  bundles: list) -> bool:
        """2-phase reserve: prepare every (idx, node) row, cancel all on
        any failure, else commit all. ``placements`` is [(idx, node_id)]."""
        prepared = []
        ok = True
        for idx, node_id in placements:
            nconn = self.node_conns.get(node_id)
            if nconn is None:
                ok = False
                break
            try:
                # no rpc idem token: prepare/cancel cycles across
                # placement attempts would replay stale results.
                # Dedup is app-level — rpc_pg_prepare acks a bundle
                # it already holds without double-reserving.
                r = await nconn.request(
                    "pg_prepare",
                    {"pg_id": pg_id, "bundle_index": idx,
                     "resources": bundles[idx]},
                    timeout=cfg.gcs_rpc_timeout_s,
                )
            except Exception:
                ok = False
                break
            if not r.get("ok"):
                ok = False
                break
            prepared.append((idx, node_id))
        if not ok:
            for idx, node_id in prepared:
                nconn = self.node_conns.get(node_id)
                if nconn:
                    try:
                        await nconn.notify(
                            "pg_cancel",
                            {"pg_id": pg_id, "bundle_index": idx})
                    except Exception:
                        pass
            return False
        for idx, node_id in prepared:
            nconn = self.node_conns.get(node_id)
            try:
                if nconn is None:  # raylet died between prepare and commit
                    raise ConnectionError(f"raylet {node_id[:12]} gone")
                await nconn.request(
                    "pg_commit", {"pg_id": pg_id, "bundle_index": idx},
                    timeout=cfg.gcs_rpc_timeout_s,
                )
            except Exception:
                # roll every reservation back (committed or not —
                # pg_cancel pops the bundle either way) instead of
                # crashing the scheduling task and stranding the PG
                for i2, n2 in prepared:
                    c2 = self.node_conns.get(n2)
                    if c2:
                        try:
                            await c2.notify(
                                "pg_cancel",
                                {"pg_id": pg_id, "bundle_index": i2})
                        except Exception:
                            pass
                return False
        return True

    def _reset_pg_provenance(self, pg: PlacementGroupRecord):
        pg.node_coords = [None] * len(pg.bundles)
        pg.contention_score = None
        pg.sched_strategy = "resource-fit"
        pg.repack_moves = 0

    async def _requeue_pg(self, pg: PlacementGroupRecord):
        """A repack failure left this PG's reservations in doubt: return
        every bundle (best effort, idempotent raylet-side), reset the
        record to PENDING, and reschedule from scratch — a CREATED row
        pointing at a reservation no raylet holds would strand every
        actor targeting it as infeasible forever."""
        for idx, node_id in enumerate(pg.bundle_nodes):
            nconn = self.node_conns.get(node_id) if node_id else None
            if nconn:
                try:
                    await nconn.notify(
                        "pg_return",
                        {"pg_id": pg.pg_id, "bundle_index": idx})
                except Exception:
                    pass
        pg.state = "PENDING"
        pg.bundle_nodes = [None] * len(pg.bundles)
        self._reset_pg_provenance(pg)
        self._pg_rings.pop(pg.pg_id, None)
        self._persist_pg(pg)
        await self._publish("pg", pg.to_table())
        spawn(self._schedule_pg(pg))

    async def _execute_repack(self, moves: list, topo) -> bool:
        """Apply a repack plan (topology.plan_repack): migrate each idle
        bundle return->prepare->commit, updating its PG's table row and
        ring. A failed target prepare re-prepares on the origin (best
        effort); if even that fails — or the conditional release's fate
        is unknown (rpc error) — the victim PG is requeued for a fresh
        placement rather than left CREATED with a phantom reservation."""
        for mv in moves:
            src = self.node_conns.get(mv.from_node)
            dst = self.node_conns.get(mv.to_node)
            victim = self.pgs.get(mv.pg_id)
            if dst is None or src is None:
                return False
            try:
                # conditional release: the raylet is the authority on
                # whether the bundle is still idle — our heartbeat view
                # can be a beat stale, and a bundle a fresh actor just
                # claimed must not be migrated out from under it
                r = await src.request(
                    "pg_return_if_idle",
                    {"pg_id": mv.pg_id, "bundle_index": mv.bundle_index},
                    timeout=cfg.gcs_rpc_timeout_s)
            except Exception:
                # ambiguous: the raylet may have released before the rpc
                # failed — reconcile by re-placing the victim entirely
                if victim is not None:
                    await self._requeue_pg(victim)
                return False
            if not r.get("ok"):
                return False
            ok = await self._prepare_and_commit(
                mv.pg_id, [(mv.bundle_index, mv.to_node)],
                {mv.bundle_index: mv.resources})
            if not ok:
                restored = await self._prepare_and_commit(
                    mv.pg_id, [(mv.bundle_index, mv.from_node)],
                    {mv.bundle_index: mv.resources})
                if not restored and victim is not None:
                    await self._requeue_pg(victim)
                return False
            moved_pg = self.pgs.get(mv.pg_id)
            if moved_pg is not None:
                moved_pg.bundle_nodes[mv.bundle_index] = mv.to_node
                moved_pg.repack_moves += 1
                if topo is not None:
                    from ray_tpu_torch._private import topology as topo_mod

                    coord = topo.coords.get(mv.to_node)
                    moved_pg.node_coords[mv.bundle_index] = (
                        topo_mod.format_coord(coord)
                        if coord is not None else None)
                    self._pg_rings[mv.pg_id] = topo.ring_links(
                        [n for n in moved_pg.bundle_nodes if n])
                self._persist_pg(moved_pg)
                await self._publish("pg", moved_pg.to_table())
            self._sched_repacks += 1
            self._record_event(
                "INFO", "gcs", "PG_REPACK",
                f"migrated bundle {mv.bundle_index} of pg "
                f"{mv.pg_id[:12]} {mv.from_node[:12]} -> "
                f"{mv.to_node[:12]} (defragmentation)",
                {"pg_id": mv.pg_id, "bundle_index": mv.bundle_index,
                 "from_node": mv.from_node, "to_node": mv.to_node},
            )
        return True

    async def _try_place_pg(self, pg: PlacementGroupRecord) -> bool:
        from ray_tpu_torch._private import topology as topo_mod

        # The lock covers one atomic place+prepare+commit attempt so two PGs
        # don't interleave reservations; waiting happens outside it.
        async with self._pg_lock:
            nodes = [n for n in self.nodes.values() if n.alive]
            topo = (topo_mod.Topology.from_nodes(nodes)
                    if cfg.sched_topology_enabled else None)
            committed = self._committed_rings(but=pg.pg_id, topo=topo)
            # one dispatch point for both worlds: the wrapper takes the
            # contention path when a topology is passed and the untouched
            # native/py resource-fit path otherwise
            placement = place_bundles(nodes, pg.bundles, pg.strategy,
                                      topology=topo,
                                      committed_rings=committed)
            moves: list = []
            if placement is None and topo is not None \
                    and pg.strategy == "STRICT_SPREAD":
                # fragmentation repack: migrate committed-but-unused
                # bundles of other gangs to open enough distinct nodes.
                # Topology-gated on purpose — the degrade contract says a
                # coord-less cluster behaves byte-identically to the old
                # resource-fit path, which never migrated anything.
                plan = topo_mod.plan_repack(
                    nodes, pg.bundles, pg.strategy,
                    self._idle_bundles(but=pg.pg_id),
                    max_moves=cfg.sched_repack_max_moves)
                if plan is not None:
                    placement, moves = plan
            if placement is None:
                return False
            if moves and not await self._execute_repack(moves, topo):
                return False
            if not await self._prepare_and_commit(
                    pg.pg_id, list(enumerate(placement)), pg.bundles):
                return False
            pg.bundle_nodes = list(placement)
            pg.state = "CREATED"
            pg.repack_moves = len(moves)
            if topo is not None:
                pg.node_coords = [
                    topo_mod.format_coord(topo.coords[nid])
                    if nid in topo.coords else None
                    for nid in placement
                ]
                self._pg_rings[pg.pg_id] = topo.ring_links(placement)
                if moves:
                    # the repack rewrote other gangs' rings: score against
                    # the CURRENT registry, not the pre-repack snapshot,
                    # and label the provenance honestly (plan_repack
                    # places by resource fit, not contention)
                    committed = self._committed_rings(but=pg.pg_id)
                score = topo.score(placement, committed)
                pg.contention_score = float(score.contention)
                pg.sched_strategy = ("topology-repack" if moves
                                     else "topology-contention")
            else:
                pg.node_coords = [None] * len(placement)
                pg.contention_score = None
                pg.sched_strategy = "resource-fit"
            self._persist_pg(pg)
            await self._publish("pg", pg.to_table())
            return True

    async def rpc_wait_placement_group(self, conn: Connection, p):
        deadline = time.monotonic() + p.get("timeout", cfg.gcs_rpc_timeout_s)
        while time.monotonic() < deadline:
            pg = self.pgs.get(p["pg_id"])
            if pg is None:
                return None
            # INFEASIBLE is NOT terminal: the autoscaler may be
            # provisioning the slice right now, and node registration
            # flips the PG back to PENDING — so waiters keep waiting.
            if pg.state in ("CREATED", "REMOVED"):
                return pg.to_table()
            await asyncio.sleep(0.02)
        pg = self.pgs.get(p["pg_id"])
        return pg.to_table() if pg else None

    async def rpc_remove_placement_group(self, conn: Connection, p):
        await self._remove_pg(p["pg_id"])
        return {}

    async def _remove_pg(self, pg_id: str):
        pg = self.pgs.get(pg_id)
        if pg is None or pg.state == "REMOVED":
            return
        for idx, node_id in enumerate(pg.bundle_nodes):
            if node_id is None:
                continue
            nconn = self.node_conns.get(node_id)
            if nconn:
                try:
                    await nconn.notify("pg_return", {"pg_id": pg_id, "bundle_index": idx})
                except Exception:
                    pass
        pg.state = "REMOVED"
        self._pg_rings.pop(pg_id, None)
        self._persist_pg(pg)
        await self._publish("pg", pg.to_table())

    async def rpc_pg_table(self, conn: Connection, p):
        if p and p.get("pg_id"):
            pg = self.pgs.get(p["pg_id"])
            return pg.to_table() if pg else None
        return [pg.to_table() for pg in self.pgs.values()]

    # ------------------------------------------------------------------
    # On-demand profiling (profiler.py): cluster-wide fan-out + merge
    # ------------------------------------------------------------------
    def _profiler(self):
        svc = getattr(self, "_profiler_svc", None)
        if svc is None:
            from ray_tpu_torch._private import profiler

            svc = self._profiler_svc = profiler.ProfilerService(role="gcs")
        return svc

    async def rpc_profile_start(self, conn: Connection, p):
        return self._profiler().start(p or {})

    async def rpc_profile_stop(self, conn: Connection, p):
        return self._profiler().stop(p or {})

    async def rpc_profile_status(self, conn: Connection, p):
        return self._profiler().status()

    async def rpc_profile_cluster(self, conn: Connection, p):
        """Fan one profiling window out to every (or one) node's raylet —
        which fans out to its workers — and merge the results: summed
        collapsed stacks (cpu) or summed per-site deltas (mem), plus the
        per-process results for slicing (ray parity: the dashboard's
        per-pid py-spy attach, lifted to one cluster-wide operation)."""
        from ray_tpu_torch._private import profiler
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

        p = dict(p or {})
        kind = p.get("kind", "cpu")
        duration = min(float(p.get("duration") or 5.0),
                       cfg.profiler_max_duration_s)
        p["duration"] = duration
        node_filter = p.get("node_id")
        targets = []
        for nid, nconn in list(self.node_conns.items()):
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                continue
            if node_filter and not nid.startswith(node_filter):
                continue
            targets.append((nid, nconn))

        async def one(nid: str, nconn: Connection):
            try:
                reply = await nconn.request(
                    "profile_node", p, timeout=duration + 45.0
                )
                return reply.get("processes") or []
            except Exception as e:
                return [{"node_id": nid,
                         "error": f"{type(e).__name__}: {e}"}]

        jobs = [one(nid, nconn) for nid, nconn in targets]
        if p.get("include_gcs") and not node_filter:
            async def self_prof():
                out = await self._profiler().run(p)
                return [out]

            jobs.append(self_prof())
        per_node = await asyncio.gather(*jobs)
        processes = [proc for node_list in per_node for proc in node_list]
        merged = profiler.merge_profiles(processes, kind=kind)
        merged["duration_s"] = duration
        merged["nodes"] = len(targets)
        return merged

    # ------------------------------------------------------------------
    # Metrics plane (metrics_core.py): cluster-wide scrape fan-out+merge
    # ------------------------------------------------------------------
    async def rpc_metrics_snapshot(self, conn: Connection, p):
        from ray_tpu_torch._private import metrics_core

        return metrics_core.process_snapshot("gcs")

    async def _scrape_processes(self, node_method: str, driver_method: str,
                                timeout: float, tag_drivers: bool = False):
        """Shared cluster-scrape fan-out (metrics_cluster and
        steptrace_cluster differ only in verb names + post-processing):
        every live raylet's node verb (which fans to its workers) plus
        every registered DRIVER connection's snapshot verb, gathered
        concurrently, unreachable targets folded to error dicts. Returns
        ``(processes, n_nodes)``."""

        async def node(nid: str, nconn: Connection):
            try:
                reply = await nconn.request(node_method, {},
                                            timeout=timeout)
                return reply.get("processes") or []
            except Exception as e:
                return [{"node_id": nid,
                         "error": f"{type(e).__name__}: {e}"}]

        async def driver(cid: str, cconn: Connection):
            try:
                out = await cconn.request(driver_method, {},
                                          timeout=timeout)
                if tag_drivers:
                    out.setdefault("node_id", f"driver:{cid}")
                return [out]
            except Exception as e:
                return [{"client_id": cid,
                         "error": f"{type(e).__name__}: {e}"}]

        jobs = []
        n_nodes = 0
        for nid, nconn in list(self.node_conns.items()):
            info = self.nodes.get(nid)
            if info is None or not info.alive:
                continue
            n_nodes += 1
            jobs.append(node(nid, nconn))
        for cid, cconn in list(self.client_conns.items()):
            if cconn.meta.get("is_driver") and not cconn.closed:
                jobs.append(driver(cid, cconn))
        per = await asyncio.gather(*jobs)
        return [proc for plist in per for proc in plist], n_nodes

    async def rpc_metrics_cluster(self, conn: Connection, p):
        """One cluster-wide scrape: fan to every live raylet (which fans
        to its workers), every registered DRIVER connection (user metrics
        live in driver processes; workers are already covered through
        their raylet), plus this GCS — then merge (sum counters/gauges,
        merge histogram buckets). Mirrors profile_cluster's shape, but
        cheap enough to poll: one snapshot is a dict copy per process,
        no sampling window."""
        from ray_tpu_torch._private import metrics_core

        processes, n_nodes = await self._scrape_processes(
            "metrics_node", "metrics_snapshot",
            cfg.metrics_scrape_timeout_s)
        processes.append(metrics_core.process_snapshot("gcs"))
        ok = [proc for proc in processes if not proc.get("error")]
        merged = metrics_core.merge_snapshots(
            [proc.get("metrics") or {} for proc in ok])
        return {
            "merged": merged,
            "processes": processes,
            "nodes": n_nodes,
            "record_calls": sum(proc.get("record_calls", 0) for proc in ok),
            "errors": [proc for proc in processes if proc.get("error")],
        }

    # ------------------------------------------------------------------
    # Step observatory (steptrace.py): per-step/per-collective telemetry
    # fan-out + (group, seq) arrival-skew merge
    # ------------------------------------------------------------------
    async def rpc_steptrace_cluster(self, conn: Connection, p):
        """One cluster-wide step-telemetry scrape: fan to every live
        raylet (which fans to its workers) plus registered DRIVER
        connections (a driver can be a collective rank too), then

        1. fold the NEW collective records into the rolling skew metrics
           (``collective_skew_seconds{rank=}`` histograms + per-rank
           ``steptrace_straggler_score`` gauge) — they live in THIS
           process's registry, so they ride the existing /metrics
           cluster scrape with no extra plumbing;
        2. join per-rank records by (group, seq) into the merged
           multi-rank view the train timeline renders.

        Mirrors metrics_cluster's shape; the fold is idempotent across
        repeated scrapes (per-process record indices high-water-mark)."""
        from ray_tpu_torch._private import steptrace

        processes, _ = await self._scrape_processes(
            "steptrace_node", "steptrace_snapshot",
            cfg.steptrace_scrape_timeout_s, tag_drivers=True)
        agg = self._steptrace_agg
        if agg is None:
            agg = self._steptrace_agg = steptrace.SkewAggregator()
        # The merge runs over the aggregator's ACCUMULATED log, not just
        # this scrape: the timeline must survive the workers that
        # produced it (a trainer's shutdown scrape drains the gang's
        # rings here right before the actors die). fold + log copy +
        # merge are all CPU-bound python over up to log_limit records —
        # the whole thing runs on an executor thread (the aggregator is
        # internally locked) so a full log never stalls the GCS event
        # loop; ?limit caps the merge to the newest N records for cheap
        # polling surfaces.
        merged = await asyncio.get_running_loop().run_in_executor(
            None, agg.fold_and_merge, processes,
            (p or {}).get("limit") or 0)
        merged["processes"] = len(processes)
        merged["errors"] = [proc for proc in processes
                            if proc.get("error")]
        return merged

    # ------------------------------------------------------------------
    # Request observatory (reqtrace.py): per-request serve tracing
    # fan-out + request-id join into phase breakdowns and skew verdicts
    # ------------------------------------------------------------------
    async def rpc_reqtrace_cluster(self, conn: Connection, p):
        """One cluster-wide serve request-trace scrape: fan to every
        live raylet (serve proxies and replicas are actors in worker
        processes) plus registered DRIVER connections (handle-direct
        callers record route spans driver-side), then

        1. fold the NEW spans into the rolling request metrics
           (``serve_request_phase_seconds{app,deployment,phase}`` +
           ``serve_request_ttft_seconds``) — they live in THIS process's
           registry, so they ride the existing /metrics cluster scrape;
        2. join proxy+replica records by request id into per-request
           phase breakdowns, per-deployment p50/p95/p99, per-replica
           phase profiles, and slow-replica skew verdicts.

        The merge runs over the aggregator's ACCUMULATED log, not just
        this scrape — the request timeline survives the proxies/replicas
        that produced it. Mirrors steptrace_cluster's posture: the fold
        is idempotent across repeated scrapes (per-process record-index
        high-water marks) and the CPU-bound fold+merge runs on an
        executor thread; ?limit caps the merge for polling surfaces."""
        from ray_tpu_torch._private import reqtrace

        processes, _ = await self._scrape_processes(
            "reqtrace_node", "reqtrace_snapshot",
            cfg.reqtrace_scrape_timeout_s, tag_drivers=True)
        agg = self._reqtrace_agg
        if agg is None:
            agg = self._reqtrace_agg = reqtrace.RequestAggregator()
        merged = await asyncio.get_running_loop().run_in_executor(
            None, agg.fold_and_merge, processes,
            (p or {}).get("limit") or 0)
        ok = [proc for proc in processes if not proc.get("error")]
        merged["processes"] = len(processes)
        merged["dropped"] = sum(proc.get("dropped", 0) for proc in ok)
        # cluster-wide record-attempt count: the overhead bench lane's
        # zero-records-when-disabled gate reads this
        merged["record_calls"] = sum(proc.get("record_calls", 0)
                                     for proc in ok)
        merged["errors"] = [proc for proc in processes
                            if proc.get("error")]
        return merged

    # ------------------------------------------------------------------
    # Memory observatory (memview.py): object lifecycle + arena
    # introspection fan-out, joined into leak/pressure verdicts
    # ------------------------------------------------------------------
    async def rpc_memview_cluster(self, conn: Connection, p):
        """One cluster-wide object-plane scrape: fan to every live
        raylet (store ledger + arena introspection + its workers' owner
        tables) plus registered DRIVER connections (drivers own most
        objects), then join store rows against the union of every
        process's reference set — an object resident in a store that NO
        process references is an unreachable-yet-undeleted leak, grouped
        by its creation callsite. The GCS object directory contributes
        locations. Merge runs on an executor thread (pure python over
        potentially 10k rows), mirroring steptrace_cluster's posture."""
        from ray_tpu_torch._private import memview

        processes, n_nodes = await self._scrape_processes(
            "memview_node", "memview_snapshot",
            cfg.memview_scrape_timeout_s, tag_drivers=True)
        locations = {
            oid.hex(): sorted(nodes)
            for oid, nodes in list(self.object_dir.items())[:50_000]
        }
        merged = await asyncio.get_running_loop().run_in_executor(
            None, memview.merge_cluster, processes, locations)
        merged["nodes"] = n_nodes
        merged["errors"] = [proc for proc in processes
                            if proc.get("error")]
        return merged

    # ------------------------------------------------------------------
    # Task events (observability; ray: gcs_task_manager.h)
    # ------------------------------------------------------------------
    async def rpc_list_objects(self, conn: Connection, p):
        """Object directory view for the state API (centralized analog of
        ray: dashboard/state_aggregator.py list_objects)."""
        limit = (p or {}).get("limit") or 10_000
        out = []
        for oid, nodes in list(self.object_dir.items())[:limit]:
            out.append({"object_id": oid.hex(), "locations": sorted(nodes)})
        return out

    async def rpc_add_task_events(self, conn: Connection, p):
        self.task_events.extend(p["events"])
        overflow = len(self.task_events) - cfg.task_events_buffer_size
        if overflow > 0:
            del self.task_events[:overflow]
        return {}

    async def rpc_list_task_events(self, conn: Connection, p):
        return self.task_events[-(p.get("limit") or 1000):]
