"""ServeController: the reconciliation brain of Serve.

Reference parity: ray python/ray/serve/controller.py:75 (ServeController) +
_private/deployment_state.py (replica-set reconciliation, rolling updates)
+ _private/autoscaling_policy.py — one named actor owning the desired app
specs, running a control loop that (a) starts/stops replica actors to match
target counts, (b) health-checks them, (c) autoscales replica counts from
per-replica ongoing-request metrics.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve._common import (
    ROUTES_PUSH_CHANNEL,
    REPLICA_PUSH_CHANNEL,
    SERVE_NAMESPACE,
    AutoscalingConfig,
    DeploymentConfig,
    ReplicaInfo,
)

logger = logging.getLogger(__name__)

def _control_loop_period() -> float:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.serve_control_loop_period_s


class _DeploymentState:
    def __init__(self, app: str, config: DeploymentConfig,
                 serialized_init: bytes):
        self.app = app
        self.config = config
        self.serialized_init = serialized_init
        self.replicas: Dict[str, Any] = {}  # actor_name -> handle
        # replica-reported queue lengths, refreshed each control-loop pass;
        # handles read these for load-aware p2c routing (ray parity:
        # _private/router.py:262 replica queue-len probes)
        self.loads: Dict[str, float] = {}
        self.loads_ts: Optional[float] = None  # when loads were collected
        # LLM engine ride-alongs from the same probe (queued sequences +
        # prefix digest): replica_name -> report dict. Empty for plain
        # deployments — get_replica_state stays byte-identical for them.
        self.llm: Dict[str, dict] = {}
        self.target = config.num_replicas
        self.autoscaling = AutoscalingConfig.from_dict(
            config.autoscaling_config
        )
        if self.autoscaling:
            self.target = self.autoscaling.min_replicas
        self.version = uuid.uuid4().hex[:8]
        # replicas of the previous version, kept serving until the new
        # version reaches its target (rolling update)
        self.draining: Dict[str, Any] = {}
        self._last_scale_up = 0.0
        self._last_scale_down = 0.0
        self.consecutive_start_failures = 0
        self.broken = False  # too many failed starts: stop retrying

    @property
    def name(self) -> str:
        return self.config.name


class ServeController:
    def __init__(self):
        self._apps: Dict[str, Dict[str, _DeploymentState]] = {}
        self._lock = threading.RLock()
        self._shutdown = threading.Event()
        # proxy fleet: node_id -> {"name", "handle", "port", "grpc_port"}
        self._proxies: Dict[str, dict] = {}
        self._proxy_cfg: Optional[dict] = None
        # serializes fleet reconciliation (ensure_proxy vs control loop)
        self._proxy_reconcile_lock = threading.Lock()
        self._loop_thread = threading.Thread(
            target=self._control_loop, daemon=True
        )
        self._loop_thread.start()

    # ------------------------------------------------------------------
    # API called by serve.run / serve.delete / handles / proxy
    # ------------------------------------------------------------------
    def deploy_app(self, app_name: str, deployments: List[dict],
                   ingress: str, route_prefix: Optional[str]):
        to_stop: List[_DeploymentState] = []
        with self._lock:
            old = self._apps.get(app_name, {})
            new: Dict[str, _DeploymentState] = {}
            for d in deployments:
                cfg: DeploymentConfig = d["config"]
                st = old.get(cfg.name)
                if st is not None and st.serialized_init == d["init"] and \
                        st.config == cfg:
                    # unchanged: keep replicas, but a redeploy always earns
                    # a fresh chance — clear the give-up state so the
                    # control loop retries failed starts
                    st.broken = False
                    st.consecutive_start_failures = 0
                    new[cfg.name] = st
                else:
                    fresh = _DeploymentState(app_name, cfg, d["init"])
                    if st is not None:
                        # rolling update: old replicas serve until the new
                        # version is at target, then drain
                        fresh.draining = {**st.draining, **st.replicas}
                    new[cfg.name] = fresh
            for name, st in old.items():
                if name not in new:
                    to_stop.append(st)
            self._apps[app_name] = new
            self._app_meta = getattr(self, "_app_meta", {})
            self._app_meta[app_name] = {
                "ingress": ingress,
                "route_prefix": route_prefix if route_prefix is not None
                else f"/{app_name}" if app_name != "default" else "/",
            }
        # graceful stops block up to graceful_shutdown_timeout_s per replica:
        # do them after releasing the lock so control RPCs stay responsive
        if to_stop:
            self._drain_reqtrace()
        for st in to_stop:
            self._stop_all(st)
        self._push_routes()
        return True

    def delete_app(self, app_name: str):
        with self._lock:
            app = self._apps.pop(app_name, None)
            getattr(self, "_app_meta", {}).pop(app_name, None)
        if app:
            self._drain_reqtrace()
            for st in app.values():
                self._stop_all(st)
                self._push_replicas(st)
        self._push_routes()
        return True

    def _drain_reqtrace(self):
        """Fold dying replicas' trace rings into the GCS aggregator's
        accumulated log before killing them, so the deployment's request
        history stays queryable after delete/shutdown (steptrace parity:
        BackendExecutor fires one final scrape before the gang dies)."""
        from ray_tpu_torch._private import reqtrace

        if not reqtrace.is_enabled():
            return
        try:
            from ray_tpu_torch._private.worker import global_worker

            cw = global_worker.core_worker
            cw.io.run(cw.gcs.request("reqtrace_cluster", {"limit": 1}))
        except Exception:  # best-effort: trace history is an observability nicety
            logger.debug("final reqtrace drain failed", exc_info=True)

    def wait_for_ready(self, app_name: str, timeout_s: float = 60.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                app = self._apps.get(app_name)
                if app is not None:
                    if any(st.broken for st in app.values()):
                        return False  # fail fast: constructor keeps raising
                    if all(
                        len(st.replicas) >= st.target for st in app.values()
                    ):
                        return True
            time.sleep(0.05)
        return False

    def get_replica_names(self, app_name: str, deployment: str) -> List[str]:
        with self._lock:
            app = self._apps.get(app_name) or {}
            st = app.get(deployment)
            if st is None:
                return []
            # during a rolling update, route to the old version until the
            # new one has live replicas
            return list(st.replicas.keys()) or list(st.draining.keys())

    def get_replica_state(self, app_name: str, deployment: str) -> dict:
        """Replica names + reported queue lengths in one round trip
        (handles route with p2c over these loads). ``loads_age_s`` is how
        old the load snapshot already is at reply time — handles age it
        further and fall back to local inflight counts past the
        staleness threshold (serve_replica_report_max_age_s)."""
        with self._lock:
            app = self._apps.get(app_name) or {}
            st = app.get(deployment)
            if st is None:
                return {"names": [], "loads": {}, "loads_age_s": None}
            names = list(st.replicas.keys()) or list(st.draining.keys())
            loads_ts = getattr(st, "loads_ts", None)
            out = {
                "names": names, "loads": dict(st.loads),
                "loads_age_s": (time.time() - loads_ts)
                if loads_ts is not None else None,
            }
            # prefix digests ride only when replicas actually report
            # them AND the deployment hasn't opted out — plain
            # deployments get the exact legacy payload
            llm = getattr(st, "llm", None)
            if llm and getattr(st.config, "prefix_affinity", None) \
                    is not False:
                out["llm"] = {n: dict(r) for n, r in llm.items()}
            return out

    def get_routes(self) -> Dict[str, tuple]:
        """route_prefix -> (app_name, ingress deployment)."""
        with self._lock:
            meta = getattr(self, "_app_meta", {})
            return {
                m["route_prefix"]: (app, m["ingress"])
                for app, m in meta.items()
                if app in self._apps
            }

    def get_serve_status(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for app, deps in self._apps.items():
                out[app] = {
                    "deployments": {
                        name: {
                            "target_replicas": st.target,
                            "running_replicas": len(st.replicas),
                            "version": st.version,
                        }
                        for name, st in deps.items()
                    },
                    **getattr(self, "_app_meta", {}).get(app, {}),
                }
            return out

    def shutdown(self):
        self._shutdown.set()
        with self._lock:
            apps = list(self._apps)
        for app in apps:
            self.delete_app(app)
        self._stop_proxies()
        return True

    # ------------------------------------------------------------------
    # config push (long-poll analog)
    # ------------------------------------------------------------------
    def _publish(self, channel: str, message):
        try:
            from ray_tpu_torch._private.worker import global_worker

            global_worker.core_worker.publish(channel, message)
        except Exception:  # pubsub is an optimization; polling covers us
            logger.debug("serve config push failed", exc_info=True)

    def _push_replicas(self, st: _DeploymentState):
        self._publish(
            REPLICA_PUSH_CHANNEL, {"app": st.app, "deployment": st.name}
        )

    def _push_routes(self):
        self._publish(ROUTES_PUSH_CHANNEL, {"routes": self.get_routes()})

    # ------------------------------------------------------------------
    # reconciliation
    # ------------------------------------------------------------------
    def _control_loop(self):
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
                self._reconcile_proxies()
                self._collect_loads()
                self._autoscale_once()
            except Exception:  # noqa: BLE001 — loop must survive
                logger.exception("serve control loop iteration failed")
            self._shutdown.wait(_control_loop_period())

    def _reconcile_once(self):
        import ray_tpu_torch

        with self._lock:
            states = [
                st for app in self._apps.values() for st in app.values()
            ]
        for st in states:
            before = set(st.replicas)
            self._reconcile_state(st)
            if set(st.replicas) != before:
                self._push_replicas(st)

    def _reconcile_state(self, st: _DeploymentState):
        import ray_tpu_torch

        # scale up (bounded per pass; a constructor that keeps failing
        # marks the deployment broken instead of spinning the loop and
        # starving every other deployment)
        while len(st.replicas) < st.target and not st.broken:
            name = (
                f"SERVE_REPLICA::{st.app}#{st.name}#"
                f"{uuid.uuid4().hex[:6]}"
            )
            from ray_tpu_torch.serve.replica import Replica

            opts = st.config.replica_actor_options()
            # detached: replicas must survive the deploying driver's job
            # teardown (the controller kills them explicitly on delete/
            # scale-down/unhealthy) — a non-detached replica dies with
            # the driver, bouncing the deployment and losing its traces
            opts.setdefault("lifetime", "detached")
            actor_cls = ray_tpu_torch.remote(
                name=name,
                namespace=SERVE_NAMESPACE,
                max_concurrency=st.config.max_ongoing_requests,
                **opts,
            )(Replica)
            handle = actor_cls.remote(
                st.serialized_init, st.name, st.app,
                st.config.user_config, st.config.max_ongoing_requests,
                replica_name=name,
            )
            # block until constructed so wait_for_ready means servable
            try:
                ray_tpu_torch.get(handle.check_health.remote(), timeout=60)
            except Exception:
                logger.exception("replica %s failed to start", name)
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:
                    pass
                st.consecutive_start_failures += 1
                if st.consecutive_start_failures >= 3:
                    logger.error(
                        "deployment %s/%s: %d consecutive replica start "
                        "failures; giving up until redeployed",
                        st.app, st.name, st.consecutive_start_failures,
                    )
                    st.broken = True
                break
            st.consecutive_start_failures = 0
            with self._lock:
                # the app may have been deleted/redeployed while we
                # blocked on the health check: registering on a stale
                # state would leak a live named replica actor
                current = (self._apps.get(st.app) or {}).get(st.name)
                if current is not st:
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
                    break
                st.replicas[name] = handle
        # rolling update: drain old-version replicas once at target
        if st.draining and len(st.replicas) >= st.target:
            with self._lock:
                drained, st.draining = dict(st.draining), {}
            self._drain_reqtrace()
            for handle in drained.values():
                self._graceful_stop(st, handle)
        # scale down
        if len(st.replicas) > st.target:
            self._drain_reqtrace()
        while len(st.replicas) > st.target:
            with self._lock:
                name, handle = next(iter(st.replicas.items()))
                del st.replicas[name]
            self._graceful_stop(st, handle)
        # health check, on the configured period (not every loop pass)
        now = time.time()
        if now - getattr(st, "_last_health_check", 0.0) >= \
                st.config.health_check_period_s:
            st._last_health_check = now
            for name, handle in list(st.replicas.items()):
                try:
                    ray_tpu_torch.get(handle.check_health.remote(), timeout=30)
                except Exception:
                    logger.warning("replica %s unhealthy; replacing", name)
                    with self._lock:
                        st.replicas.pop(name, None)
                    # no drain here: the one ring worth saving belongs to
                    # the wedged replica, which won't answer the scrape —
                    # it would only stall the replace by the scrape timeout
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass

    def _collect_loads(self):
        """Refresh per-replica queue lengths for every deployment (handles
        read them through get_replica_state for load-aware routing; the
        autoscaler reads them for scaling decisions).

        All probes fan out first and share one 10s budget, so a few wedged
        replicas cannot stall the control loop for 10s each. A replica
        that does not answer scores +inf — handles must steer AWAY from an
        unresponsive replica, not prefer it as idle — until the health
        check replaces it."""
        import ray_tpu_torch

        with self._lock:
            states = [
                st for app in self._apps.values() for st in app.values()
            ]
        probes = []  # (state, replica_name, ref)
        for st in states:
            if not st.replicas:
                st.loads = {}
                st.llm = {}
                continue
            for name, h in list(st.replicas.items()):
                probes.append((st, name, h.get_metrics.remote()))
        if not probes:
            return
        new_loads: Dict[int, Dict[str, float]] = {}
        new_llm: Dict[int, Dict[str, dict]] = {}
        deadline = time.time() + 10.0
        for st, name, ref in probes:
            loads = new_loads.setdefault(id(st), {})
            llm = new_llm.setdefault(id(st), {})
            try:
                remaining = max(0.1, deadline - time.time())
                m = ray_tpu_torch.get(ref, timeout=remaining)
                loads[name] = float(m["ongoing"])
                if isinstance(m.get("llm"), dict):
                    llm[name] = m["llm"]
            except Exception:
                loads[name] = float("inf")
        done_at = time.time()
        for st in states:
            if id(st) in new_loads:
                st.loads = new_loads[id(st)]
                st.llm = new_llm.get(id(st), {})
                st.loads_ts = done_at  # freshness stamp the handles age

    def _autoscale_once(self):
        with self._lock:
            states = [
                st for app in self._apps.values() for st in app.values()
                if st.autoscaling
            ]
        for st in states:
            ac = st.autoscaling
            if not st.replicas:
                continue
            # inf marks an unresponsive replica (routing signal); it must
            # not launch max_replicas here
            ongoing = sum(
                v for v in st.loads.values() if v != float("inf")
            )
            desired = max(
                ac.min_replicas,
                min(
                    ac.max_replicas,
                    int(-(-ongoing // max(ac.target_ongoing_requests, 1e-9)))
                    if ongoing else ac.min_replicas,
                ),
            )
            now = time.time()
            if desired > st.target and now - st._last_scale_up >= ac.upscale_delay_s:
                st.target = desired
                st._last_scale_up = now
            elif desired < st.target and \
                    now - st._last_scale_down >= ac.downscale_delay_s:
                st.target = desired
                st._last_scale_down = now

    # ------------------------------------------------------------------
    def _graceful_stop(self, st: _DeploymentState, handle):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                handle.prepare_shutdown.remote(
                    st.config.graceful_shutdown_timeout_s
                ),
                timeout=st.config.graceful_shutdown_timeout_s + 5,
            )
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def _stop_all(self, st: _DeploymentState):
        for handle in list(st.replicas.values()) + list(st.draining.values()):
            self._graceful_stop(st, handle)
        st.replicas.clear()
        st.draining.clear()

    # ------------------------------------------------------------------
    # proxy fleet management (ray parity: serve/_private/proxy_state.py
    # ProxyStateManager — one ProxyActor per alive node, HTTP + gRPC)
    # ------------------------------------------------------------------
    def ensure_proxy(self, host: str, port: int,
                     grpc_servicer_functions=None) -> int:
        """Start (or reconcile) one proxy per alive node; returns the
        head/first proxy's HTTP port for serve.start compat."""
        import ray_tpu_torch

        with self._lock:
            started = self._proxy_cfg is not None
            self._proxy_cfg = {"host": host, "port": port,
                               "grpc_servicer_functions":
                               list(grpc_servicer_functions or ())}
            if started and self._proxies:
                # fast path: the control loop maintains the fleet; don't
                # make every serve.run pay a full reconcile pass
                me = ray_tpu_torch.get_runtime_context().get_node_id()
                entry = self._proxies.get(me) \
                    or next(iter(self._proxies.values()))
                return entry["port"]
        # BLOCK on the reconcile lock: a control-loop pass may be mid-
        # flight — waiting for it (or running our own pass) is what makes
        # serve.start deterministic
        self._reconcile_proxies(block=True)
        with self._lock:
            if not self._proxies:
                raise RuntimeError("no serve proxy could be started")
            me = ray_tpu_torch.get_runtime_context().get_node_id()
            entry = self._proxies.get(me) or next(iter(self._proxies.values()))
            return entry["port"]

    def get_proxies(self) -> Dict[str, dict]:
        """node_id -> {"name", "port", "grpc_port"} for every live proxy."""
        with self._lock:
            return {
                nid: {k: e[k] for k in ("name", "port", "grpc_port")}
                for nid, e in self._proxies.items()
            }

    def _reconcile_proxies(self, block: bool = False):
        """One proxy actor per alive node: start missing ones (node joins,
        proxy crashes), drop records of dead nodes. Runs from ensure_proxy
        (blocking) and every control-loop pass (skipped if one is already
        running) once a fleet is requested."""
        with self._lock:
            cfg = getattr(self, "_proxy_cfg", None)
        if cfg is None:
            return
        if not self._proxy_reconcile_lock.acquire(blocking=block):
            return
        try:
            self._reconcile_proxies_locked(cfg)
        finally:
            self._proxy_reconcile_lock.release()

    def _reconcile_proxies_locked(self, cfg: dict):
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        try:
            nodes = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        except Exception:
            return
        alive_ids = {n["node_id"] for n in nodes}
        pinged = {}
        with self._lock:
            for nid in list(self._proxies):
                if nid not in alive_ids:
                    del self._proxies[nid]
                    continue
                try:
                    pinged[nid] = self._proxies[nid]["handle"].ready.remote()
                except Exception:
                    # submission itself failed: the actor is gone
                    del self._proxies[nid]
        # liveness pings fan out with ONE shared deadline — a wedged
        # proxy must not stall the pass 10s per node. An errored ref (the
        # proxy actor died) counts as "ready" to wait(), so confirm each
        # ready ping with a cheap get.
        if pinged:
            ready, _ = ray_tpu_torch.wait(
                list(pinged.values()), num_returns=len(pinged), timeout=10
            )
            ready_set = {r.binary() for r in ready}
            for nid, ref in pinged.items():
                ok = False
                if ref.binary() in ready_set:
                    try:
                        ray_tpu_torch.get(ref, timeout=5)
                        ok = True
                    except Exception:
                        ok = False
                if not ok:
                    with self._lock:
                        self._proxies.pop(nid, None)
        from ray_tpu_torch.serve.proxy import HTTPProxy

        started = []  # (nid, name, handle)
        for n in nodes:
            nid = n["node_id"]
            with self._lock:
                if (nid in self._proxies or self._proxy_cfg is None
                        or self._shutdown.is_set()):
                    continue
            name = f"SERVE_PROXY:{nid[:12]}"
            try:
                try:
                    proxy_cls = ray_tpu_torch.remote(
                        num_cpus=0, name=name, max_concurrency=1000,
                        namespace=SERVE_NAMESPACE,
                        lifetime="detached",  # survive driver-job teardown
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            node_id=nid, soft=False
                        ),
                    )(HTTPProxy)
                    handle = proxy_cls.remote(
                        cfg["host"], cfg["port"],
                        grpc_servicer_functions=cfg.get(
                            "grpc_servicer_functions"
                        ),
                    )
                except ValueError:
                    # name taken: an earlier pass (or a controller
                    # restart) already created it — adopt it
                    handle = ray_tpu_torch.get_actor(
                        name, namespace=SERVE_NAMESPACE)
            except Exception:
                logger.exception("failed to create serve proxy on node %s",
                                 nid[:12])
                continue
            started.append((nid, name, handle))
        # readiness waits fan out too (shared deadline across the fleet)
        for nid, name, handle in started:
            try:
                port = ray_tpu_torch.get(handle.ready.remote(), timeout=60)
                grpc_port = ray_tpu_torch.get(handle.grpc_port.remote(), timeout=30)
            except Exception:
                logger.exception("serve proxy on node %s failed to become "
                                 "ready", nid[:12])
                continue
            with self._lock:
                if self._proxy_cfg is None or self._shutdown.is_set():
                    # shutdown raced us: don't leak the fresh proxy
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
                    continue
                self._proxies[nid] = {
                    "name": name, "handle": handle, "port": port,
                    "grpc_port": grpc_port,
                }

    def _stop_proxies(self):
        import ray_tpu_torch

        # hold the reconcile lock so an in-flight pass can't register a
        # fresh proxy after we clear the fleet
        with self._proxy_reconcile_lock:
            with self._lock:
                entries = list(self._proxies.values())
                self._proxies.clear()
                self._proxy_cfg = None
            for e in entries:
                try:
                    ray_tpu_torch.kill(e["handle"])
                except Exception:
                    pass
