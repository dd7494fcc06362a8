"""DeploymentHandle: the client-side router to a deployment's replicas.

Reference parity: ray python/ray/serve/handle.py (DeploymentHandle /
DeploymentResponse / DeploymentResponseGenerator) + _private/router.py:262
(PowerOfTwoChoicesReplicaScheduler) — the handle picks the less loaded of
two random replicas, scoring each by local in-flight count PLUS the
replica-reported queue length (collected by the controller's control loop),
so many independent handles/proxies converge instead of each hot-spotting
on its own view. The replica set refreshes from the controller on an
interval, immediately on routing failures, and is invalidated by the
controller's pubsub push (ray parity: _private/long_poll.py:186).
"""

from __future__ import annotations

import random
import time
import weakref
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve._common import (
    REPLICA_PUSH_CHANNEL,
    SERVE_CONTROLLER_NAME,
    SERVE_NAMESPACE,
)

_REFRESH_PERIOD_S = 1.0


def _is_replica_death(exc: BaseException) -> bool:
    """Did this call fail because its replica actor died (rolling update,
    crash)? Those failures are retriable on ANOTHER replica — serve's
    contract is that redeploys don't drop requests (ray parity: the
    router's retry on RayActorError). Matched by TYPE only — the system
    death paths raise ActorDiedError / WorkerDiedError end-to-end — and
    only ONE cause-level deep, so an application error that merely EMBEDS
    an actor death from a downstream call is never retried: the replica
    itself is alive and re-executing its side-effecting handler would
    break at-most-once."""
    import ray_tpu_torch
    from ray_tpu_torch._private.serialization import TaskError

    death = (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerDiedError)
    if isinstance(exc, death):
        return True
    if isinstance(exc, TaskError) and isinstance(exc.cause, death):
        return True
    return False


class DeploymentResponse:
    """Future-like result of handle.remote() (ray parity:
    serve.handle.DeploymentResponse)."""

    def __init__(self, ref, on_settle=None, resubmit=None):
        self._ref = ref
        self._on_settle = on_settle
        self._resubmit = resubmit
        self._settled = False
        self._cached = None
        self._has_cached = False

    def _settle(self):
        if not self._settled:
            self._settled = True
            if self._on_settle:
                self._on_settle()

    def __del__(self):
        # fire-and-forget callers never resolve the response; releasing on
        # GC keeps the router's in-flight load scores honest
        try:
            self._settle()
        except Exception:
            pass

    def result(self, timeout_s: Optional[float] = None):
        import ray_tpu_torch

        if self._has_cached:
            # result() is idempotent: a successful retry must not re-get
            # the dead ref (which would resubmit the handler AGAIN)
            return self._cached
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        try:
            out = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            # success: drop the retry closure — it pins the request
            # payload (args/kwargs) for the response's lifetime otherwise
            self._resubmit = None
        except Exception as e:
            self._settle()
            # Replica died with this request in flight (rolling update):
            # re-route to a live replica instead of surfacing the death —
            # handler code is expected idempotent under serve's retry
            # contract, exactly as in the reference. The caller's timeout
            # budget is shared across retries, not restarted.
            if self._resubmit is not None and _is_replica_death(e):
                remaining = None if deadline is None else max(
                    0.0, deadline - time.monotonic()
                )
                retry = None
                if remaining is None or remaining > 0.0:
                    retry = self._resubmit(route_budget=remaining)
                if retry is not None:
                    # routing consumed part of the budget: recompute
                    remaining = None if deadline is None else max(
                        0.0, deadline - time.monotonic()
                    )
                    out = retry.result(remaining)
                    self._cached, self._has_cached = out, True
                    self._resubmit = None
                    return out
            raise
        finally:
            self._settle()
        from ray_tpu_torch.serve.replica import STREAM_MARKER

        if isinstance(out, dict) and STREAM_MARKER in out:
            # generator deployment called without stream=True: stop the
            # producer and tell the caller how to consume it — leaking the
            # marker would hand users an internal dict and park a stream
            # until the TTL reap
            info = out[STREAM_MARKER]
            try:
                ray_tpu_torch.get_actor(
                    info["replica"], namespace=SERVE_NAMESPACE
                ).cancel_stream.remote(
                    info["stream_id"]
                )
            except Exception:
                pass
            raise TypeError(
                "this deployment method is a generator; call it with "
                ".options(stream=True).remote(...) and iterate the result"
            )
        self._cached, self._has_cached = out, True
        return out

    @property
    def ref(self):
        self._settle()
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment call (ray parity:
    serve.handle.DeploymentResponseGenerator). Pulls chunk batches from the
    replica; iteration blocks on the first chunk of each batch."""

    def __init__(self, ref, on_settle=None, timeout_s: float = 60.0):
        self._ref = ref
        self._on_settle = on_settle
        self._timeout_s = timeout_s
        self._actor = None
        self._stream_id = None
        self._buffer: List[Any] = []
        self._done = False
        self._settled = False

    def _settle(self):
        if not self._settled:
            self._settled = True
            if self._on_settle:
                self._on_settle()

    def _ensure_started(self):
        if self._actor is not None or self._done:
            return
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import STREAM_MARKER

        first = ray_tpu_torch.get(self._ref, timeout=self._timeout_s)
        if not (isinstance(first, dict) and STREAM_MARKER in first):
            # non-generator target: degrade to a one-item stream
            self._buffer = [first]
            self._done = True
            self._settle()
            return
        info = first[STREAM_MARKER]
        self._stream_id = info["stream_id"]
        self._actor = ray_tpu_torch.get_actor(info["replica"],
                                        namespace=SERVE_NAMESPACE)

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch

        self._ensure_started()
        if self._buffer:
            return self._buffer.pop(0)
        if self._done:
            raise StopIteration
        try:
            items, done = ray_tpu_torch.get(
                self._actor.next_chunks.remote(self._stream_id),
                timeout=self._timeout_s,
            )
        except Exception:
            self._done = True
            self._settle()
            raise
        self._buffer.extend(items)
        if done:
            self._done = True
            self._settle()
        if self._buffer:
            return self._buffer.pop(0)
        if self._done:
            raise StopIteration
        return self.__next__()

    def cancel(self):
        """Abandon the stream; the replica stops the producer."""
        if self._actor is not None and not self._done:
            try:
                self._actor.cancel_stream.remote(self._stream_id)
            except Exception:
                pass
        self._done = True
        self._settle()

    def __del__(self):
        try:
            self.cancel()
        except Exception:
            pass


class _PushRegistry:
    """One process-wide pubsub subscription fanning replica-set pushes out
    to every live _RouterState (weakly referenced, so dead handles — e.g.
    repeatedly unpickled request arguments — do not pin states or grow the
    worker's callback list)."""

    def __init__(self):
        import weakref

        self._states: "weakref.WeakSet" = weakref.WeakSet()
        self._subscribed = False

    def register(self, state: "_RouterState") -> bool:
        self._states.add(state)
        if self._subscribed:
            return True
        try:
            from ray_tpu_torch._private.worker import global_worker

            def on_push(msg):
                key = (msg.get("app"), msg.get("deployment"))
                for st in list(self._states):
                    if (st.app_name, st.deployment_name) == key:
                        st.last_refresh = 0.0  # next routing refreshes

            global_worker.core_worker.subscribe(REPLICA_PUSH_CHANNEL, on_push)
            self._subscribed = True
        except Exception:
            return False  # not connected yet; polling still covers us
        return True


_push_registry = _PushRegistry()

# live router states per (app, deployment): the serve_handle_inflight
# gauge sums over ALL of a process's handles for the deployment (a
# driver can hold several), and weakrefs let discarded handles drop out
# instead of being pinned forever by the gauge closure
_router_states: Dict[tuple, weakref.WeakSet] = {}


class _RouterState:
    """Replica cache + load scores for one (app, deployment), shared by a
    handle and every derivative it creates via options()/__getattr__ — one
    subscription, one cache, consistent in-flight accounting."""

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.replicas: List[Any] = []
        self.inflight: Dict[str, int] = {}
        self.reported: Dict[str, float] = {}
        # staleness guard on the reported queue lengths: age the
        # controller stamped at reply time + when WE received them — a
        # snapshot older than serve_replica_report_max_age_s is ignored
        # by score() (stale lengths steer routing silently otherwise)
        self.reported_age0 = 0.0
        self.reported_at: Optional[float] = None
        self.report_max_age_s = 5.0
        self.last_refresh = 0.0
        self.push_subscribed = False
        # prefix-affinity state (LLM deployments): per-replica chain-
        # hash digests + the block size they were computed with, from
        # the controller's load report. Empty for plain deployments —
        # pick() degenerates to exactly the legacy p2c then.
        self.prefix_index: Dict[str, frozenset] = {}
        self.prefix_block_tokens = 0
        self._setup_metrics()

    def _setup_metrics(self):
        """Router-side inflight gauge (the instant local-view complement
        of the replica-reported queue length): summed across every
        process's router states by the cluster scrape. The set_fn closes
        over a shared WeakSet of this (app, deployment)'s live states —
        several handles sum instead of the last one winning, and a
        discarded handle drops out rather than being pinned forever."""
        try:
            from ray_tpu_torch._private import metrics_core as mc

            states = _router_states.setdefault(
                (self.app_name, self.deployment_name), weakref.WeakSet())
            states.add(self)
            mc.registry().gauge(
                "serve_handle_inflight",
                "requests this process's router has in flight, by "
                "deployment",
            ).labels(app=self.app_name, deployment=self.deployment_name
                     ).set_fn(lambda: sum(
                         sum(s.inflight.values()) for s in states))
        except Exception:
            pass

    def _subscribe_push(self):
        """Invalidate the replica cache the moment the controller pushes a
        replica-set change for this deployment (long-poll analog)."""
        if self.push_subscribed:
            return
        self.push_subscribed = _push_registry.register(self)

    def refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and self.replicas and (
            now - self.last_refresh < _REFRESH_PERIOD_S
        ):
            return
        import ray_tpu_torch

        self._subscribe_push()
        controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                       namespace=SERVE_NAMESPACE)
        state = ray_tpu_torch.get(
            controller.get_replica_state.remote(
                self.app_name, self.deployment_name
            ),
            timeout=30,
        )
        names, loads = state["names"], state.get("loads", {})
        replicas = []
        for n in names:
            try:
                replicas.append((n, ray_tpu_torch.get_actor(
                    n, namespace=SERVE_NAMESPACE)))
            except Exception:
                pass
        self.replicas = replicas
        self.inflight = {n: self.inflight.get(n, 0) for n, _ in replicas}
        self.reported = {n: float(loads.get(n, 0.0)) for n, _ in replicas}
        # the controller stamps how old its load snapshot already was at
        # reply time; we add our own receive timestamp so score() can age
        # it continuously
        age0 = state.get("loads_age_s")
        self.reported_age0 = float(age0) if age0 is not None else 0.0
        self.reported_at = now if age0 is not None else None
        llm = state.get("llm") or {}
        self.prefix_index = {
            n: frozenset(r.get("prefix_digest") or ())
            for n, r in llm.items() if n in dict(replicas)
        }
        self.prefix_block_tokens = max(
            [int(r.get("block_tokens") or 0) for r in llm.values()],
            default=0)
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            self.report_max_age_s = float(
                GLOBAL_CONFIG.serve_replica_report_max_age_s)
        except Exception:
            pass
        self.last_refresh = now

    def reported_stale(self) -> bool:
        """Are the replica-reported queue lengths too old to trust? A
        controller that stopped collecting (wedged loop, partition)
        keeps answering get_replica_state with its LAST snapshot — aging
        it here is what stops stale lengths steering routing silently."""
        if self.reported_at is None:
            return True  # controller never reported an age: local only
        age = self.reported_age0 + (time.monotonic() - self.reported_at)
        return age > self.report_max_age_s

    def score(self, name: str) -> float:
        # reported queue length (global view, ~1 control-loop period
        # stale; DROPPED entirely beyond the staleness threshold) +
        # local in-flight (instant view of our own traffic)
        reported = 0.0 if self.reported_stale() \
            else self.reported.get(name, 0.0)
        return reported + self.inflight.get(name, 0)

    def request_chains(self, args, kwargs) -> list:
        """Prefix chain hashes for a request, when this deployment is
        prefix-affine (replicas reported digests) and the LLM path is
        enabled. [] means: route plain p2c."""
        if not self.prefix_index or self.prefix_block_tokens <= 0:
            return []
        try:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            if not GLOBAL_CONFIG.serve_llm_enabled:
                return []
            from ray_tpu_torch.serve.llm import prefix as prefix_mod

            tokens = prefix_mod.extract_tokens(args, kwargs)
            if not tokens:
                return []
            return prefix_mod.chain_hashes(tokens,
                                           self.prefix_block_tokens)
        except Exception:
            return []

    def affinity_pick(self, chains) -> Optional[tuple]:
        """The replica already holding the LONGEST shared prefix —
        skipped (None) when nothing matches, when the load report is too
        stale to trust (the digests rode the same report the staleness
        guard ages), or when the winner is drowning (score beyond every
        other replica's by more than a batch: affinity must not defeat
        load balancing)."""
        if not chains or self.reported_stale():
            return None
        from ray_tpu_torch.serve.llm import prefix as prefix_mod

        best, best_depth = None, 0
        for rep in self.replicas:
            held = self.prefix_index.get(rep[0])
            if not held:
                continue
            depth = prefix_mod.longest_match_depth(chains, held)
            if depth > best_depth or (
                depth == best_depth and depth > 0
                and best is not None
                and self.score(rep[0]) < self.score(best[0])
            ):
                best, best_depth = rep, depth
        if best is None:
            return None
        others = [self.score(n) for n, _ in self.replicas
                  if n != best[0]]
        if others and self.score(best[0]) > min(others) + best_depth + 1:
            return None  # cache warmth doesn't pay for that much queue
        return best

    def pick(self, chains=None):
        """Power-of-two-choices on reported + local load, with an
        optional prefix-affinity bias (LLM deployments)."""
        if not self.replicas:
            raise RuntimeError(
                f"no replicas for {self.app_name}/{self.deployment_name}"
            )
        if chains:
            best = self.affinity_pick(chains)
            if best is not None:
                return best
        if len(self.replicas) == 1:
            return self.replicas[0]
        a, b = random.sample(self.replicas, 2)
        return a if self.score(a[0]) <= self.score(b[0]) else b


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str,
                 method_name: str = "__call__", stream: bool = False,
                 _state: Optional[_RouterState] = None,
                 _request_id: Optional[str] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method = method_name
        self._stream = stream
        self._rid = _request_id
        self._state = _state or _RouterState(app_name, deployment_name)

    # handles are pickled into other replicas; drop live actor handles
    def __getstate__(self):
        d = dict(self.__dict__)
        d["_state"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._state = _RouterState(self.app_name, self.deployment_name)

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                _request_id: Optional[str] = None,
                **_ignored) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self._method,
            stream=self._stream if stream is None else stream,
            _state=self._state,
            _request_id=_request_id or self._rid,
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    # ------------------------------------------------------------------
    def _refresh(self, force: bool = False):
        self._state.refresh(force=force)

    def remote(self, *args, **kwargs):
        return self._remote_attempt(args, kwargs, retries_left=3)

    def _remote_attempt(self, args, kwargs, retries_left: int,
                        route_budget: Optional[float] = None):
        from ray_tpu_torch._private import reqtrace

        st = self._state
        deadline = time.monotonic() + (
            30.0 if route_budget is None else min(30.0, route_budget)
        )
        # the proxy threads its minted id in via options(_request_id=);
        # a handle called directly mints its own so replica-side spans
        # still join into one request row
        traced = reqtrace.is_enabled()
        rid = (self._rid or reqtrace.new_request_id()) if traced else ""
        last_err = None
        chains = None  # prefix identity: computed once, after the first
        # refresh has told us whether this deployment is prefix-affine
        while time.monotonic() < deadline:
            t_route = time.time()
            try:
                st.refresh()
                if chains is None:
                    chains = st.request_chains(args, kwargs)
                name, actor = st.pick(chains)
            except Exception as e:  # controller not up yet / no replicas
                last_err = e
                time.sleep(0.1)
                continue
            try:
                meta = None
                if traced:
                    now = time.time()
                    reqtrace.record_span(
                        rid, "route", t_route, now,
                        app=self.app_name, deployment=self.deployment_name,
                        replica=name,
                        detail={"replica": name,
                                # chosen replica's count + total: O(1)
                                # per record vs O(replicas) for the full
                                # dict, which bloats every ring slot,
                                # scrape, and dashboard poll at scale
                                "inflight": st.inflight.get(name, 0),
                                "inflight_total": sum(
                                    st.inflight.values()),
                                "reported_stale": st.reported_stale()})
                    # the envelope's send timestamp is where the replica's
                    # queue-wait span starts (caller clock, same epoch
                    # tradeoff as steptrace)
                    meta = {"rid": rid, "ts": now}
                ref = actor.handle_request.remote(
                    self._method, args, kwargs, meta)
                st.inflight[name] = st.inflight.get(name, 0) + 1

                def settle(n=name):
                    st.inflight[n] = max(0, st.inflight.get(n, 1) - 1)

                if self._stream:
                    return DeploymentResponseGenerator(ref, on_settle=settle)

                def resubmit(route_budget=None, remaining=retries_left):
                    # replica died mid-request: route again on a fresh
                    # replica table (bounded — not every death is a
                    # rolling update; routing shares the caller's budget)
                    if remaining <= 0:
                        return None
                    st.refresh(force=True)
                    return self._remote_attempt(
                        args, kwargs, retries_left=remaining - 1,
                        route_budget=route_budget,
                    )

                return DeploymentResponse(
                    ref, on_settle=settle, resubmit=resubmit
                )
            except Exception as e:
                last_err = e
                st.refresh(force=True)
        raise RuntimeError(
            f"could not route request to {self.deployment_name}: {last_err}"
        )
