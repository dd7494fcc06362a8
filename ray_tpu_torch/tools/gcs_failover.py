"""A GCS failover under a serving replica: the drive of ``chip_smoke.py``
phase 19 (b), shared with its CPU rehearsal in ``tests/test_torch_gcs_ft.py``
so that both run one and the same path.

``outage`` takes a cluster this process started (``ray_tpu_torch.init``)
with one ``serve.run`` deployment of one replica up, and then:

1. puts a KV key, takes the replica's actor handle and pid, and reads the
   replica's card memory (``memory_of``, where the caller gives one);
2. sends one HTTP request through the proxy, SIGKILLs the GCS
   (``global_worker.node.kill_gcs()``) and checks that its pid is gone;
3. during the outage, sends one more HTTP request and records its status
   and seconds, then streams ``prompt`` through the actor handle taken
   before the kill, on the calls the proxy makes (``stream_through_replica``);
4. restarts the GCS (``restart_gcs()``) and polls until it answers, until
   the state API lists the replica ALIVE, and until the KV key reads back;
5. reads the replica's pid and card memory again, the cluster's
   resources, and whether a second actor asking the one card stays
   pending for ``PENDING_S`` seconds (it is killed after).

It returns what it saw, with the seconds of each step; the caller holds it
to its checks. The proxy looks the replica up by name in the GCS on every
request (``serve/proxy.py``, ``_stream_response``), as the reference's does,
so the HTTP request during the outage gets no tokens: both proxies answer
it with status 500 at once when it reaches that lookup.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

KV_KEY = b"gcs-failover-key"
KV_VALUE = b"gcs-failover-value"
# the proxy's routing retries for 30 s (``serve/handle.py``) before it
# answers 500 where its handle cannot refresh; the request during the
# outage must be answered within that and a margin
HTTP_DEADLINE_S = 45.0
# how long a second actor asking the replica's card must stay pending
PENDING_S = 3.0


def http_request(port: int, tokens: List[int],
                 max_tokens: int) -> Dict[str, Any]:
    """POST one request to the proxy's ``/llm`` route: its status, streamed
    tokens (or body text) and seconds. A transport error raises."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm", method="POST",
        data=json.dumps({"tokens": tokens,
                         "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_DEADLINE_S) as r:
            toks = [json.loads(line)["token"] for line in r if line.strip()]
            return {"status": r.status, "tokens": toks,
                    "s": time.perf_counter() - t0}
    except urllib.error.HTTPError as e:
        return {"status": e.code, "text": e.read()[:200].decode(errors="replace"),
                "s": time.perf_counter() - t0}


def stream_through_replica(replica, tokens: List[int], max_tokens: int,
                           timeout: float = 60.0) -> Tuple[List[int], float]:
    """Stream one prompt from a replica's actor on the calls the proxy
    makes: ``handle_request`` with the request, then ``next_chunks`` until
    the stream is done. Actor calls go worker to worker, so this needs no
    GCS. Returns the tokens and the seconds to the first one."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._common import Request
    from ray_tpu_torch.serve.replica import STREAM_MARKER

    body = json.dumps({"tokens": tokens, "max_tokens": max_tokens}).encode()
    t0 = time.perf_counter()
    out = ray_tpu_torch.get(replica.handle_request.remote(
        "__call__", (Request(method="POST", body=body),), {}, None),
        timeout=timeout)
    info = out[STREAM_MARKER]
    toks: List[int] = []
    first_s = None
    done = False
    while not done:
        items, done = ray_tpu_torch.get(
            replica.next_chunks.remote(info["stream_id"]), timeout=timeout)
        for item in items:
            toks.append(json.loads(item)["token"])
            if first_s is None:
                first_s = time.perf_counter() - t0
    return toks, first_s


def gcs_answers(host: str, port: int) -> bool:
    """One fresh connection to the GCS answers ``get_nodes``."""
    from ray_tpu_torch._private.rpcio import EventLoopThread, connect

    io = EventLoopThread("gcs-probe")
    try:
        conn = io.run(connect(host, port, retries=1))
        try:
            io.run(conn.request("get_nodes", {}, timeout=5))
        finally:
            io.run(conn.close())
        return True
    except Exception:
        return False
    finally:
        io.stop()


def _poll(fn, timeout_s: float, what: str, interval_s: float = 0.1):
    """``fn()`` until it returns a truthy value; its exceptions count as
    not yet (the driver reconnects to the restarted GCS on its own)."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
        except Exception as e:  # noqa: BLE001 — retried until the deadline
            last = e
        time.sleep(interval_s)
    raise AssertionError(f"{what} not within {timeout_s} s (last: {last!r})")


def replica_actor(app: str, deployment: str):
    """(name, actor) of the deployment's one replica, from its controller."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._common import (SERVE_CONTROLLER_NAME,
                                             SERVE_NAMESPACE)

    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                         namespace=SERVE_NAMESPACE)
    names = ray_tpu_torch.get(
        controller.get_replica_names.remote(app, deployment), timeout=60)
    if len(names) != 1:
        raise AssertionError(f"{len(names)} replicas of {deployment}")
    return names[0], ray_tpu_torch.get_actor(names[0],
                                             namespace=SERVE_NAMESPACE)


def outage(app: str, deployment: str, http_port: int, prompt: List[int],
           max_tokens: int, warm_prompt: List[int],
           memory_of: Optional[Callable[[int], Any]] = None
           ) -> Dict[str, Any]:
    """Kill the GCS under a serving replica and restart it (see the module
    docstring); returns what was seen."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve._common import (SERVE_CONTROLLER_NAME,
                                             SERVE_NAMESPACE)
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.collective import collective as col

    node = global_worker.node
    out: Dict[str, Any] = {}
    name, replica = replica_actor(app, deployment)
    out["replica"] = name
    col._kv_put(KV_KEY, KV_VALUE)
    out["pid_before"] = ray_tpu_torch.get(
        replica.handle_request.remote("debug_info", (), {}), timeout=60)["pid"]
    out["mib_before"] = memory_of(out["pid_before"]) if memory_of else None
    # traffic up to the kill: this request leaves the proxy's handle
    # freshly refreshed (it refreshes once a second), so the request during
    # the outage reaches the replica and meets the proxy's by-name lookup;
    # a stale handle would spend its 30 s routing budget first
    out["http_before"] = http_request(http_port, warm_prompt, 1)

    gcs_pid = node.gcs_proc.pid
    t_kill = time.perf_counter()
    node.kill_gcs()
    out["gcs_pid"] = gcs_pid
    out["gcs_pid_gone"] = node.gcs_proc.poll() is not None and \
        not os.path.exists(f"/proc/{gcs_pid}")
    out["http_during"] = http_request(http_port, warm_prompt, 1)
    t_stream = time.perf_counter()
    out["tokens_during"], first_s = stream_through_replica(
        replica, prompt, max_tokens)
    out["kill_to_first_token_s"] = t_stream - t_kill + first_s
    out["outage_s"] = time.perf_counter() - t_kill

    t_restart = time.perf_counter()
    node.restart_gcs()
    _poll(lambda: gcs_answers(node.gcs_host, node.gcs_port), 60,
          "the restarted GCS answering")
    out["restart_to_gcs_answering_s"] = time.perf_counter() - t_restart

    def listed_alive():
        rows = [r for r in state.list_actors() if r.get("name") == name]
        return rows and rows[0]["state"] == "ALIVE" and rows[0]
    row = _poll(listed_alive, 60, "the replica listed ALIVE")
    out["restart_to_replica_alive_s"] = time.perf_counter() - t_restart
    out["replica_row"] = {k: row.get(k) for k in ("state", "num_restarts",
                                                    "node_id")}
    out["kv_after"] = _poll(lambda: col._kv_get(KV_KEY), 30,
                            "the KV key read back")
    out["pid_after"] = ray_tpu_torch.get(
        replica.handle_request.remote("debug_info", (), {}), timeout=60)["pid"]
    out["mib_after"] = memory_of(out["pid_after"]) if memory_of else None
    out["cluster_resources"] = ray_tpu_torch.cluster_resources()
    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                                         namespace=SERVE_NAMESPACE)
    out["controller_replicas"] = ray_tpu_torch.get(
        controller.get_replica_names.remote(app, deployment), timeout=60)

    second = ray_tpu_torch.remote(num_gpus=1)(_Holder).remote()
    ready, _ = ray_tpu_torch.wait([second.ping.remote()], timeout=PENDING_S)
    out["second_placed"] = bool(ready)
    ray_tpu_torch.kill(second)
    return out


class _Holder:
    """An actor that asks for the card the replica holds."""

    def ping(self):
        return os.getpid()
