"""Explicit object push / broadcast.

ray parity: src/ray/object_manager/push_manager.h:30 (owner-initiated
pushes with per-peer in-flight budgets + dedup — internal in the
reference) and the release broadcast benchmark
(release/benchmarks/README.md:17-19, 1 GiB to N nodes). Here the plane is
also exposed: ``push_object`` ships a copy to chosen nodes ahead of
demand (prefetch task args, stage weights), ``broadcast_object`` fans a
copy to the whole cluster over a binary tree of raylets (log2 depth, each
link running the full chunk pipeline).
"""

from __future__ import annotations

from typing import List, Optional


def _cw():
    from ray_tpu_torch._private.worker import global_worker

    global_worker.check_connected()
    return global_worker.core_worker


def push_object(ref, node_ids: List[str]) -> int:
    """Push the object to the given nodes (flat fan-out from this node's
    raylet). Returns how many pushes landed. The local raylet pulls the
    object first if it doesn't hold a copy."""
    cw = _cw()
    reply = cw.io.run(cw.raylet.request(
        "push_object",
        {"object_id": ref.binary(), "node_ids": list(node_ids)},
    ))
    if not reply.get("ok") and reply.get("error"):
        raise RuntimeError(f"push_object failed: {reply['error']}")
    return int(reply.get("pushed", 0))


def broadcast_object(ref, node_ids: Optional[List[str]] = None,
                     timeout: float = 300.0) -> int:
    """Place a copy of the object on every given node (default: all alive
    nodes) via tree fan-out. Returns the number of target nodes."""
    import ray_tpu_torch

    cw = _cw()
    if node_ids is None:
        node_ids = [n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]]
    reply = cw.io.run(cw.raylet.request(
        "broadcast_object",
        {"object_id": ref.binary(), "node_ids": list(node_ids),
         "timeout": timeout * 0.95},  # tree hops inherit this budget
        timeout=timeout,
    ))
    if not reply.get("ok"):
        raise RuntimeError(
            f"broadcast failed: {reply.get('error', 'partial push failure')}"
        )
    return int(reply.get("nodes", 0))
