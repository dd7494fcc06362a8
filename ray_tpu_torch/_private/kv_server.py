"""Standalone KV metadata server — the Redis-analog behind remote GCS
persistence.

Reference parity: ray src/ray/gcs/store_client/redis_store_client.h —
the reference can point GCS table storage at an external Redis so losing
the head node's disk doesn't lose cluster metadata. This is the same
contract as a ~100-line rpcio service: per-cluster namespaced tables,
ordered pipelined puts, full-snapshot load on GCS (re)start. Run it
anywhere the head can reach::

    python -m ray_tpu_torch._private.kv_server --port 6479 [--path state.log]

and point the head at ``kv://host:6479`` (RAY_TPU_TORCH_GCS_STORAGE or the
gcs_persist config). ``--path`` makes the KV server itself durable via
the same append-log the local GCS store uses; without it, durability is
"survives head loss, not KV-server loss" — exactly Redis-without-AOF.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
from typing import Dict

logger = logging.getLogger("ray_tpu_torch.kv_server")


class KvService:
    """tables: cluster_id -> table -> key -> value (all values opaque)."""

    def __init__(self, persist_path: str = ""):
        self._clusters: Dict[str, Dict[str, dict]] = {}
        self._store = None
        if persist_path:
            from ray_tpu_torch._private.gcs_store import FileLogStore

            self._store = FileLogStore(persist_path)
            snapshot = self._store.load()
            # persisted layout: table name = "<cluster_id>\x1f<table>"
            for combined, table in snapshot.items():
                cid, _, tname = combined.partition("\x1f")
                self._clusters.setdefault(cid, {})[tname] = dict(table)

    def rpc_kv_put(self, conn, p):
        cid = p.get("cluster_id", "")
        tables = self._clusters.setdefault(cid, {})
        for table, key, value in p["entries"]:
            t = tables.setdefault(table, {})
            if value is None:
                t.pop(key, None)
            else:
                t[key] = value
            if self._store is not None:
                self._store.put(f"{cid}\x1f{table}", key, value)
        return {}

    def rpc_kv_load(self, conn, p):
        cid = p.get("cluster_id", "")
        return {"tables": self._clusters.get(cid, {})}

    def rpc_kv_ping(self, conn, p):
        return {"ok": True}


async def amain(args):
    from ray_tpu_torch._private.rpcio import RpcServer, enable_eager_tasks

    enable_eager_tasks(asyncio.get_running_loop())
    service = KvService(args.path)
    server = RpcServer(service, host=args.host, port=args.port)
    port = await server.start()
    # stdout protocol: the spawning parent reads this line for the port
    print(f"kv server listening on {args.host}:{port}", flush=True)  # lint: allow-print
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)
    await asyncio.Event().wait()  # serve forever


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--path", default="",
                        help="optional append-log for KV-server durability")
    parser.add_argument("--port-file", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"))
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
