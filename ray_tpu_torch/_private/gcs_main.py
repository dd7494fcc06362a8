"""GCS server process entrypoint (analog of ray: src/ray/gcs/gcs_server/
gcs_server_main.cc)."""

from __future__ import annotations

import argparse
import asyncio
import logging
import os


async def amain(args):
    from ray_tpu_torch._private.rpcio import enable_eager_tasks

    enable_eager_tasks(asyncio.get_running_loop())
    from ray_tpu_torch._private.gcs import GcsServer

    server = GcsServer(host=args.host, port=args.port,
                       persist_path=args.persist_path,
                       cluster_id=args.cluster_id)
    port = await server.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.rename(tmp, args.port_file)
    await asyncio.Event().wait()


def main():
    from ray_tpu_torch._private.profiling import maybe_profile

    maybe_profile("gcs")
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default=None)
    parser.add_argument("--cluster-id", default=None)
    parser.add_argument("--persist-path", default=None,
                        help="append-log file enabling GCS fault tolerance")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[gcs] %(levelname)s %(name)s: %(message)s",
    )
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
