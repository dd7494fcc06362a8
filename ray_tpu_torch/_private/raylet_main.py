"""Raylet process entrypoint (analog of ray: src/ray/raylet/main.cc:109)."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os


async def amain(args):
    from ray_tpu_torch._private.rpcio import enable_eager_tasks

    enable_eager_tasks(asyncio.get_running_loop())
    from ray_tpu_torch._private.raylet import Raylet
    from ray_tpu_torch._private.resource_spec import detect_resources

    resources, labels = detect_resources()
    if args.resources:
        resources.update(json.loads(args.resources))
    if args.labels:
        labels.update(json.loads(args.labels))
    raylet = Raylet(
        gcs_host=args.gcs_host,
        gcs_port=args.gcs_port,
        session_dir=args.session_dir,
        resources=resources,
        labels=labels,
        port=args.port,
    )
    port = await raylet.start()

    import signal

    async def _shutdown():
        try:
            await raylet.stop()
        finally:
            os._exit(0)

    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, lambda: asyncio.ensure_future(_shutdown()))
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{port}\n{raylet.node_id}")
        os.rename(tmp, args.port_file)
    await asyncio.Event().wait()


def main():
    from ray_tpu_torch._private.profiling import maybe_profile

    maybe_profile("raylet")
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-host", default="127.0.0.1")
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default=None)
    parser.add_argument("--resources", default=None, help="JSON resource overrides")
    parser.add_argument("--labels", default=None, help="JSON label overrides")
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[raylet] %(levelname)s %(name)s: %(message)s",
    )
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
