"""Autoscaler monitor process (ray parity:
autoscaler/_private/monitor.py — the process on the head node that runs
the StandardAutoscaler loop against the cluster's load metrics).

Launched by ``ray_tpu_torch up``; SIGTERM tears down every provider node this
monitor launched (the launcher's ``down`` depends on that), then exits.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

logger = logging.getLogger("ray_tpu_torch.autoscaler.monitor")


def _build_provider(cfg: dict, gcs_address: str, session_dir: str):
    from ray_tpu_torch.autoscaler.node_provider import (
        FakeGpuNodeProvider,
        MockProvider,
    )

    provider_cfg = cfg["provider"]
    kind = provider_cfg["type"]
    node_types = cfg.get("available_node_types") or {}
    host, port = gcs_address.rsplit(":", 1)
    if kind == "fake_gpu_node":
        return FakeGpuNodeProvider(host, int(port), session_dir, node_types)
    if kind == "mock":
        return MockProvider()
    if kind == "gpu_group":
        from ray_tpu_torch.autoscaler.node_provider import (
            GkeQueuedResourceAPI,
            GpuGroupProvider,
        )

        api = GkeQueuedResourceAPI(
            project=provider_cfg["project"],
            zone=provider_cfg["zone"],
            runtime_version=provider_cfg.get(
                "runtime_version", "tpu-ubuntu2204-base"
            ),
            token_provider=_adc_token_provider(),
        )
        return GpuGroupProvider(api, node_types)
    raise ValueError(f"unknown provider type {kind!r}")


def _adc_token_provider():
    """Application-default-credentials bearer tokens for the real GCP
    Queued-Resources API. Lazy: google-auth may be absent in offline
    images — the clear error then surfaces at the first API call (where
    GkeQueuedResourceAPI already raises with guidance), not at monitor
    boot."""
    try:
        import google.auth
        import google.auth.transport.requests
    except ImportError:
        return None

    creds, _project = google.auth.default(
        scopes=["https://www.googleapis.com/auth/cloud-platform"]
    )
    request = google.auth.transport.requests.Request()

    def token():
        if not creds.valid:
            creds.refresh(request)
        return creds.token

    return token


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--interval-s", type=float, default=5.0)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[monitor] %(levelname)s %(name)s: %(message)s",
    )

    from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
    from ray_tpu_torch.autoscaler.commands import load_config

    cfg = load_config(args.config)
    provider = _build_provider(cfg, args.gcs_address, args.session_dir)
    idle_s = float(cfg.get("idle_timeout_minutes", 1)) * 60.0
    autoscaler = StandardAutoscaler(
        provider,
        cfg.get("available_node_types") or {},
        gcs_address=args.gcs_address,
        idle_timeout_s=idle_s,
    )

    stop = threading.Event()

    def _terminate(_sig, _frm):
        logger.info("SIGTERM: terminating provider nodes")
        stop.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    logger.info("monitor up: cluster=%s provider=%s interval=%.1fs",
                cfg["cluster_name"], cfg["provider"]["type"],
                args.interval_s)
    try:
        autoscaler.run_loop(interval_s=args.interval_s, stop_event=stop)
    finally:
        # down-path contract: this monitor owns the worker nodes it
        # launched; take them with us so `down` leaves nothing behind
        shutdown = getattr(provider, "shutdown", None)
        if shutdown is not None:
            try:
                shutdown()
            except Exception:
                logger.exception("provider shutdown failed")
        logger.info("monitor exit")


if __name__ == "__main__":
    main()
