"""serve.run / serve.start / serve.shutdown / serve.status / handles.

Reference parity: ray python/ray/serve/api.py — the driver-side entry
points that talk to the ServeController actor.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.serve._common import (
    DEFAULT_APP_NAME,
    SERVE_CONTROLLER_NAME,
    SERVE_NAMESPACE,
)
from ray_tpu_torch.serve.deployment import Application, BoundDeployment
from ray_tpu_torch.serve.handle import DeploymentHandle

logger = logging.getLogger(__name__)

_http_port: Optional[int] = None


def _get_or_create_controller():
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)
    except Exception:
        pass
    from ray_tpu_torch.serve.controller import ServeController

    ctrl_cls = ray_tpu_torch.remote(
        num_cpus=0, name=SERVE_CONTROLLER_NAME, max_concurrency=100,
        lifetime="detached", namespace=SERVE_NAMESPACE,
    )(ServeController)
    try:
        return ctrl_cls.remote()
    except Exception:
        # lost the race: another driver created it
        return ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)


def start(http_options: Optional[Dict[str, Any]] = None,
          grpc_options: Optional[Dict[str, Any]] = None, **_kw):
    """ray parity: serve.start — ensure controller + proxy fleet.

    ``grpc_options``: {"grpc_servicer_functions": [...]} — import paths
    (or callables) of protoc-generated ``add_XServicer_to_server``
    functions; the proxies register them so clients call typed stubs
    (ray parity: serve.config.gRPCOptions)."""
    import ray_tpu_torch

    global _http_port
    http_options = http_options or {}
    servicers = []
    for fn in (grpc_options or {}).get("grpc_servicer_functions", ()):
        if callable(fn):
            # cross the actor boundary as an import path: the proxy
            # re-imports the generated module in its own process
            fn = f"{fn.__module__}:{fn.__qualname__}"
        servicers.append(fn)
    controller = _get_or_create_controller()
    _http_port = ray_tpu_torch.get(
        controller.ensure_proxy.remote(
            http_options.get("host", "127.0.0.1"),
            http_options.get("port", 8000),
            servicers,
        ),
        timeout=90,
    )
    return controller


def run(target: Application, *, name: str = DEFAULT_APP_NAME,
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    """ray parity: serve.run — deploy an application, return the ingress
    deployment's handle."""
    import ray_tpu_torch

    if isinstance(target, BoundDeployment):
        target = Application(target)
    controller = start()
    nodes = target._collect()
    payload = []
    for node in nodes:
        # bound deployments in init args become handles at replica init
        def swap(v):
            if isinstance(v, Application):
                v = v.root
            if isinstance(v, BoundDeployment):
                return DeploymentHandle(v.deployment.name, name)
            return v

        args = tuple(swap(a) for a in node.init_args)
        kwargs = {k: swap(v) for k, v in node.init_kwargs.items()}
        payload.append({
            "config": node.deployment.config,
            "init": cloudpickle.dumps(
                (node.deployment.func_or_class, args, kwargs)
            ),
        })
    ray_tpu_torch.get(
        controller.deploy_app.remote(
            name, payload, target.root.deployment.name, route_prefix
        ),
        timeout=60,
    )
    ok = ray_tpu_torch.get(
        controller.wait_for_ready.remote(name, 120.0), timeout=150
    )
    if not ok:
        raise RuntimeError(f"serve app {name!r} failed to become ready")
    handle = DeploymentHandle(target.root.deployment.name, name)
    if blocking:  # pragma: no cover — interactive use
        import time

        while True:
            time.sleep(3600)
    return handle


def http_port() -> Optional[int]:
    """Port the HTTP proxy actually bound (may differ from the requested
    one if it was taken)."""
    return _http_port


def get_app_handle(name: str = DEFAULT_APP_NAME) -> DeploymentHandle:
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)
    status = ray_tpu_torch.get(controller.get_serve_status.remote(), timeout=30)
    if name not in status:
        raise ValueError(f"no serve app named {name!r}")
    return DeploymentHandle(status[name]["ingress"], name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = DEFAULT_APP_NAME
                          ) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def status() -> Dict[str, Any]:
    import ray_tpu_torch

    try:
        controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)
    except Exception:
        return {}
    return ray_tpu_torch.get(controller.get_serve_status.remote(), timeout=30)


def delete(name: str, _blocking: bool = True):
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)
    ray_tpu_torch.get(controller.delete_app.remote(name), timeout=60)


def shutdown():
    import ray_tpu_torch

    global _http_port
    try:
        controller = ray_tpu_torch.get_actor(SERVE_CONTROLLER_NAME,
                             namespace=SERVE_NAMESPACE)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
    except Exception:
        pass
    # Belt and braces: if controller.shutdown timed out before its
    # _stop_proxies ran, killing the controller would leak the fleet
    # (child actors are not reaped with their parent) — sweep the
    # per-node proxy names directly.
    try:
        for n in ray_tpu_torch.nodes():
            try:
                ray_tpu_torch.kill(
                    ray_tpu_torch.get_actor(f"SERVE_PROXY:{n['node_id'][:12]}",
                                      namespace=SERVE_NAMESPACE)
                )
            except Exception:
                pass
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    _http_port = None
