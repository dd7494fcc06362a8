"""Deployment + Application objects and the @serve.deployment decorator.

Reference parity: ray python/ray/serve/deployment.py + api.py —
``@serve.deployment`` wraps a class/function; ``.bind(*args)`` builds an
application graph node (constructor args may include other bound nodes,
giving model composition: inner nodes become DeploymentHandles at
runtime); ``.options(...)`` re-parameterizes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.serve._common import DeploymentConfig


class Application:
    """A bound deployment graph rooted at the ingress node."""

    def __init__(self, root: "BoundDeployment"):
        self.root = root

    def _collect(self) -> List["BoundDeployment"]:
        seen: Dict[str, BoundDeployment] = {}

        def walk(node: BoundDeployment):
            if node.deployment.name in seen:
                return
            seen[node.deployment.name] = node
            for a in list(node.init_args) + list(node.init_kwargs.values()):
                if isinstance(a, Application):
                    walk(a.root)
                elif isinstance(a, BoundDeployment):
                    walk(a)

        walk(self.root)
        return list(seen.values())


class BoundDeployment:
    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Union[Callable, type],
                 config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.config = config

    @property
    def name(self) -> str:
        return self.config.name

    def options(self, **kwargs) -> "Deployment":
        import dataclasses

        cfg_fields = {
            k: v for k, v in kwargs.items()
            if k in DeploymentConfig.__dataclass_fields__
        }
        if "name" in kwargs:
            cfg_fields["name"] = kwargs["name"]
        cfg = dataclasses.replace(self.config, **cfg_fields)
        return Deployment(self.func_or_class, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(BoundDeployment(self, args, kwargs))

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "deployments are not directly callable; use .bind() + serve.run"
        )


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Union[int, str, None] = None,
               max_ongoing_requests: int = 100,
               max_concurrent_queries: Optional[int] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               user_config: Optional[Any] = None,
               health_check_period_s: float = 10.0,
               graceful_shutdown_timeout_s: Optional[float] = None,
               prefix_affinity: Optional[bool] = None,
               **_ignored):
    """ray parity: @serve.deployment (serve/api.py:414)."""

    def build(fc):
        n = num_replicas
        auto = autoscaling_config
        if n == "auto":
            n = None
            auto = auto or {"min_replicas": 1, "max_replicas": 4}
        cfg = DeploymentConfig(
            name=name or getattr(fc, "__name__", "deployment"),
            num_replicas=n or 1,
            max_ongoing_requests=max_concurrent_queries
            or max_ongoing_requests,
            ray_actor_options=ray_actor_options,
            autoscaling_config=auto,
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            prefix_affinity=prefix_affinity,
            **({"graceful_shutdown_timeout_s": graceful_shutdown_timeout_s}
               if graceful_shutdown_timeout_s is not None else {}),
        )
        return Deployment(fc, cfg)

    if _func_or_class is not None:
        return build(_func_or_class)
    return build


def ingress(app):
    """Mount an ASGI app (FastAPI, Starlette, or any ASGI callable) as the
    deployment's HTTP handler (ray parity: serve.api.ingress +
    _private/http_proxy.py:395 ASGI plumbing). The decorated class keeps
    its own state/methods; HTTP requests route through the app — path
    params, routers, middleware and lifespan startup hooks all work, so an
    existing FastAPI application drops in unchanged:

        app = FastAPI()

        @serve.deployment
        @serve.ingress(app)
        class Api:
            ...

    Passing no app (``@serve.ingress`` is not supported — the reference
    requires the app argument too)."""

    def wrap(cls):
        from ray_tpu_torch.serve.asgi import ASGIAppRunner

        class _ASGIIngress(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self._serve_asgi_runner = ASGIAppRunner(app)

            async def __call__(self, request):
                return await self._serve_asgi_runner(request)

        _ASGIIngress.__name__ = cls.__name__
        _ASGIIngress.__qualname__ = cls.__qualname__
        _ASGIIngress.__module__ = cls.__module__
        return _ASGIIngress

    return wrap
