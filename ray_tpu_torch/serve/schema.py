"""Declarative Serve config schema + deploy/build/status.

ray parity: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema / DeploymentSchema consumed by `serve deploy` and
the REST API) and serve/_private/application_state.py (declarative app
lifecycle). Plain dataclasses instead of pydantic; configs round-trip
through dicts/JSON/YAML-ish structures:

    applications:
      - name: app1
        import_path: mymodule:app          # module:attr -> Application
        route_prefix: /app1
        deployments:
          - name: Model
            num_replicas: 2

``serve.build(app)`` emits this structure for a bound application;
``deploy_config`` applies one (importing each app and running it with
overrides); deployed configs persist in the GCS KV so `serve status` and
re-deploys work from any client.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Dict, List, Optional

_KV_NS = b"serve_config"


@dataclasses.dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    user_config: Optional[Any] = None
    # None = auto (router uses prefix-affinity when the replica reports an
    # LLM prefix digest), False = always plain p2c, True = force-enable
    prefix_affinity: Optional[bool] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentSchema":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown deployment config keys {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass
class ServeApplicationSchema:
    name: str
    import_path: str  # "module.submodule:attribute" -> Application
    route_prefix: str = "/"
    deployments: List[DeploymentSchema] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "import_path": self.import_path,
            "route_prefix": self.route_prefix,
            "deployments": [d.to_dict() for d in self.deployments],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServeApplicationSchema":
        if "name" not in d or "import_path" not in d:
            raise ValueError("application config needs 'name' and 'import_path'")
        return cls(
            name=d["name"],
            import_path=d["import_path"],
            route_prefix=d.get("route_prefix", "/"),
            deployments=[DeploymentSchema.from_dict(x)
                         for x in d.get("deployments", [])],
        )


@dataclasses.dataclass
class ServeDeploySchema:
    applications: List[ServeApplicationSchema]

    def to_dict(self) -> dict:
        return {"applications": [a.to_dict() for a in self.applications]}

    @classmethod
    def from_dict(cls, d: dict) -> "ServeDeploySchema":
        apps = d.get("applications")
        if not apps:
            raise ValueError("deploy config needs a non-empty 'applications'")
        names = [a.get("name") for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names in {names}")
        return cls(applications=[ServeApplicationSchema.from_dict(a)
                                 for a in apps])


def build(app, name: str = "default") -> dict:
    """Emit the declarative config for a bound Application (ray parity:
    serve.build). import_path is left for the caller to fill in — code
    location isn't recoverable from a live object."""
    from ray_tpu_torch.serve.deployment import Application

    assert isinstance(app, Application)
    deployments = []
    for node in app._collect():
        cfg = node.deployment.config
        deployments.append(DeploymentSchema(
            name=cfg.name,
            num_replicas=cfg.num_replicas,
            max_ongoing_requests=cfg.max_ongoing_requests,
            ray_actor_options=cfg.ray_actor_options,
            autoscaling_config=cfg.autoscaling_config,
            user_config=cfg.user_config,
            prefix_affinity=getattr(cfg, "prefix_affinity", None),
        ).to_dict())
    return {
        "name": name,
        "import_path": "<module>:<app>",
        "route_prefix": "/",
        "deployments": deployments,
    }


def _import_application(import_path: str):
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'"
        )
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    app = getattr(module, attr)
    from ray_tpu_torch.serve.deployment import Application

    if callable(app) and not isinstance(app, Application):
        app = app()  # app builder function
    if not isinstance(app, Application):
        raise TypeError(f"{import_path} is not a Serve Application")
    return app


def _apply_overrides(app, overrides: List[DeploymentSchema]):
    """Re-parameterize deployments by name on a COPY of the bound graph —
    the imported module's Application is a cached module-global that later
    deploys of the same import_path must see unmodified."""
    from ray_tpu_torch.serve.deployment import Application, BoundDeployment

    by_name = {o.name: o for o in overrides}
    copies: dict = {}

    def copy_node(node):
        if id(node) in copies:
            return copies[id(node)]
        def swap(v):
            if isinstance(v, Application):
                return Application(copy_node(v.root))
            if isinstance(v, BoundDeployment):
                return copy_node(v)
            return v

        args = tuple(swap(a) for a in node.init_args)
        kwargs = {k: swap(v) for k, v in node.init_kwargs.items()}
        dep = node.deployment
        o = by_name.get(dep.name)
        if o is not None:
            opts = {k: v for k, v in o.to_dict().items() if k != "name"}
            dep = dep.options(**opts)
        new = BoundDeployment(dep, args, kwargs)
        copies[id(node)] = new
        return new

    return Application(copy_node(app.root))


def deploy_config(config: Dict[str, Any]) -> List[str]:
    """Apply a declarative deploy config: import + run every application
    (ray parity: `serve deploy` REST handler). Returns deployed app names.
    The config persists in the GCS KV for status/re-deploy."""
    from ray_tpu_torch import serve

    schema = ServeDeploySchema.from_dict(config)
    deployed = []
    for app_schema in schema.applications:
        app = _import_application(app_schema.import_path)
        app = _apply_overrides(app, app_schema.deployments)
        serve.run(app, name=app_schema.name,
                  route_prefix=app_schema.route_prefix)
        deployed.append(app_schema.name)
    _persist_config(schema)
    return deployed


def _persist_config(schema: ServeDeploySchema):
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    if cw is None:
        return
    try:
        cw.io.run(cw.gcs.request("kv_put", {
            "ns": _KV_NS, "key": b"deploy_config",
            "value": json.dumps(schema.to_dict()).encode(),
        }))
    except Exception:
        pass


def get_deployed_config() -> Optional[dict]:
    from ray_tpu_torch._private.worker import global_worker

    cw = global_worker.core_worker
    if cw is None:
        return None
    blob = cw.io.run(cw.gcs.request(
        "kv_get", {"ns": _KV_NS, "key": b"deploy_config"}
    ))
    return json.loads(blob) if blob else None
