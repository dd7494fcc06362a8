"""Shared Serve types.

Reference parity: ray python/ray/serve/_private/common.py — deployment
config records plus the request envelope the proxy hands to ingress
replicas (the reference passes a Starlette Request; this runtime has no
ASGI dependency on the replica side, so requests travel as a small
picklable object)."""

from __future__ import annotations

import json as _json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

SERVE_CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"
DEFAULT_APP_NAME = "default"

# GCS-pubsub channels the controller pushes config changes on (long-poll
# analog, ray parity: serve/_private/long_poll.py:186): handles subscribe
# to replica-set changes, proxies to route-table changes. Consumers keep a
# slow poll as the safety net; the push makes updates near-instant.
REPLICA_PUSH_CHANNEL = "serve:replicas"
ROUTES_PUSH_CHANNEL = "serve:routes"


def _default_graceful_shutdown_s() -> float:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return GLOBAL_CONFIG.serve_default_graceful_shutdown_timeout_s


class OverloadedError(Exception):
    """Typed load-shed: admission control rejected the request before it
    could wedge a replica (bounded queue / KV budget exhausted). The
    HTTP proxy maps this to 503 + Retry-After instead of the generic
    500; the marker token survives cross-process exception stringifying
    so the proxy can classify a re-raised copy too."""

    MARKER = "SERVE_OVERLOADED"

    def __init__(self, detail: str = ""):
        super().__init__(f"{self.MARKER}: {detail}" if detail
                         else self.MARKER)


def is_overloaded_error(exc: BaseException) -> bool:
    return isinstance(exc, OverloadedError) \
        or OverloadedError.MARKER in f"{type(exc).__name__}{exc}"


# Set by the replica wrapper in its own process just before it constructs
# the user callable, so user code (e.g. the LLM engine tagging its
# metrics per deployment) can learn its identity (ray parity:
# serve.get_replica_context). None outside a replica.
CURRENT_REPLICA_CONTEXT: Optional[Dict[str, str]] = None


def get_replica_context() -> Optional[Dict[str, str]]:
    """{"app", "deployment", "replica"} inside a serve replica, else
    None."""
    return CURRENT_REPLICA_CONTEXT


@dataclass
class Request:
    """HTTP request envelope delivered to ingress deployments."""

    method: str = "GET"
    path: str = "/"
    query: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # route prefix the proxy matched (informs ASGI root_path so a mounted
    # FastAPI app's routes resolve relative to its deployment route)
    route_prefix: str = ""
    # the query string as received on the wire: duplicate parameters
    # (?tag=a&tag=b) and percent-encoding survive only here — the parsed
    # ``query`` dict collapses duplicates. ASGI ingress forwards this
    # verbatim; None means "built by hand", re-encode from ``query``.
    raw_query_string: Optional[str] = None

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


@dataclass
class Response:
    """Full HTTP response an ingress handler may return when it needs
    control over status/headers (ASGI ingress returns these; plain
    handlers may keep returning bytes/str/JSON-ables). ``headers`` may be
    a dict or a list of (name, value) pairs — pairs preserve duplicates
    (multiple Set-Cookie)."""

    status: int = 200
    headers: Any = field(default_factory=dict)
    body: bytes = b""

    def header_items(self):
        return (self.headers.items() if isinstance(self.headers, dict)
                else list(self.headers or ()))


@dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    user_config: Optional[Any] = None
    health_check_period_s: float = 10.0
    graceful_shutdown_timeout_s: float = field(
        default_factory=_default_graceful_shutdown_s
    )
    # Prefix-affinity routing (LLM deployments): None = auto — handles
    # bias p2c toward the replica holding the longest shared prefix
    # whenever replicas report a prefix digest; False disables even
    # then; True keeps the bias armed while digests are still empty.
    prefix_affinity: Optional[bool] = None

    def replica_actor_options(self) -> Dict[str, Any]:
        opts = dict(self.ray_actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        return opts


@dataclass
class ReplicaInfo:
    replica_id: str
    actor_name: str
    deployment: str
    app: str


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0

    @classmethod
    def from_dict(cls, d: Optional[Dict]) -> Optional["AutoscalingConfig"]:
        if d is None:
            return None
        known = {k: v for k, v in d.items()
                 if k in cls.__dataclass_fields__}
        # accept the reference's names
        if "target_num_ongoing_requests_per_replica" in d:
            known["target_ongoing_requests"] = d[
                "target_num_ongoing_requests_per_replica"
            ]
        return cls(**known)
