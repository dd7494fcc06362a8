"""ray_tpu_torch.serve — model serving (ray parity: python/ray/serve)."""

from ray_tpu_torch.serve._common import Request, Response
from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_port,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment, ingress
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.schema import (
    build,
    deploy_config,
    get_deployed_config,
    ServeApplicationSchema,
    ServeDeploySchema,
)

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "Request",
    "Response",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "http_port",
    "ingress",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "status",
]
