"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

A package of its own beside ``ray_tpu``: it imports torch and numpy, never
JAX and never ``ray_tpu``. Each Pallas TPU kernel on a ported path becomes a
hand-written sm_90a kernel under ``ops/csrc/``, built by nvcc at first
launch. Entry points run on the CUDA card and raise when there is none,
unless the caller passes ``device="cpu"``.

Core API parity with the reference (ray: python/ray/__init__.py): tasks,
actors, objects, placement groups — the runtime is the port's own copy of
``ray_tpu``'s (GCS, raylet, workers, object plane), with its own session
root (/dev/shm/ray_tpu_torch), state dir (~/.ray_tpu_torch) and env prefix
(RAY_TPU_TORCH_), so the two runtimes never see each other. Nodes advertise
CUDA cards as the "GPU" resource. Importing the package imports no torch:
the control-plane processes boot without it.
"""

from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.serialization import TaskError
from ray_tpu_torch._private.worker import (
    ActorDiedError,
    GetTimeoutError,
    TaskCancelledError,
    WorkerDiedError,
)
from ray_tpu_torch.api import (
    ActorClass,
    ActorHandle,
    RayContext,
    RemoteFunction,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.runtime_context import get_runtime_context


def timeline(filename=None, limit=None):
    """Chrome-trace dump of cluster task events + tracing spans (ray
    parity: ray.timeline, _private/state.py:416 chrome_tracing_dump).
    ``limit`` caps the raw events fetched from the GCS."""
    from ray_tpu_torch.util.state import timeline as _timeline

    return _timeline(filename, limit=limit)


__version__ = "0.1.0"


def __getattr__(name):
    # Lazy subpackage access (ray parity: ray.serve / ray.util / ... are
    # importable attributes) without paying their import cost up front.
    # Only the subpackages the port has; others join as they are ported.
    if name in ("serve", "util", "dag", "train", "air", "parallel", "tune",
                "data", "rllib"):
        import importlib

        mod = importlib.import_module(f"ray_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")

__all__ = [
    "ActorClass",
    "ActorDiedError",
    "WorkerDiedError",
    "ActorHandle",
    "GetTimeoutError",
    "ObjectRef",
    "RayContext",
    "RemoteFunction",
    "TaskCancelledError",
    "TaskError",
    "available_resources",
    "cancel",
    "cluster_resources",
    "nodes",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "put",
    "remote",
    "shutdown",
    "wait",
]
