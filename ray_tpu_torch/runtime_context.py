"""Runtime context (ray parity: python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.worker import global_worker


class RuntimeContext:
    @property
    def node_id(self) -> str:
        global_worker.check_connected()
        return global_worker.core_worker.node_id

    def get_node_id(self) -> str:
        return self.node_id

    @property
    def job_id(self) -> bytes:
        global_worker.check_connected()
        return global_worker.core_worker.job_id

    def get_job_id(self) -> str:
        return self.job_id.hex()

    @property
    def namespace(self) -> str:
        global_worker.check_connected()
        return global_worker.core_worker.namespace

    def get_task_id(self) -> Optional[str]:
        cw = global_worker.core_worker
        ex = getattr(cw, "executor", None)
        if ex is not None and ex.current_task_id is not None:
            return ex.current_task_id.hex()
        return None

    def get_actor_id(self) -> Optional[str]:
        cw = global_worker.core_worker
        ex = getattr(cw, "executor", None)
        if ex is not None and ex.actor_spec is not None:
            return ex.actor_spec.actor_id.hex()
        return None

    def get_worker_id(self) -> str:
        global_worker.check_connected()
        return global_worker.core_worker.client_id

    def get_node_labels(self) -> dict:
        global_worker.check_connected()
        return dict(global_worker.core_worker.node_labels)

    def get_resources(self) -> dict:
        """Node-total resources of the current node."""
        global_worker.check_connected()
        return dict(global_worker.core_worker.node_resources)

    def get_gpu_ids(self) -> list:
        """Local GPU indices on this node (ray.get_gpu_ids, ray:
        python/ray/_private/worker.py:838). Like the reference's
        get_tpu_ids, every card of the node: workers are not narrowed to
        their lease's cards."""
        n = int(self.get_resources().get("GPU", 0))
        return list(range(n))


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
