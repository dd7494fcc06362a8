"""Backend plugin interface + the Torch backend.

ray parity: python/ray/train/backend.py:41,53 (Backend/BackendConfig) and the
framework config (torch/config.py:29 TorchConfig + :69
_setup_torch_process_group). TorchConfig is the port's flagship backend (the
role the reference's JaxConfig plays on a TPU): every worker gang forms one
``torch.distributed`` process group — NCCL when the workers lease a GPU,
gloo otherwise — which DDP, FSDP2 and the "nccl" collective backend ride.
TensorflowConfig (tensorflow/config.py) only wires TF_CONFIG on each worker.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group, backend_config):
        pass

    def on_training_start(self, worker_group, backend_config):
        pass

    def on_shutdown(self, worker_group, backend_config):
        pass


# ---------------------------------------------------------------------------
# Torch backend (the GPU path)
# ---------------------------------------------------------------------------


@dataclass
class TorchConfig(BackendConfig):
    """Per-worker torch.distributed setup.

    backend: "nccl" or "gloo"; None picks "nccl" when the workers lease a
    GPU and "gloo" otherwise. A worker asked for "nccl" with no CUDA
    device raises.

    overlap_grads arms ``session.GradSync`` overlap on every worker:
    gradient allreduces dispatch on a background thread so their chunked
    collective spans interleave with the step's compute phase spans.
    collective_quant ("int8") makes the train_dp group's SUM/MEAN
    allreduces ride the block-quantized wire format.

    ingraph_psum ("chunked" | "quantized") sets the IN-STEP gradient
    collective mode on every worker (the train_ingraph_psum flag):
    ``models.gpt2.build_train_step`` then reduces gradients with the
    explicit chunked/int8 twins from parallel/collectives.py, as a DDP
    communication hook, instead of DDP's own allreduce. "" keeps the
    default path.
    """

    backend: Optional[str] = None
    timeout_s: int = 1800
    env_vars: Dict[str, str] = field(default_factory=dict)
    overlap_grads: bool = False
    collective_quant: str = ""
    ingraph_psum: str = ""
    ingraph_psum_chunks: int = 4

    @property
    def backend_cls(self):
        return _TorchBackend


def _torch_worker_setup(master_addr: str, master_port: int, rank: int,
                        world_size: int, backend: str, timeout_s: int,
                        local_rank: int, env_vars: Dict[str, str]):
    """ray parity: train/torch/config.py:69 _setup_torch_process_group."""
    import datetime

    import torch
    import torch.distributed as dist

    for k, v in env_vars.items():
        os.environ[k] = str(v)
    if dist.is_initialized():
        return True
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchConfig(backend='nccl') on a worker with no CUDA device")
        torch.cuda.set_device(local_rank)
    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ["LOCAL_RANK"] = str(local_rank)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def _enable_overlap():
    from ray_tpu_torch.train import session

    session.set_overlap_grads(True)
    return True


def _set_ingraph_psum(mode: str, chunks: int):
    """Sticky process default: every build_train_step on this worker
    picks the mode up from the flag table (same posture as
    set_overlap_grads — per-run config, not per-call plumbing)."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    GLOBAL_CONFIG.update({"train_ingraph_psum": mode,
                          "train_ingraph_psum_chunks": int(chunks)})
    return True


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _TorchBackend(Backend):
    def on_start(self, worker_group, config: TorchConfig):
        import ray_tpu_torch

        n = worker_group.num_workers
        backend = config.backend or (
            "nccl" if worker_group.resources_per_worker.get("GPU", 0) > 0
            else "gloo")
        # a fresh store port per generation: a recovery re-placement never
        # meets the dead generation's rendezvous
        master_addr, master_port = "127.0.0.1", _free_port()
        refs = []
        for i, w in enumerate(worker_group.workers):
            refs.append(
                w.execute.remote(
                    _torch_worker_setup, master_addr, master_port, i, n,
                    backend, config.timeout_s, worker_group.local_ranks[i],
                    dict(config.env_vars),
                )
            )
        ray_tpu_torch.get(refs, timeout=300)
        if config.overlap_grads:
            ray_tpu_torch.get(
                [w.execute.remote(_enable_overlap) for w in worker_group.workers],
                timeout=300,
            )
        if config.ingraph_psum:
            ray_tpu_torch.get(
                [w.execute.remote(_set_ingraph_psum, config.ingraph_psum,
                                  config.ingraph_psum_chunks)
                 for w in worker_group.workers],
                timeout=300,
            )
        # Host-level collective group for out-of-step sync (weight
        # broadcast, metric reduction) — the Gloo-analog path.
        if n > 1:
            from ray_tpu_torch.util import collective as col

            # epoch = gang generation: a recovery re-placement must not
            # rendezvous against the dead generation's KV state
            col.create_collective_group(
                worker_group.workers, n, list(range(n)),
                backend="store", group_name="train_dp",
                epoch=getattr(worker_group, "generation", 0),
                quant=config.collective_quant,
            )

    def on_shutdown(self, worker_group, config):
        def _destroy():
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            return True

        try:
            worker_group.execute(_destroy)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# TensorFlow backend (TF_CONFIG — API parity for reference workloads)
# ---------------------------------------------------------------------------


def _get_host() -> str:
    return socket.gethostbyname(socket.gethostname())


@dataclass
class TensorflowConfig(BackendConfig):
    """ray parity: train/tensorflow/config.py — wires the TF_CONFIG env var
    (cluster spec + task index) on every worker so
    tf.distribute.MultiWorkerMirroredStrategy discovers the gang."""

    @property
    def backend_cls(self):
        return _TensorflowBackend


def _tf_grab_port() -> str:
    return f"{_get_host()}:{_free_port()}"


def _tf_worker_setup(tf_config: Dict):
    import json

    os.environ["TF_CONFIG"] = json.dumps(tf_config)
    return True


class _TensorflowBackend(Backend):
    def on_start(self, worker_group, config: TensorflowConfig):
        import ray_tpu_torch

        # one fan-out round trip, not N serialized ones
        addrs = ray_tpu_torch.get(
            [w.execute.remote(_tf_grab_port) for w in worker_group.workers],
            timeout=300,
        )
        refs = []
        for i, w in enumerate(worker_group.workers):
            refs.append(w.execute.remote(_tf_worker_setup, {
                "cluster": {"worker": addrs},
                "task": {"type": "worker", "index": i},
            }))
        ray_tpu_torch.get(refs, timeout=300)

    def on_shutdown(self, worker_group, config):
        def _clear():
            os.environ.pop("TF_CONFIG", None)
            return True

        try:
            worker_group.execute(_clear)
        except Exception:
            pass
