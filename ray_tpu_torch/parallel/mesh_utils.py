"""Device-mesh construction and sharding helpers — the GPU device plane.

The reference lays a ``jax.sharding.Mesh`` over a pod's chips and lets the
XLA partitioner insert collectives. The port lays a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes, in the
same order, over the ranks of the gang's process group (one rank per CUDA
card, or per CPU process under gloo): each axis is a process group, data
parallelism is DDP over the data axes' group, and parameter sharding is FSDP2
(``fully_shard``) over the ``fsdp`` axis, HSDP when a ``data`` axis is there
too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# Canonical axis order: data-like axes outermost (ride the slower links),
# model-like innermost (ride NVLink between neighbours).
AXIS_ORDER = ("data", "fsdp", "pipeline", "seq", "expert", "model")
# axes a batch's leading dim is split over (the reference's data_sharding)
DATA_AXES = ("data", "fsdp")


def _ordered_axis_names(axes: Dict[str, int]) -> List[str]:
    """Canonical axis order (AXIS_ORDER first, unknown axes after) — the
    single source of truth of mesh construction."""
    names = [a for a in AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in names]
    return names


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(axes: Dict[str, int], device_type: Optional[str] = None):
    """A DeviceMesh with named axes from ``axes`` (e.g. {"data": 2,
    "fsdp": 2}) over every rank of the initialised process group, axes in
    ``AXIS_ORDER``; rank r sits at row-major position r. ``device_type``
    defaults to "cuda" under NCCL and "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(TorchTrainer's TorchConfig forms one)")
    names = _ordered_axis_names(axes)
    sizes = [axes[a] for a in names]
    total, world = math.prod(sizes), dist.get_world_size()
    if total != world:
        raise ValueError(f"mesh {axes} needs {total} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(device_type or _device_type(), tuple(sizes),
                            mesh_dim_names=tuple(names))


def auto_mesh(
    n_devices: Optional[int] = None,
    data: int = -1,
    model: int = 1,
    fsdp: int = 1,
    pipeline: int = 1,
    seq: int = 1,
    expert: int = 1,
):
    """Mesh with one wildcard axis (-1) absorbing the remaining ranks."""
    import torch.distributed as dist

    n = n_devices if n_devices is not None else dist.get_world_size()
    axes = {"data": data, "fsdp": fsdp, "pipeline": pipeline, "seq": seq,
            "expert": expert, "model": model}
    fixed = math.prod(v for v in axes.values() if v > 0)
    wild = [k for k, v in axes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("only one axis may be -1")
    if wild:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        axes[wild[0]] = n // fixed
    axes = {k: v for k, v in axes.items() if v > 1 or k == "data"}
    return create_mesh(axes)


def data_sharding(mesh, *data_axes: str) -> Tuple[str, ...]:
    """The axes a batch's leading dim is split over: ``data_axes``, else
    the data-like axes of the mesh; () means replicated."""
    return data_axes or tuple(a for a in DATA_AXES
                              if a in mesh.mesh_dim_names)


def shard_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, number of shards) over ``axes``, row-major in
    the mesh's axis order: the block of a tensor split over them that
    this rank holds."""
    index, count = 0, 1
    for name in mesh.mesh_dim_names:
        if name in axes:
            size = mesh.size(mesh.mesh_dim_names.index(name))
            index = index * size + mesh.get_local_rank(name)
            count *= size
    return index, count


def axis_groups(mesh, axes: Sequence[str]) -> list:
    """The process groups of ``axes`` (one per axis, in mesh order)."""
    return [mesh.get_group(a) for a in mesh.mesh_dim_names if a in axes]


def shard_params_fsdp(module, mesh, min_size: int = 2**16,
                      leave_to_root: Sequence = ()):
    """ZeRO-3-style parameter sharding with FSDP2 (``fully_shard``) over
    the ``fsdp`` axis; with a ``data`` axis too, HSDP on the 2-D (data,
    fsdp) mesh: replicated over data, sharded over fsdp, gradients
    reduce-scattered over fsdp and all-reduced over data. The reference
    shards each array of ``min_size`` elements or more on its largest
    divisible dim and replicates the rest; FSDP2 shards whole modules on
    dim 0, so each submodule whose largest own parameter reaches
    ``min_size`` gets its own FSDP unit and everything else (small
    modules, and the modules in ``leave_to_root``) is sharded by the
    root's unit. The math is the reference's; the byte layout is not.
    Without an ``fsdp`` axis the module is returned as it is (the
    reference replicates every parameter then). Returns ``module``.
    """
    from torch.distributed.fsdp import fully_shard

    names = mesh.mesh_dim_names
    if "fsdp" not in names:
        return module
    shard_mesh = mesh["data", "fsdp"] if "data" in names else mesh["fsdp"]
    keep = {id(m) for m in leave_to_root}
    # FSDP2 units go on bottom-up, the root last
    for sub in reversed(list(module.modules())):
        if sub is module or id(sub) in keep:
            continue
        own = list(sub.parameters(recurse=False))
        if own and max(p.numel() for p in own) >= min_size:
            fully_shard(sub, mesh=shard_mesh)
    fully_shard(module, mesh=shard_mesh)
    return module
