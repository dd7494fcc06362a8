"""Device-mesh construction and sharding helpers — the GPU device plane.

The reference lays a ``jax.sharding.Mesh`` over a pod's chips and lets the
XLA partitioner insert collectives. The port lays a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes, in the
same order, over the ranks of the gang's process group (one rank per CUDA
card, or per CPU process under gloo): each axis is a process group, data
parallelism is DDP over the data axes' group, and parameter sharding is FSDP2
(``fully_shard``) over the ``fsdp`` axis, HSDP when a ``data`` axis is there
too. Tensor parallelism (``apply_tp_plan``) slices each parameter of a
plan over the ``model`` axis and gives its Dense layer the collectives of
Megatron's layout.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


def logical_to_physical(logical_axes: Sequence[Optional[str]],
                        rules: Mapping[str, Optional[str]]
                        ) -> Tuple[Optional[str], ...]:
    """Map logical array axes to mesh axis names via sharding rules (the
    scaling-book recipe: annotate logically, map with one rule table). The
    reference returns a ``PartitionSpec``; the port has none, so this is
    the tuple of its entries."""
    return tuple(rules.get(a) if a else None for a in logical_axes)


def flat_group(mesh, axes: Sequence[str]):
    """One process group over ``axes`` of ``mesh`` together, its ranks in
    row-major order of the mesh: one axis's group, the default group when
    ``axes`` are all of the mesh's axes, else the flattened sub-mesh's."""
    import torch.distributed as dist

    names = [a for a in mesh.mesh_dim_names if a in axes]
    if len(names) != len(axes):
        raise ValueError(f"axes {tuple(axes)} are not all axes of the mesh "
                         f"{mesh.mesh_dim_names}")
    if len(names) == 1:
        return mesh.get_group(names[0])
    if len(names) == len(mesh.mesh_dim_names):
        return dist.group.WORLD
    return mesh[tuple(names)]._flatten().get_group()


# Tensor-parallel placements of a torch parameter over the model axis: "rep"
# replicated; "col" split on dim 0 (a Linear weight's output features, or
# the bias of such a layer); "row" split on dim 1 (its input features);
# "col_qkv" a fused q|k|v weight or bias (3C rows), each third split on
# dim 0, so that a rank holds whole heads of each of q, k and v.
TP_PLACEMENTS = ("rep", "col", "row", "col_qkv")


def tp_slice(t, placement: str, index: int, n: int):
    """Rank ``index`` of ``n``'s part of the full tensor ``t`` under
    ``placement`` (a contiguous copy; ``t`` itself for "rep")."""
    import torch

    if placement == "rep":
        return t
    if placement == "col_qkv":
        return torch.cat([tp_slice(part, "col", index, n)
                          for part in t.chunk(3, dim=0)])
    dim = {"col": 0, "row": 1}.get(placement)
    if dim is None:
        raise ValueError(f"unknown tensor-parallel placement {placement!r}")
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).contiguous()


def apply_tp_plan(module, plan: Mapping[str, str], mesh,
                  model_axis: str = "model"):
    """Place ``module``'s parameters by ``plan`` ({parameter name:
    placement}, ``TP_PLACEMENTS``) over ``mesh``'s ``model_axis``: each
    sharded parameter keeps this rank's part in place (the same Parameter
    object, so an optimizer over it stays valid), and each Dense layer whose
    weight is split gets its collectives: a column-parallel layer (weight
    "col" or "col_qkv") sums its input's gradient over the axis
    (``collectives.pbroadcast``), a row-parallel one ("row") sums its
    product over the axis (``collectives.psum_replicated``) before its
    bias. The counterpart of placing the reference's tree with its
    shardings. Returns ``module``."""
    group = mesh.get_group(model_axis)
    n, index = mesh.size(mesh.mesh_dim_names.index(model_axis)), \
        mesh.get_local_rank(model_axis)
    params = dict(module.named_parameters())
    if set(plan) != set(params):
        raise ValueError("the plan does not name every parameter of the "
                         "module")
    for name, placement in plan.items():
        if placement != "rep":
            params[name].data = tp_slice(params[name].data, placement,
                                         index, n)
    for name, mod in module.named_modules():
        placement = plan.get(f"{name}.weight") if name else None
        if placement in ("col", "col_qkv", "row"):
            if not hasattr(mod, "tp_mode"):
                raise ValueError(f"{name} is split but is not a Dense "
                                 "layer")
            mod.tp_mode = "row" if placement == "row" else "col"
            mod.tp_group = group
    return module
