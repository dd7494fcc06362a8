"""Collectives over a process group or a mesh axis — the NVLink fast path.

The reference's are XLA ops inside ``shard_map`` that the partitioner lays
onto ICI rings. The port's are ``torch.distributed`` calls on tensors (NCCL
on CUDA tensors, gloo on CPU ones) over ``axis``: a mesh axis name (with
``mesh=``), a ProcessGroup, or None for the default group. Use them inside
the train step (``models.gpt2.build_train_step``'s DDP communication hooks
call ``chunked_psum`` and ``quantized_psum``); the out-of-step API
(ray_tpu_torch.util.collective) is for orchestration-sized data. Each
returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

from typing import Optional, Sequence


def _pg(axis, mesh=None):
    if isinstance(axis, str):
        if mesh is None:
            raise ValueError(f"axis {axis!r} needs mesh=")
        return mesh.get_group(axis)
    return axis


def _size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def _gather_stacked(x, group, n: int):
    """(n, *x.shape): every rank's ``x`` in the group's rank order. The
    flat concatenation is the output form every backend takes (gloo takes
    no stacked one)."""
    import torch.distributed as dist

    flat = x.reshape(-1).contiguous()
    out = flat.new_empty((n * flat.numel(),))
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((n,) + tuple(x.shape))


def psum(x, axis=None, *, mesh=None):
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_pg(axis, mesh))
    return out


def pmean(x, axis=None, *, mesh=None):
    group = _pg(axis, mesh)
    return psum(x, group) / _size(group)


def all_gather(x, axis=None, *, axis_index: int = 0, tiled: bool = True,
               mesh=None):
    """Every rank's ``x`` along ``axis_index``: concatenated (``tiled``)
    or stacked on a new dim there, in the group's rank order."""
    import torch.distributed as dist

    group = _pg(axis, mesh)
    n = _size(group)
    out = _gather_stacked(x, group, n).movedim(0, axis_index)
    if tiled:
        shape = list(x.shape)
        shape[axis_index] *= n
        out = out.reshape(shape)
    return out


def reduce_scatter(x, axis=None, *, scatter_axis: int = 0, mesh=None):
    """The sum over ranks, split along ``scatter_axis`` into one block per
    rank; rank i (in the group's order) gets block i."""
    import torch.distributed as dist

    group = _pg(axis, mesh)
    n = _size(group)
    xt = x.movedim(scatter_axis, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, scatter_axis)


def chunked_psum(x, axis=None, *, chunks: int = 4, mesh=None):
    """psum issued as ``chunks`` independent all-reduces over equal slices
    of the flattened operand (zero-padded to a multiple of ``chunks``),
    all in flight at once (``async_op``) — the in-step twin of the store
    backend's chunked allreduce: NCCL can move chunk 0 while later chunks
    are still queued. For tensors smaller than ``chunks`` elements (or
    chunks<=1) this degenerates to a plain psum. The sums are psum's."""
    import torch
    import torch.distributed as dist

    n = x.numel()
    if chunks <= 1 or n < chunks:
        return psum(x, axis, mesh=mesh)
    group = _pg(axis, mesh)
    pad = (-n) % chunks
    flat = x.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.clone()
    works = [dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group,
                             async_op=True)
             for part in flat.split(flat.numel() // chunks)]
    for work in works:
        work.wait()
    return flat[:n].reshape(x.shape)


def quantized_psum(x, axis=None, *, mean: bool = False,
                   segments: Optional[Sequence[int]] = None, mesh=None):
    """EQuARX-style int8 allreduce: each rank quantizes its contribution
    (symmetric, scale = max|x|/127, one scale per tensor), the int8 values
    and the scales ride an all_gather, and every rank dequantizes and sums
    locally — ~4x fewer bytes than an f32 all-reduce at the cost of one
    rounding per contribution. SUM (or MEAN with ``mean=True``); the
    result is float32. ``segments`` (element counts that sum to
    ``x.numel()``) quantizes each consecutive piece of the flattened ``x``
    with its own scale, as if each were its own tensor: what a DDP bucket
    of many parameters needs to give the per-parameter result."""
    import torch
    import torch.distributed as dist

    group = _pg(axis, mesh)
    n = _size(group)
    flat = x.reshape(-1).float()
    sizes = list(segments) if segments is not None else [flat.numel()]
    if sum(sizes) != flat.numel():
        raise ValueError(f"segments sum to {sum(sizes)}, the tensor has "
                         f"{flat.numel()} elements")
    parts = flat.split(sizes)
    amax = torch.stack([p.abs().max() if p.numel() else p.new_zeros(())
                        for p in parts])
    # zero-safe: an all-zero block keeps scale 1 so dequant stays zeros
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    per_elem = torch.repeat_interleave(
        scale, torch.tensor(sizes, device=scale.device))
    q = torch.clamp(torch.round(flat / per_elem), -127, 127).to(torch.int8)
    qs = _gather_stacked(q, group, n)
    scales = _gather_stacked(scale, group, n)
    deq = qs.float() * torch.repeat_interleave(
        scales, torch.tensor(sizes, device=scales.device), dim=1)
    out = deq.sum(dim=0)
    if mean:
        out = out / n
    return out.reshape(x.shape)


def compiled_allreduce(mesh, axis: str = "data"):
    """An allreduce over one mesh axis as a plain function (the reference
    jits a ``shard_map`` psum, the benchmarkable unit of its allreduce
    scaling): ``fn(x)`` is the psum of every rank's ``x`` on that axis."""
    group = mesh.get_group(axis)

    def fn(x):
        return psum(x, group)

    return fn
