"""Collectives over a process group or a mesh axis — the NVLink fast path.

The reference's are XLA ops inside ``shard_map`` that the partitioner lays
onto ICI rings. The port's are ``torch.distributed`` calls on tensors (NCCL
on CUDA tensors, gloo on CPU ones) over ``axis``: a mesh axis name (with
``mesh=``), a ProcessGroup, or None for the default group. Use them inside
the train step (``models.gpt2.build_train_step``'s DDP communication hooks
call ``chunked_psum`` and ``quantized_psum``); the out-of-step API
(ray_tpu_torch.util.collective) is for orchestration-sized data. Each
returns a new tensor and leaves its input as it was.

Four of them carry autograd, for model parallelism inside the step, where
the reference's ``shard_map`` gives each collective its transpose:

- ``ppermute_next`` rotates a tensor one hop round an axis's ring (ring
  attention's K/V, the pipeline's activations); its backward is the reverse
  rotation.
- ``psum_replicated`` sums a rank-varying value into one that every rank
  holds (``lax.psum`` of a varying value into an invariant one); its
  backward is the identity, because every rank goes on to compute the same
  loss from the sum. (``torch.distributed.nn.functional.all_reduce`` sums
  the cotangent over the ranks too, which multiplies such gradients by the
  axis size.)
- ``pbroadcast`` is its conjugate: the identity forward, a sum of the
  cotangents over the axis backward (a replicated input of a sharded
  product, Megatron's "f").
- ``all_gather_replicated`` gathers every rank's block into one tensor
  that every rank holds; its backward hands each rank its block's slice.

At an axis of size 1 each is the identity and makes no call.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence


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


def _ring_peers(group):
    """(global rank of the next, of the previous rank) on ``group``'s ring."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    peer = lambda i: dist.get_global_rank(group, i) if group is not None \
        and group is not dist.group.WORLD else i
    return peer((me + 1) % n), peer((me - 1) % n)


def _rotate(x, group, backward: bool = False):
    """One ``batch_isend_irecv``: send ``x`` to the next rank and receive
    the previous rank's (the reverse with ``backward``)."""
    import torch
    import torch.distributed as dist

    nxt, prev = _ring_peers(group)
    to, frm = (prev, nxt) if backward else (nxt, prev)
    x = x.contiguous()
    out = torch.empty_like(x)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        work.wait()
    return out


def _function_classes():
    import torch

    class RingPermute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return _rotate(x, group)

        @staticmethod
        def backward(ctx, grad):
            return _rotate(grad, ctx.group, backward=True), None

    class PsumReplicated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            return psum(x, group)

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    class PBroadcast(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            return psum(grad, ctx.group), None

    class GatherReplicated(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            import torch.distributed as dist

            ctx.group, ctx.dim = group, dim
            ctx.index, ctx.size = dist.get_rank(group), x.shape[dim]
            return all_gather(x, group, axis_index=dim)

        @staticmethod
        def backward(ctx, grad):
            return grad.narrow(ctx.dim, ctx.index * ctx.size,
                               ctx.size), None, None

    return {f.__name__: f for f in (RingPermute, PsumReplicated, PBroadcast,
                                    GatherReplicated)}


_FUNCTIONS = None


def _fn(name: str):
    """The autograd Function ``name``, defined at the first call (this
    module imports torch only inside its functions)."""
    global _FUNCTIONS
    if _FUNCTIONS is None:
        _FUNCTIONS = _function_classes()
    return _FUNCTIONS[name]


def ppermute_next(x, axis=None, *, mesh=None):
    """Rotate ``x`` one hop round the ring of ``axis``: rank r sends to
    (r + 1) % n and receives from (r - 1) % n, in one
    ``batch_isend_irecv``. Differentiable: the backward rotates the
    cotangent the other way. Every rank of the axis must call it, in the
    same order, and so must every rank's backward."""
    group = _pg(axis, mesh)
    if _size(group) == 1:
        return x
    return _fn("RingPermute").apply(x, group)


def psum_replicated(x, axis=None, *, mesh=None):
    """The sum of every rank's ``x`` over ``axis``, held by each rank, with
    an identity backward (see the module's note)."""
    group = _pg(axis, mesh)
    if _size(group) == 1:
        return x
    return _fn("PsumReplicated").apply(x, group)


def pbroadcast(x, axis=None, *, mesh=None):
    """``x`` as it is, with the backward summing the cotangent over
    ``axis`` (see the module's note)."""
    group = _pg(axis, mesh)
    if _size(group) == 1:
        return x
    return _fn("PBroadcast").apply(x, group)


def all_gather_replicated(x, axis=None, *, dim: int = 0, mesh=None):
    """Every rank's ``x`` concatenated along ``dim`` in the axis's rank
    order, held by each rank; the backward hands each rank the slice of
    the cotangent at its own block (the transpose of gathering a varying
    value into an invariant one)."""
    group = _pg(axis, mesh)
    if _size(group) == 1:
        return x
    return _fn("GatherReplicated").apply(x, group, dim)


def psum_tensors_(tensors: Iterable, groups: Sequence, *, scale=None):
    """Sum each tensor of ``tensors`` over every group of ``groups`` in
    turn, in place, through one flat buffer per dtype (one all-reduce per
    group); then multiply by ``scale`` if given. Groups of size 1 make no
    call. A gradient reduction after ``backward()``."""
    import torch
    import torch.distributed as dist

    groups = [g for g in groups if _size(g) > 1]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        if groups:
            flat = torch.cat([t.reshape(-1) for t in ts])
            for g in groups:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
        if scale is not None and scale != 1:
            torch._foreach_mul_(ts, scale)
