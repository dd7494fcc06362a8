"""Pipeline parallelism: GPipe-style microbatched stages over a mesh axis.
The port of ``ray_tpu/parallel/pipeline.py``.

Stages live on a ``pipeline`` axis: every rank holds ONE stage's parameters
and a rotating activation buffer that ``collectives.ppermute_next`` advances
one hop per tick.

Schedule: with S stages and M microbatches, tick t in [0, M+S-1):
  - stage 0 injects microbatch t (while t < M),
  - every rank applies its stage to its current activation,
  - activations rotate to the next stage,
  - the last stage emits microbatch t-(S-1) starting at t = S-1.
Utilization is M/(M+S-1) (the pipeline bubble). ``ppermute_next`` is
differentiable (its backward is the reverse rotation), so one
``backward()`` of the pipelined loss trains every stage with no
hand-written backward schedule.

The P2P calls pair up across ranks only if every rank makes the same ones
in the same order, forward and backward. So every rank runs every tick
(bubble ticks included, on zeros, as the reference does), the choices
between the feed and the received activation and between emitting and not
are ``torch.where``s (each rank's backward then reaches every rotation),
and the outputs are replicated by ``collectives.psum_replicated``, whose
backward is the identity: the caller computes its loss from them on every
rank. Autograd then runs the rotations' backwards in reverse tick order on
every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Union

import torch

from ray_tpu_torch.parallel import collectives


def axis_size(axis=None, *, mesh=None) -> int:
    """Size of ``axis`` (a mesh axis name with ``mesh``, a process group,
    or None for the default group)."""
    return collectives._size(collectives._pg(axis, mesh))


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *,
                   axis_name="pipeline", mesh=None):
    """Apply an S-stage pipeline to M microbatches.

    stage_fn(params, x) -> y: one stage's computation; y must have x's
      shape (activations flow stage to stage unchanged in shape).
    stage_params: this rank's stage parameters (anything ``stage_fn``
      takes).
    microbatches: (M, ...) tensor, the same on every rank of the axis.
    axis_name: a mesh axis name (with ``mesh``), a process group, or None
      for the default group.

    Returns (M, ...) outputs, the same on every rank of the axis.
    """
    import torch.distributed as dist

    group = collectives._pg(axis_name, mesh)
    S = collectives._size(group)
    M = microbatches.shape[0]
    idx = dist.get_rank(group) if S > 1 else 0
    dev = microbatches.device
    is_first = torch.tensor(idx == 0, device=dev)
    is_last = torch.tensor(idx == S - 1, device=dev)
    state = torch.zeros_like(microbatches[0])
    outputs: List[torch.Tensor] = [torch.zeros_like(microbatches[0])
                                   for _ in range(M)]
    for t in range(M + S - 1):
        # stage 0 takes microbatch t from the feed (clamped once drained)
        x = torch.where(is_first, microbatches[min(t, M - 1)], state)
        y = stage_fn(stage_params, x)
        # the last stage has finished microbatch t-(S-1) once t >= S-1
        if t >= S - 1:
            out_idx = t - (S - 1)
            outputs[out_idx] = torch.where(is_last, y, outputs[out_idx])
        if t < M + S - 2:  # the last tick's rotation would feed nothing
            state = collectives.ppermute_next(y, group)
    # the last stage's outputs on every rank (zeros elsewhere, so a sum is
    # a broadcast); the backward hands each rank the cotangent as it is
    out = torch.where(is_last, torch.stack(outputs), 0.0)
    return collectives.psum_replicated(out, group)


def stack_stage_params(params_per_stage: Sequence[Union[
        Mapping[str, torch.Tensor], torch.nn.Module, Sequence]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameters into one dict with a leading stage axis
    (the reference stacks pytrees): each stage is a ``state_dict``-like
    mapping, a module (its ``state_dict``) or a list of like modules,
    stacked first as the reference stacks a stage's blocks, so that each
    leaf has leading (stage, layer) axes."""
    def as_dict(stage):
        if isinstance(stage, torch.nn.Module):
            return stage.state_dict()
        if isinstance(stage, Mapping):
            return dict(stage)
        return stack_stage_params(stage)

    dicts = [as_dict(s) for s in params_per_stage]
    if any(d.keys() != dicts[0].keys() for d in dicts):
        raise ValueError("stages hold different parameter names")
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def build_pipeline_fn(stage_fn: Callable, mesh, *,
                      axis_name: str = "pipeline") -> Callable:
    """(stacked_params, microbatches) -> outputs over ``mesh``'s
    ``axis_name``: rank i of the axis runs stage i of ``stacked_params``
    (a dict of tensors with a leading stage axis, from
    ``stack_stage_params``; gradients reach only the rank's own stage's
    slice), the microbatches the same on every rank of the axis."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)

    def fn(stacked: Mapping[str, torch.Tensor], microbatches):
        me = dist.get_rank(group)
        own = {k: v[me] for k, v in stacked.items()}
        return pipeline_apply(stage_fn, own, microbatches, axis_name=group)

    return fn
