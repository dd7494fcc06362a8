"""Switch-style top-1 mixture of experts: the port of ``ray_tpu/ops/moe.py``.

Routing (``switch_gating``, ``route``) follows the reference: the router's
probabilities and their first maximum in f32, queue positions by a
cumulative sum over the integer one-hot (a cumulative sum in a 16-bit float
collides slots past 256 tokens per expert), capacity
``max(1, ceil(int(capacity_factor * T) / E))`` and Switch's load-balance
loss. A token past its expert's capacity is dropped: it gets no slot and
its output is 0, so the caller's residual carries it.

Two dispatches of one function:

- ``moe_ffn`` (the path): each token's (expert, slot) as an index. Kept
  tokens are copied into a flat (E*C + 1, d) buffer whose last row takes
  the dropped ones, the experts run on its first E*C rows, and each token
  gathers its row back times its gate. Shapes stay static and no boolean
  mask selects rows, so the host never waits for the card.
- ``moe_ffn_dense`` (the plain version): the reference's dense (T, E, C)
  ``dispatch`` and ``combine`` einsums. Each kept slot holds one token and
  each token at most one slot, so every sum of those einsums adds one
  product to exact zeros: both forms give the same outputs, aux and expert
  gradients to the bit. The gate's gradient is the one d-long dot product
  (dOut . expert row), a GEMM's in the one-hot form and a row sum here, so
  the router's and the input's gradients agree to a few ulps. It costs
  2*T*E*C*d operations per einsum and two (T, E, C) tensors; tests and the
  card's yardstick run it, nothing else.

Expert parallelism (``moe_ffn_ep``, ``ep_loss_and_grads``) runs over
``torch.distributed`` process groups where the reference has mesh axes:
experts shard over the EP group and tokens reach them and return by
``all_to_all_single``, which carries autograd.

No TPU kernel lies behind this module: the reference's routing, einsums and
expert products are jnp code that XLA compiles outside any Pallas kernel.
The expert FFN is ``torch.bmm`` over experts and runs in the caller's dtype
(f32 in the MoE LM).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device

Params = Mapping[str, torch.Tensor]


def expert_capacity(tokens: int, experts: int,
                    capacity_factor: float) -> int:
    """Slots per expert: the reference's ``max(1, -(-int(cf * T) // E))``
    (the product truncated before the ceiling)."""
    return max(1, -(-int(capacity_factor * tokens) // experts))


def route(logits: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """Top-1 routing of ``logits`` (T, E) by index: (expert (T,) int64,
    slot (T,) int64 (the token's queue position, which may pass
    ``capacity``), keep (T,) bool, gate (T,) the router probability of the
    chosen expert, aux the Switch load-balance loss E * sum_e f_e P_e)."""
    E = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    # the one-hot expert-major (E, T), so that the queue positions are a
    # scan along the innermost dim: on the card a scan along the outer dim
    # of a (T, E) tensor runs E threads down T rows
    hot = expert == torch.arange(E, device=logits.device)[:, None]
    slot = torch.cumsum(hot, dim=1).gather(0, expert[None, :])[0] - 1
    keep = slot < capacity
    gate = probs.gather(1, expert[:, None])[:, 0]
    f = hot.to(logits.dtype).mean(dim=1)
    aux = E * (f * probs.mean(dim=0)).sum()
    return expert, slot, keep, gate, aux


def switch_gating(logits: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's dense gating: (dispatch (T, E, C), the one-hot
    token-to-slot map in ``logits``' dtype, combine = dispatch * gate, aux)."""
    T, E = logits.shape
    expert, slot, keep, gate, aux = route(logits, capacity)
    cells = torch.arange(E * capacity, device=logits.device)
    flat = torch.where(keep, expert * capacity + slot, -1)
    dispatch = (flat[:, None] == cells).to(logits.dtype).view(T, E, capacity)
    return dispatch, dispatch * gate[:, None, None], aux


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_hidden: int, num_experts: int,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Router (d, E) ~ N(0, 1/d) and the experts' ``wi`` (E, d, h) ~
    N(0, 1/d) and ``wo`` (E, h, d) ~ N(0, 1/h), stacked on the expert dim
    so that an EP shard is a contiguous slice: the reference's scales, drawn
    from ``generator`` on the CPU and moved to ``device`` (the CUDA card by
    default, which raises without one)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draw = lambda shape, fan_in: (torch.randn(shape, generator=generator)
                                  * fan_in ** -0.5)
    params = {"router": draw((d_model, num_experts), d_model),
              "wi": draw((num_experts, d_model, d_hidden), d_model),
              "wo": draw((num_experts, d_hidden, d_model), d_hidden)}
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def expert_ffn(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """Each expert's GELU (tanh) FFN over its rows: x (E, C, d) ->
    (E, C, d)."""
    return torch.bmm(F.gelu(torch.bmm(x, wi), approximate="tanh"), wo)


def _dispatch(x, expert, slot, keep, experts: int, capacity: int):
    """(expert_in (E, C, d), flat (T,)): each kept token copied to its
    (expert, slot) row; ``flat`` is that row in the flat (E*C + 1, d)
    buffer, E*C (a row no expert reads) for a dropped token."""
    cells = experts * capacity
    flat = torch.where(keep, expert * capacity + slot, cells)
    buf = x.new_zeros(cells + 1, x.shape[1]).index_copy(0, flat, x)
    return buf[:cells].view(experts, capacity, -1), flat


def _combine(expert_out, flat, gate):
    """Each token's expert output row times its gate; a dropped token reads
    the zero row past the last slot."""
    rows = F.pad(expert_out.reshape(-1, expert_out.shape[-1]), (0, 0, 0, 1))
    return rows.index_select(0, flat) * gate[:, None]


def moe_ffn(params: Params, x: torch.Tensor, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE with all experts local, dispatched by index: x (T, d) ->
    (out (T, d), aux), the one-hot form's outputs to the bit (see the
    module docstring)."""
    E = params["router"].shape[1]
    capacity = expert_capacity(x.shape[0], E, capacity_factor)
    expert, slot, keep, gate, aux = route(x @ params["router"], capacity)
    expert_in, flat = _dispatch(x, expert, slot, keep, E, capacity)
    expert_out = expert_ffn(params["wi"], params["wo"], expert_in)
    return _combine(expert_out, flat, gate), aux


def moe_ffn_dense(params: Params, x: torch.Tensor,
                  capacity_factor: float = 1.25
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` through the reference's dense (T, E, C) dispatch and
    combine einsums: the plain version that ``moe_ffn`` is held against."""
    E = params["router"].shape[1]
    capacity = expert_capacity(x.shape[0], E, capacity_factor)
    dispatch, combine, aux = switch_gating(x @ params["router"], capacity)
    expert_in = torch.einsum("td,tec->ecd", x, dispatch)
    expert_out = expert_ffn(params["wi"], params["wo"], expert_in)
    return torch.einsum("ecd,tec->td", expert_out, combine), aux


def moe_ffn_ep(params: Params, x: torch.Tensor, group,
               capacity_factor: float = 1.25
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on one rank of the EP process group ``group``:
    ``params["wi"]``/``["wo"]`` hold this rank's E_local experts (rank i of
    the group holds experts [i*E_local, (i+1)*E_local)), the router is
    replicated and ``x`` (T, d) are this rank's tokens. Capacity comes from
    the local T and the global E = n * E_local. Every rank dispatches its
    tokens to all E experts, an all-to-all hands each rank its experts'
    (E_local, n*C, d) rows from every sender, the experts run, and the
    inverse all-to-all returns each sender its rows. aux is this rank's
    (local tokens); the caller averages it over the shards."""
    from torch.distributed.nn.functional import all_to_all_single

    n = torch.distributed.get_world_size(group)
    E_local = params["wi"].shape[0]
    E = n * E_local
    capacity = expert_capacity(x.shape[0], E, capacity_factor)
    expert, slot, keep, gate, aux = route(x @ params["router"], capacity)
    expert_in, flat = _dispatch(x, expert, slot, keep, E, capacity)
    d = x.shape[1]
    # chunk i of the expert dim goes to rank i; chunk j received came from
    # rank j: (n senders, E_local, C, d)
    received = all_to_all_single(torch.empty_like(expert_in), expert_in,
                                 group=group)
    rows = received.view(n, E_local, capacity, d).transpose(0, 1)
    expert_out = expert_ffn(params["wi"], params["wo"],
                            rows.reshape(E_local, n * capacity, d))
    back = expert_out.view(E_local, n, capacity, d).transpose(0, 1)
    returned = all_to_all_single(torch.empty_like(expert_in),
                                 back.reshape(E, capacity, d), group=group)
    return _combine(returned, flat, gate), aux


def ep_loss_and_grads(loss_fn: Callable[[Dict[str, torch.Tensor]],
                                        torch.Tensor],
                      params: Dict[str, torch.Tensor], data_group, ep_group
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's EP training-step pattern over process groups, with
    tokens sharded over both groups (no rank may hold another's tokens):
    differentiate this rank's loss / N (N = data size * EP size); the global
    loss is its sum over both groups; the router's gradient (replicated) is
    summed over both groups, the experts' (sharded over EP) over the data
    group only. ``loss_fn(params) -> local scalar``, unscaled; ``params``
    require gradients. Returns (loss, {name: gradient})."""
    dist = torch.distributed
    n = dist.get_world_size(data_group) * dist.get_world_size(ep_group)
    scaled = loss_fn(params) / n
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(
        scaled, [params[k] for k in names])))
    loss = scaled.detach().clone()
    for group in (data_group, ep_group):
        dist.all_reduce(loss, group=group)
    for k, g in grads.items():
        dist.all_reduce(g, group=data_group)
        if k == "router":
            dist.all_reduce(g, group=ep_group)
    return loss, grads
