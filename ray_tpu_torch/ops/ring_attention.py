"""Ring attention: exact attention over sequences sharded across a mesh
axis, K/V chunks rotating round the axis's ring. The port of
``ray_tpu/ops/ring_attention.py``.

The sequence axis is split over the ranks of an axis (a mesh plus axis name,
or a process group); each rank holds q/k/v chunks (..., s/n, d) of equal
length. At step t rank ``me`` holds the K/V chunk of rank ``src = (me - t) %
n`` and runs one flash block on it, then passes the chunk on
(``parallel.collectives``' ring, started before the block so that the
transfer overlaps it). Memory stays O(s/n) per rank and the softmax is exact.

Where the reference folds every block into f32 accumulators in jnp
(``online_block_update``), the port runs each block through its flash
kernels and merges the blocks' (out, lse) (``ring_block_fwd``,
``merge_blocks``):

- causal, ``src < me``: the block is wholly visible, a non-causal launch;
  ``src == me``: the diagonal, a causal launch (the chunks have equal
  lengths, so the kernel's bottom-right causal is the reference's);
  ``src > me``: wholly masked, no launch (the reference folds it in with
  every score masked, which changes nothing). Non-causal runs every block.
- merge: lse = logaddexp(lse_a, lse_b), out = sum_i exp(lse_i - lse) out_i,
  in f32, cast to q's dtype at the end as ``finalize_flash`` does. A row
  always sees its diagonal, so no row is dead.
- backward (``_RingAttention``): delta = rowsum(dO * O) once from the final
  output, then K/V go round the ring again; each live block runs the two
  backward kernels with the global lse and delta
  (``flash_attention_bwd_from_stats``), which makes each block's grads its
  exact share, so no term of the merge is needed. dk/dv accumulators ride
  the ring with their chunk and arrive home after n steps.

The partial grads are summed in f32, but the kernels write their inputs'
dtype, so a bf16 ring sums n bf16-rounded partials (``TOL_REASON``: the
ring's limit against whole-sequence flash). A ring of one rank runs the
same loop: one diagonal block, with no transfer, whose f32 merge and sum
round back to flash's own output and grads to the bit.

``ring_forward`` and ``ring_backward`` are one rank's loop over the chunks
as an iterable yields them: ``_RingAttention`` hands them the chunks as the
ring brings them, ``tools/ring_runs.py`` (the card's phase 26 and the CPU
tests) plays every rank of a ring in one process with the chunks sliced
from the whole sequence.

On CUDA tensors the blocks launch the sm_90a kernels (or raise); on CPU
tensors they run the kernels' plain versions. The CPU tests hold this
against the reference's jnp ring through those plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import attention as _attn

TOL_REASON = ("each ring block writes its out and its dq/dk/dv in the "
              "kernel's dtype, and the ring merges them in f32: every "
              "partial carries one rounding to that dtype (2^-9 relative "
              "in bf16) where whole-sequence flash rounds its sum once, "
              "so where partials cancel the ring's error scales with the "
              "partials and not with the sum; the limit is the TOLS of "
              "the dtype, element by element, with the rtol term taken "
              "of |flash| + sum_i |partial_i| (out: sum_i w_i |out_i|, "
              "w_i = exp(lse_i - lse)). Against flash's backward fed the "
              "ring's out (the same delta) the grads are held at that "
              "limit; against flash's backward from its own out, delta = "
              "rowsum(dO * O) also carries the forward's error into dq and "
              "dk: |delta_ring - delta_flash| <= dd = sum_d |dO| times the "
              "forward's limit, so dq's limit gains scale * dd * sum_k P|k| "
              "and dk's scale * sum_q P^T (dd |q|) (dv takes no delta)")

Acc = Tuple[torch.Tensor, torch.Tensor]


def block_mode(me: int, src: int, causal: bool) -> Optional[bool]:
    """How rank ``me``'s queries meet the K/V chunk of rank ``src``: None
    (wholly masked: no launch), True (the diagonal: a causal launch) or
    False (wholly visible)."""
    if not causal:
        return False
    if src > me:
        return None
    return src == me


def ring_block_fwd(q, k, v, *, me: int, src: int, causal: bool,
                   sm_scale: float, plain: bool = False) -> Optional[Acc]:
    """One ring step's block on folded (B*H, S, D) chunks: (out, lse) of
    ``flash_attention_fwd``, or None for a masked block. ``plain`` runs the
    kernel's plain version on any device (the yardstick on the card)."""
    mode = block_mode(me, src, causal)
    if mode is None:
        return None
    if plain:
        return _attn._flash_plain(q, k, v, causal=mode, sm_scale=sm_scale)
    return _attn.flash_attention_fwd(q, k, v, causal=mode, sm_scale=sm_scale)


def merge_blocks(acc: Optional[Acc], block: Optional[Acc]) -> Optional[Acc]:
    """Fold one block's (out, lse) into the f32 accumulators (out, lse)."""
    if block is None:
        return acc
    out, lse = block
    if acc is None:
        return out.float(), lse
    acc_out, acc_lse = acc
    new = torch.logaddexp(acc_lse, lse)
    merged = (torch.exp(acc_lse - new)[..., None] * acc_out
              + torch.exp(lse - new)[..., None] * out.float())
    return merged, new


def ring_block_bwd(q, k, v, do, lse, delta, *, me: int, src: int,
                   causal: bool, sm_scale: float, plain: bool = False):
    """One ring step's (dq, dk, dv) share, each in its input's dtype, from
    the global ``lse`` and ``delta``; None for a masked block. ``plain`` as
    in ``ring_block_fwd``."""
    mode = block_mode(me, src, causal)
    if mode is None:
        return None
    if plain:
        kw = dict(causal=mode, sm_scale=sm_scale, block_q=64, block_k=64)
        return (_attn._bwd_dq_plain(q, k, v, do, lse, delta, **kw),
                *_attn._bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    return _attn.flash_attention_bwd_from_stats(q, k, v, do, lse, delta,
                                                causal=mode,
                                                sm_scale=sm_scale)


def ring_forward(q, chunks, *, me: int, n: int, causal: bool,
                 sm_scale: float, plain: bool = False) -> Acc:
    """Rank ``me``'s (out in q's dtype, lse f32) over a ring of ``n``:
    ``chunks`` yields, at step t, the K/V chunk (k, v) of rank (me - t) %
    n; each block is merged into the f32 accumulators as it comes."""
    acc = None
    for t, (k, v) in enumerate(chunks):
        acc = merge_blocks(acc, ring_block_fwd(
            q, k, v, me=me, src=(me - t) % n, causal=causal,
            sm_scale=sm_scale, plain=plain))
    return acc[0].to(q.dtype), acc[1]


def ring_backward(q, do, out, lse, chunks, *, me: int, n: int,
                  causal: bool, sm_scale: float, plain: bool = False
                  ) -> torch.Tensor:
    """Rank ``me``'s dq (f32) over a ring of ``n``, from its final ``out``
    and global ``lse``: ``chunks`` yields, at step t, (k, v, dk, dv) of the
    chunk of rank (me - t) % n, dk/dv its f32 accumulators, to which the
    block's shares are added in place."""
    delta = _attn._delta(out, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t, (k, v, dk, dv) in enumerate(chunks):
        grads = ring_block_bwd(q, k, v, do, lse, delta, me=me,
                               src=(me - t) % n, causal=causal,
                               sm_scale=sm_scale, plain=plain)
        if grads is not None:
            dq += grads[0].float()
            dk += grads[1].float()
            dv += grads[2].float()
    return dq


def _start_rotation(tensors, group):
    """Send each tensor to the next rank and receive the previous rank's,
    without waiting: (received tensors, works)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.collectives import _ring_peers

    nxt, prev = _ring_peers(group)
    ops, outs = [], []
    for t in tensors:
        out = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, out, prev, group)]
        outs.append(out)
    return outs, dist.batch_isend_irecv(ops)


def _rotate(tensors, group):
    received, works = _start_rotation(tensors, group)
    for work in works:
        work.wait()
    return received


def _ring_chunks(k, v, group, n: int, grads=None):
    """The K/V chunks as they come round ``group``'s ring of ``n``: this
    rank's first, the transfer of the next one started before the current
    block runs, so that it overlaps the block (none at n = 1). With
    ``grads`` (a list [dk, dv] of f32 accumulators) each step also yields
    the accumulators of the chunk it holds, which follow their chunk one hop
    behind it; after the last step one more hop brings this rank's own
    chunk's home, into ``grads``."""
    acc = grads
    for t in range(n):
        if grads is not None and t:
            acc = _rotate(acc, group)
        if t < n - 1:
            nxt, works = _start_rotation((k, v), group)
        yield (k, v) if grads is None else (k, v, *acc)
        if t < n - 1:
            for work in works:
                work.wait()
            k, v = nxt
    if grads is not None:
        grads[:] = _rotate(acc, group) if n > 1 else acc


class _RingAttention(torch.autograd.Function):
    """Ring attention on folded (B*H, S_local, D) chunks over ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, group, n: int, me: int, causal: bool,
                sm_scale: float):
        ctx.ring = (group, n, me, causal, sm_scale)
        out, lse = ring_forward(q, _ring_chunks(k, v, group, n), me=me, n=n,
                                causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, me, causal, sm_scale = ctx.ring
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for t in (k, v)]
        dq = ring_backward(q, do.contiguous(), out, lse,
                           _ring_chunks(k, v, group, n, grads), me=me, n=n,
                           causal=causal, sm_scale=sm_scale)
        dk, dv = grads
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, *, axis_name=None, causal: bool = False,
                   sm_scale: Optional[float] = None, mesh=None
                   ) -> torch.Tensor:
    """Exact attention with K/V rotating round the ring of ``axis_name``: a
    mesh axis name (with ``mesh``), a process group, or None for the
    default group. q, k, v are this rank's sequence chunks (..., s_local,
    d), of the same length on every rank; returns this rank's output chunk.
    Differentiable; every rank of the axis must call it, in the same
    order."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.collectives import _pg

    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    group = _pg(axis_name, mesh)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if k.shape[-2] != q.shape[-2]:
        raise ValueError("ring_attention: q and k/v chunks must have the "
                         f"same length, got {q.shape[-2]} and {k.shape[-2]}")
    fold = lambda t: t.reshape(-1, t.shape[-2], t.shape[-1]).contiguous()
    out = _RingAttention.apply(fold(q), fold(k), fold(v), group, n, me,
                               causal, sm_scale)
    return out.reshape(q.shape)


def ring_self_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v are the GLOBAL (b, h, s, d) tensors, the same on every rank:
    each rank takes its chunk of s over ``seq_axis``, runs
    ``ring_attention`` and all ranks gather the global output (the
    reference's ``shard_map`` with s split over the axis). The gradient
    reaching each rank's q, k and v is its own chunk's (zero elsewhere), as
    each shard's is under ``shard_map``."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.collectives import all_gather_replicated

    group = mesh.get_group(seq_axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    s = q.shape[-2]
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} ranks")
    chunk = lambda t: t.narrow(-2, me * (s // n), s // n)
    out = ring_attention(chunk(q), chunk(k), chunk(v), axis_name=group,
                         causal=causal, sm_scale=sm_scale)
    return all_gather_replicated(out, group, dim=out.dim() - 2)
