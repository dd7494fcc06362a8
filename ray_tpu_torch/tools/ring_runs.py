"""Ring attention's ranks played in one process, shared by ``chip_smoke.py``
(phase 26, at GPT-2's training shape on the card) and the CPU tests
(``tests/test_torch_ring_attention.py``, at a small size).

``ring_fwd_bwd`` runs each of the n ranks of a ring in turn on folded
(B*H, S, D) tensors through ``ops.ring_attention``'s own per-rank loop
(``ring_forward``, ``ring_backward``), with the chunks sliced from the
whole sequence where the module's ring receives them from its neighbour:
each chunk's dk/dv accumulators are the f32 slices of one whole-sequence
buffer, so every rank adds its shares into them as the accumulators riding
the ring do. On CUDA tensors the blocks launch the kernels; ``plain`` runs
their plain versions instead (the yardstick on the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.ring_attention import (block_mode, ring_backward,
                                              ring_block_bwd, ring_block_fwd,
                                              ring_forward)

KINDS = {True: "diag", False: "full"}


def _chunk(t, i, s):
    return t[:, i * s:(i + 1) * s]


def _chunks(tensors, me, n, s, causal, read=None, by_kind=None):
    """Rank ``me``'s chunks in ring order: at step t the slices of
    ``tensors`` at chunk (me - t) % n (K/V made contiguous, as the ring
    receives them; accumulators as views). With ``read`` (the launch
    counters' reading), the launches of each step's block, read before
    and after it, are added to ``by_kind`` under its kind ("diag" or
    "full")."""
    for t in range(n):
        src = (me - t) % n
        before = read() if read is not None else None
        yield tuple(_chunk(x, src, s).contiguous() if i < 2
                    else _chunk(x, src, s) for i, x in enumerate(tensors))
        mode = block_mode(me, src, causal)
        if read is not None and mode is not None:
            after = read()
            kind = by_kind.setdefault(KINDS[mode], dict.fromkeys(after, 0))
            for name, count in after.items():
                kind[name] += count - before[name]


def ring_fwd_bwd(q, k, v, do, n: int, causal: bool,
                 sm_scale: Optional[float] = None, plain: bool = False,
                 with_scales: bool = False,
                 read: Optional[Callable[[], Dict[str, int]]] = None):
    """(out, dq, dk, dv) of attention over folded (B*H, S, D) tensors with
    the sequence in ``n`` equal chunks, each in its input's dtype. With
    ``with_scales``, also ``ring_magnitudes``. With ``read`` (a function
    returning the launch counters), also the launches by block kind,
    {"diag": {...}, "full": {...}}, each block's read around it."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence {S} does not split into {n} chunks")
    s = S // n
    kw = dict(n=n, causal=causal, sm_scale=sm_scale, plain=plain)
    by_kind = {}
    rank = lambda me, tensors: _chunks(tensors, me, n, s, causal, read,
                                       by_kind)
    outs, lses = zip(*(ring_forward(_chunk(q, me, s).contiguous(),
                                    rank(me, (k, v)), me=me, **kw)
                       for me in range(n)))
    dk, dv = (torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in (k, v))
    dq = [ring_backward(_chunk(q, me, s).contiguous(),
                        _chunk(do, me, s).contiguous(), outs[me], lses[me],
                        rank(me, (k, v, dk, dv)), me=me, **kw)
          for me in range(n)]
    result = (torch.cat(outs, dim=1), torch.cat(dq, dim=1).to(q.dtype),
              dk.to(k.dtype), dv.to(v.dtype))
    if with_scales:
        result = result, ring_magnitudes(q, k, v, do, n, causal, sm_scale,
                                         plain)
    if read is not None:
        return result, by_kind
    return result


def ring_magnitudes(q, k, v, do, n: int, causal: bool,
                    sm_scale: Optional[float] = None, plain: bool = False):
    """The f32 magnitudes the ring's roundings scale with
    (``ring_attention.TOL_REASON``), each block run again: for out,
    sum_i w_i |out_i| over the blocks a row merged (w_i = exp(lse_i -
    lse)); for each grad, the sum of its partials' |.|."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = q.shape[1] // n
    kw = dict(causal=causal, sm_scale=sm_scale, plain=plain)
    out_scale, dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float32,
                                         device=t.device)
                             for t in (q, q, k, v))
    for me in range(n):
        q_me, do_me = (_chunk(t, me, s).contiguous() for t in (q, do))
        out, lse = ring_forward(q_me, ((_chunk(k, (me - t) % n, s)
                                        .contiguous(),
                                        _chunk(v, (me - t) % n, s)
                                        .contiguous()) for t in range(n)),
                                me=me, n=n, **kw)
        delta = attn._delta(out, do_me)
        for src in range(n):
            k_src, v_src = (_chunk(t, src, s).contiguous() for t in (k, v))
            block = ring_block_fwd(q_me, k_src, v_src, me=me, src=src, **kw)
            if block is None:
                continue
            _chunk(out_scale, me, s).add_(
                torch.exp(block[1] - lse)[..., None] * block[0].float().abs())
            grads = ring_block_bwd(q_me, k_src, v_src, do_me, lse, delta,
                                   me=me, src=src, **kw)
            for acc, part, i in zip((dq, dk, dv), grads, (me, src, src)):
                _chunk(acc, i, s).add_(part.float().abs())
    return out_scale, dq, dk, dv


def delta_terms(q, k, do, out_limit, causal: bool,
                sm_scale: Optional[float] = None):
    """What the forward's rounding can add to the grads through delta =
    rowsum(dO * O), over the whole sequence in f32: with |O_ring - O_flash|
    bounded element by element by ``out_limit`` (the forward's limit),
    |delta_ring - delta_flash| <= dd = sum_d |dO| out_limit, so dq moves by
    at most scale dd sum_k P |k| and dk by scale sum_q P^T (dd |q|); dv
    takes no delta. Returns the (dq, dk) terms."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    q, k, do = (t.float() for t in (q, k, do))
    dd = (do.abs() * out_limit).sum(dim=-1)
    # sum_k P |k|: the forward with |k| for V
    p_abs_k, lse = attn._flash_plain(q, k, k.abs(), causal=causal,
                                     sm_scale=sm_scale)
    # sum_q P^T (dd |q|): dv's P^T dO with dd |q| for dO
    _, p_t = attn._bwd_dkv_plain(q, k, k, dd[..., None] * q.abs(), lse,
                                 torch.zeros_like(dd), causal=causal,
                                 sm_scale=sm_scale, block_q=128,
                                 block_k=128)
    return sm_scale * dd[..., None] * p_abs_k, sm_scale * p_t


def live_blocks(n: int, causal: bool) -> int:
    """Blocks that launch a kernel in an n-rank ring: n(n+1)/2 causal (the
    diagonal and below), n^2 not."""
    return n * (n + 1) // 2 if causal else n * n
