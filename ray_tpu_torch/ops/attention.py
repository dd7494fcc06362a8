"""Attention ops: the flash-attention forward as a hand-written Hopper kernel,
with its plain PyTorch version beside it.

PyTorch counterpart of ``ray_tpu/ops/attention.py``:

- ``attention_reference``: naive full-matrix attention for numerics tests.
- ``online_block_update`` / ``finalize_flash``: the online-softmax fold, and
  ``_flash_plain`` built from them, the blockwise version the CPU path runs
  and the kernel is held against.
- ``flash_attention_fwd``: (out, lse) on folded (B*H, S, D) tensors. On a
  CUDA tensor it launches ``csrc/flash_fwd.cu`` (the port of the TPU
  ``_fwd_kernel``) or raises; on a CPU tensor it runs ``_flash_plain``.
- ``flash_attention``: (b, h, s, d) or (b, s, d), forward only.

Masking: the causal mask is bottom-right aligned (query i sees key j when
``i + (k_len - q_len) >= j``). Rows with no live column give out = 0 and
lse = +inf on every path but ``attention_reference``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128)

# launches of the CUDA kernel in this process (plain-version calls not counted)
flash_fwd_launches = 0
_lib: Optional[ctypes.CDLL] = None


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax(QK^T)V. Shapes: (..., s, d)."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q, k) * sm_scale
    if causal:
        q_len, k_len = s.shape[-2], s.shape[-1]
        qi = torch.arange(q_len, device=q.device)[:, None]
        ki = torch.arange(k_len, device=q.device)[None, :]
        s = torch.where(qi + (k_len - q_len) >= ki, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v).to(q.dtype)


def online_block_update(q, k, v, m, l, acc, *, sm_scale: float,
                        q_offset: int = 0, k_offset: int = 0,
                        causal: bool = False, k_total: Optional[int] = None):
    """Fold one KV block into flash accumulators.

    q: (..., bq, d); k/v: (..., bk, d); m, l: (..., bq); acc: (..., bq, d).
    Offsets are the blocks' global sequence positions; ``k_total`` masks
    padding columns past the true sequence end. Masked scores are -inf, so a
    row with no live column keeps m = -inf and the guards give it p = 0.
    """
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    bq, bk = s.shape[-2], s.shape[-1]
    qi = torch.arange(bq, device=s.device)[:, None] + q_offset
    ki = torch.arange(bk, device=s.device)[None, :] + k_offset
    if causal:
        s = torch.where(qi >= ki, s, -math.inf)
    if k_total is not None:
        s = torch.where(ki < k_total, s, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    live = torch.isfinite(m_new)
    safe_m = torch.where(live, m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(live[..., None], p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v.float())
    return m_new, l_new, acc_new


def finalize_flash(m, l, acc, dtype):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype)


def _flash_plain(q, k, v, *, causal: bool, sm_scale: float,
                 block_k: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online softmax over (..., s, d): (out, lse), f32 inside.
    The plain version of the kernel, and the CPU path."""
    *lead, q_len, d = q.shape
    k_len = k.shape[-2]
    block_k = min(block_k, k_len)
    m = torch.full((*lead, q_len), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((*lead, q_len), dtype=torch.float32, device=q.device)
    acc = torch.zeros((*lead, q_len, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, k_len, block_k):
        m, l, acc = online_block_update(
            q, k[..., k0:k0 + block_k, :], v[..., k0:k0 + block_k, :],
            m, l, acc, sm_scale=sm_scale, q_offset=k_len - q_len,
            k_offset=k0, causal=causal,
            k_total=k_len if k0 + block_k > k_len else None)
    lse = torch.where(l == 0.0, math.inf,
                      torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(torch.where(l == 0.0, 1.0, l)))
    return finalize_flash(m, l, acc, q.dtype), lse


def _load_kernel() -> ctypes.CDLL:
    """The kernel's library, built by nvcc at the first call."""
    global _lib
    if _lib is None:
        from ray_tpu_torch.ops import _build

        lib = _build.load(_SOURCE)
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd kernel: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dim() != 3:
            raise ValueError(f"flash_fwd kernel: {name} must be (B*H, S, D), "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel: {name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_fwd kernel: q, k, v must share one dtype "
                             "and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd kernel: unsupported dtype {q.dtype}")
    bh, q_len, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel: head dim {d} not in {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_fwd kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if bh < 1 or q_len < 1 or k.shape[1] < 1:
        raise ValueError("flash_fwd kernel: empty input")


def _flash_kernel(q, k, v, *, causal: bool, sm_scale: float):
    global flash_fwd_launches
    _check_kernel_inputs(q, k, v)
    lib = _load_kernel()
    bh, q_len, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, q_len), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), bh, q_len,
                            k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
                            float(sm_scale), stream)
    if err != 0:
        raise RuntimeError("flash_fwd kernel launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    flash_fwd_launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """(out, lse) for folded (B*H, S, D) inputs; lse is (B*H, Sq) f32.

    A CUDA tensor goes through the sm_90a kernel (or this raises); a CPU
    tensor goes through the plain blockwise version."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_kernel(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None, block_k: int = 128,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Flash attention (forward) over (b, h, s, d) or (b, s, d) inputs.

    ``impl``: None picks the kernel for CUDA tensors and the plain path for
    CPU tensors; "kernel" forces the kernel (a CPU tensor raises); "plain"
    is the blockwise PyTorch version; "reference" the naive one.
    """
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if impl is None:
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "plain":
        return _flash_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                            block_k=block_k)[0]
    if impl != "kernel":
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    if not q.is_cuda:
        raise ValueError("flash_attention(impl='kernel') needs CUDA tensors, "
                         f"got {q.device}")
    lead = q.shape[:-2]
    fold = lambda t: t.reshape(-1, t.shape[-2], t.shape[-1]).contiguous()
    out, _ = _flash_kernel(fold(q), fold(k), fold(v), causal=causal,
                           sm_scale=sm_scale)
    return out.reshape(*lead, q.shape[-2], q.shape[-1])
