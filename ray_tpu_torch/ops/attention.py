"""Attention ops: flash attention forward and backward as hand-written Hopper
kernels, with their plain PyTorch versions beside them.

PyTorch counterpart of ``ray_tpu/ops/attention.py``:

- ``attention_reference``: naive full-matrix attention for numerics tests.
- ``online_block_update`` / ``finalize_flash``: the online-softmax fold, and
  ``_flash_plain`` built from them, the blockwise version the CPU path runs
  and the kernel is held against.
- ``flash_attention_fwd``: (out, lse) on folded (B*H, S, D) tensors. On a
  CUDA tensor it launches ``csrc/flash_fwd.cu`` (the port of the TPU
  ``_fwd_kernel``: a tensor-core kernel for f16 and bf16, a CUDA-core kernel
  for f32) or raises; on a CPU tensor it runs ``_flash_plain``.
- ``_flash_bwd_plain`` (``_bwd_dq_plain`` + ``_bwd_dkv_plain``): the
  blockwise backward, f32 inside, the plain version of the two backward
  kernels. ``flash_attention_bwd``: (dq, dk, dv) on folded tensors; on a
  CUDA tensor it launches ``csrc/flash_bwd.cu`` (the ports of the TPU
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``: tensor-core kernels for f16
  and bf16, CUDA-core kernels for f32) or raises; on a CPU tensor it runs
  ``_flash_bwd_plain``.
- ``flash_attention_bwd_from_stats``: the same grads from a given lse and
  delta (ring attention's blocks, ``ops/ring_attention.py``).
- ``_FlashAttention``: the ``torch.autograd.Function`` tying the two, the
  counterpart of the JAX package's ``_flash_pallas_diff``.
- ``flash_attention``: (b, h, s, d) or (b, s, d), differentiable.

Masking: the causal mask is bottom-right aligned (query i sees key j when
``i + (k_len - q_len) >= j``). Rows with no live column give out = 0 and
lse = +inf on every path but ``attention_reference``.

Live key length: the forward paths take an optional ``k_len``, a 0-d int32
tensor on q's device, clamped to [0, Sk]. Keys ``j >= k_len`` are dead and
``k_len`` takes Sk's place in the causal alignment, so a decode step can hand
the kernel a whole static cache of Sk rows whose first ``k_len`` are filled.
The kernel reads it on the device; no path reads it on the host. It has no
backward (the reference has none): ``flash_attention`` raises if a gradient
is needed.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
_BWD_SOURCE = _SOURCE.with_name("flash_bwd.cu")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HEAD_DIMS = (16, 32, 64, 128)

# launches of each CUDA kernel in this process (plain-version calls not
# counted)
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def zero_launches() -> None:
    """Set every kernel's launch count in this process to 0."""
    global flash_fwd_launches, flash_bwd_dq_launches, flash_bwd_dkv_launches
    flash_fwd_launches = flash_bwd_dq_launches = flash_bwd_dkv_launches = 0


def read_launches() -> Dict[str, int]:
    """{kernel: launches in this process since the last ``zero_launches``}."""
    return {"flash_fwd": flash_fwd_launches,
            "flash_bwd_dq": flash_bwd_dq_launches,
            "flash_bwd_dkv": flash_bwd_dkv_launches}


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
                 block_k: int = 128, k_len: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online softmax over (..., s, d): (out, lse), f32 inside.
    The plain version of the kernel, and the CPU path. ``k_len`` (a 0-d
    tensor) masks the keys past it as tensor ops, without reading it on the
    host."""
    *lead, q_len, d = q.shape
    if k_len is None:
        k_len = k.shape[-2]
    else:
        k_len = k_len.clamp(0, k.shape[-2])
    block_k = min(block_k, k.shape[-2])
    m = torch.full((*lead, q_len), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((*lead, q_len), dtype=torch.float32, device=q.device)
    acc = torch.zeros((*lead, q_len, d), dtype=torch.float32, device=q.device)
    live_tail = isinstance(k_len, torch.Tensor)
    for k0 in range(0, k.shape[-2], block_k):
        m, l, acc = online_block_update(
            q, k[..., k0:k0 + block_k, :], v[..., k0:k0 + block_k, :],
            m, l, acc, sm_scale=sm_scale, q_offset=k_len - q_len,
            k_offset=k0, causal=causal,
            k_total=k_len if live_tail or k0 + block_k > k_len else None)
    lse = torch.where(l == 0.0, math.inf,
                      torch.where(torch.isfinite(m), m, 0.0)
                      + torch.log(torch.where(l == 0.0, 1.0, l)))
    return finalize_flash(m, l, acc, q.dtype), lse


def _bwd_block(q, k, v, do, lse, delta, *, sm_scale: float, q0: int,
               k0: int, offset: int, causal: bool):
    """P and dS of one (q-block, k-block) pair, f32: P recomputed from lse
    (a row with lse = +inf gets P = 0), dS = P * (dO V^T - delta)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * sm_scale
    if causal:
        qi = torch.arange(s.shape[-2], device=s.device)[:, None] + q0
        ki = torch.arange(s.shape[-1], device=s.device)[None, :] + k0
        s = torch.where(qi + offset >= ki, s, -math.inf)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def _bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
                  block_q: int, block_k: int) -> torch.Tensor:
    """dq = scale * sum_k dS K, q-block by q-block with the kernel's causal
    skip of k-blocks no row of the q-block sees."""
    q_len, k_len = q.shape[-2], k.shape[-2]
    offset = k_len - q_len
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, q_len, block_q):
        q1 = min(q0 + block_q, q_len)
        k_end = min(k_len, q1 + offset) if causal else k_len
        for k0 in range(0, max(k_end, 0), block_k):
            k1 = k0 + block_k
            _, ds = _bwd_block(
                q[..., q0:q1, :], k[..., k0:k1, :], v[..., k0:k1, :],
                do[..., q0:q1, :], lse[..., q0:q1], delta[..., q0:q1],
                sm_scale=sm_scale, q0=q0, k0=k0, offset=offset, causal=causal)
            dq[..., q0:q1, :] += torch.einsum("...qk,...kd->...qd", ds,
                                              k[..., k0:k1, :].float())
    return (dq * sm_scale).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool, sm_scale: float,
                   block_q: int, block_k: int):
    """dv = sum_q P^T dO and dk = scale * sum_q dS^T Q, k-block by k-block,
    starting at the first q-block with a row that sees the k-block."""
    q_len, k_len = q.shape[-2], k.shape[-2]
    offset = k_len - q_len
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for k0 in range(0, k_len, block_k):
        k1 = min(k0 + block_k, k_len)
        q_beg = max(0, k0 - offset) // block_q * block_q if causal else 0
        for q0 in range(q_beg, q_len, block_q):
            q1 = q0 + block_q
            p, ds = _bwd_block(
                q[..., q0:q1, :], k[..., k0:k1, :], v[..., k0:k1, :],
                do[..., q0:q1, :], lse[..., q0:q1], delta[..., q0:q1],
                sm_scale=sm_scale, q0=q0, k0=k0, offset=offset, causal=causal)
            dv[..., k0:k1, :] += torch.einsum("...qk,...qd->...kd", p,
                                              do[..., q0:q1, :].float())
            dk[..., k0:k1, :] += torch.einsum("...qk,...qd->...kd", ds,
                                              q[..., q0:q1, :].float())
    return (dk * sm_scale).to(k.dtype), dv.to(v.dtype)


def _delta(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, as the JAX package computes it
    outside its kernels."""
    return (do.float() * out.float()).sum(dim=-1)


def _flash_bwd_plain(q, k, v, out, lse, do, *, causal: bool, sm_scale: float,
                     block_q: int = 64, block_k: int = 64):
    """(dq, dk, dv) of flash attention over (..., s, d), blockwise, f32
    inside, outputs in the inputs' dtypes. The plain version of the two
    backward kernels, and the CPU path; blocks default to the kernels'
    64-row tiles."""
    delta = _delta(out, do)
    kw = dict(causal=causal, sm_scale=sm_scale, block_q=block_q,
              block_k=block_k)
    dq = _bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = _bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _load_kernel() -> ctypes.CDLL:
    """The kernel's library, built by nvcc at the first call."""
    global _lib
    if _lib is None:
        from ray_tpu_torch.ops import _build

        lib = _build.load(_SOURCE)
        lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_tensor_cores.argtypes = [ctypes.c_int]
        lib.flash_fwd_tensor_cores.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bwd_kernel() -> ctypes.CDLL:
    """The backward kernels' library, built by nvcc at the first call."""
    global _bwd_lib
    if _bwd_lib is None:
        from ray_tpu_torch.ops import _build

        lib = _build.load(_BWD_SOURCE)
        lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_dq.restype = lib.flash_bwd_dkv.restype = ctypes.c_int
        lib.flash_bwd_tensor_cores.argtypes = [ctypes.c_int]
        lib.flash_bwd_tensor_cores.restype = ctypes.c_int
        lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def fwd_design(dtype: torch.dtype) -> str:
    """The design the loaded forward library runs for ``dtype``:
    "mma.sync" (tensor cores) or "cuda-core f32". Builds it if need be."""
    lib = _load_kernel()
    return ("mma.sync" if lib.flash_fwd_tensor_cores(_DTYPE_CODES[dtype])
            else "cuda-core f32")


def bwd_design(dtype: torch.dtype) -> str:
    """The design the loaded backward library runs for ``dtype``:
    "mma.sync" (tensor cores) or "cuda-core f32". Builds it if need be."""
    lib = _load_bwd_kernel()
    return ("mma.sync" if lib.flash_bwd_tensor_cores(_DTYPE_CODES[dtype])
            else "cuda-core f32")


def _check_kernel_inputs(q, k, v, kernel: str = "flash_fwd"):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.dim() != 3:
            raise ValueError(f"{kernel} kernel: {name} must be (B*H, S, D), "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{kernel} kernel: q, k, v must share one dtype "
                             "and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{kernel} kernel: unsupported dtype {q.dtype}")
    bh, q_len, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head dim {d} not in {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{kernel} kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if bh < 1 or q_len < 1 or k.shape[1] < 1:
        raise ValueError(f"{kernel} kernel: empty input")


def _check_aligned(kernel, **tensors):
    """In f16 and bf16 the tensor-core kernels copy 16-byte rows, so their
    inputs must start on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.dtype != torch.float32 and t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} must start on a "
                             "16-byte boundary")


def _check_bwd_inputs(kernel, q, k, v, do, lse, delta):
    """q, k, v as the forward takes them; dO like q; lse and delta
    (B*H, Sq) f32; all contiguous on q's device; q, k, v and dO 16-byte
    aligned in f16 and bf16."""
    _check_kernel_inputs(q, k, v, kernel)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{kernel} kernel: dO {tuple(do.shape)} {do.dtype} "
                         f"is not like q {tuple(q.shape)} {q.dtype}")
    _check_aligned(kernel, q=q, k=k, v=v, dO=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{kernel} kernel: {name} must be (B*H, Sq) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("dO", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous "
                             f"on {q.device}")


def _check_k_len(k_len, q):
    if k_len is None:
        return
    if (not isinstance(k_len, torch.Tensor) or k_len.dim() != 0
            or k_len.dtype != torch.int32 or k_len.device != q.device):
        raise ValueError("k_len must be a 0-d int32 tensor on q's device "
                         f"({q.device})")


def _flash_kernel(q, k, v, *, causal: bool, sm_scale: float,
                  k_len: Optional[torch.Tensor] = None):
    global flash_fwd_launches
    _check_kernel_inputs(q, k, v)
    _check_aligned("flash_fwd", q=q, k=k, v=v)
    _check_k_len(k_len, q)
    lib = _load_kernel()
    bh, q_len, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, q_len), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), bh, q_len,
                            k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
                            float(sm_scale),
                            None if k_len is None else k_len.data_ptr(),
                            stream)
    if err != 0:
        raise RuntimeError("flash_fwd kernel launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    flash_fwd_launches += 1
    return out, lse


def _bwd_launch(kernel: str, q, k, v, do, lse, delta, grads, *,
                causal: bool, sm_scale: float):
    """One backward kernel's launch on PyTorch's current stream; raises on a
    nonzero return."""
    _check_bwd_inputs(kernel, q, k, v, do, lse, delta)
    lib = _load_bwd_kernel()
    bh, q_len, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, kernel)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            bh, q_len, k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
            float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           + lib.flash_bwd_error_string(err).decode())


def _flash_bwd_dq_kernel(q, k, v, do, lse, delta, *, causal: bool,
                         sm_scale: float) -> torch.Tensor:
    global flash_bwd_dq_launches
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                causal=causal, sm_scale=sm_scale)
    flash_bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *, causal: bool,
                          sm_scale: float):
    global flash_bwd_dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv),
                causal=causal, sm_scale=sm_scale)
    flash_bwd_dkv_launches += 1
    return dk, dv


def _flash_bwd_kernel(q, k, v, out, lse, do, *, causal: bool,
                      sm_scale: float):
    """(dq, dk, dv) from the two sm_90a backward kernels; delta is one
    PyTorch reduction before them."""
    delta = _delta(out, do)
    kw = dict(causal=causal, sm_scale=sm_scale)
    dq = _flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        k_len: Optional[torch.Tensor] = None):
    """(out, lse) for folded (B*H, S, D) inputs; lse is (B*H, Sq) f32.
    ``k_len``: the live key length (see the module's note), or None.

    A CUDA tensor goes through the sm_90a kernel (or this raises); a CPU
    tensor goes through the plain blockwise version."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_kernel(q, k, v, causal=causal, sm_scale=sm_scale,
                             k_len=k_len)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                            k_len=k_len)
    raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """(dq, dk, dv) for folded (B*H, S, D) inputs, given the forward's out
    and lse and the cotangent dO, each grad in its input's dtype.

    CUDA tensors go through the two sm_90a kernels (or this raises); CPU
    tensors go through the plain blockwise version."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_bwd_kernel(q, k, v, out, lse, do, causal=causal,
                                 sm_scale=sm_scale)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                sm_scale=sm_scale)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


def flash_attention_bwd_from_stats(q, k, v, do, lse, delta,
                                   causal: bool = False,
                                   sm_scale: Optional[float] = None):
    """(dq, dk, dv) of folded (B*H, S, D) inputs from given row statistics:
    ``lse`` and ``delta`` (B*H, Sq) f32, which may be those of a larger
    attention that this (q, k/v) block pair is one part of (ring
    attention's global lse, and delta from its final output): P is
    recomputed as exp(s - lse), so each block's grads are its exact share.
    Each grad in its input's dtype.

    CUDA tensors go through the two sm_90a kernels (or this raises); CPU
    tensors go through their plain blockwise versions."""
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    kw = dict(causal=causal, sm_scale=sm_scale)
    if q.is_cuda:
        dq = _flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
        dk, dv = _flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv
    if q.device.type == "cpu":
        kw.update(block_q=64, block_k=64)
        dq = _bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        dk, dv = _bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv
    raise ValueError(f"flash_attention_bwd_from_stats: unsupported device "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """Flash attention on folded (B*H, S, D) tensors with the flash
    backward: the forward saves q, k, v, out and lse; the backward
    recomputes P blockwise from lse, so no attention matrix is kept. The
    counterpart of the JAX package's ``_flash_pallas_diff``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, k_len=None):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale, k_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None, block_k: int = 128,
                    impl: Optional[str] = None,
                    k_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable flash attention over (b, h, s, d) or (b, s, d) inputs.

    ``impl``: None runs ``_FlashAttention`` (the forward and backward
    kernels on CUDA tensors, their plain versions on CPU tensors);
    "kernel" is the same but a CPU tensor raises; "plain" is the blockwise
    PyTorch forward (k-blocks of ``block_k``) with autograd through its
    ops; "reference" the naive version. ``k_len``: the live key length (a
    0-d int32 tensor, see the module's note), forward only; "reference"
    does not take it.
    """
    sm_scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if impl == "reference":
        if k_len is not None:
            raise ValueError("flash_attention(impl='reference') takes no "
                             "k_len")
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl == "plain":
        return _flash_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                            block_k=block_k, k_len=k_len)[0]
    if impl not in (None, "kernel"):
        raise ValueError(f"unknown flash_attention impl {impl!r}")
    if impl == "kernel" and not q.is_cuda:
        raise ValueError("flash_attention(impl='kernel') needs CUDA tensors, "
                         f"got {q.device}")
    # folded contiguous for the kernels; autograd carries the grads back to
    # the caller's layout through the reshapes
    if k_len is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise ValueError("flash attention with k_len has no backward: run "
                         "it without gradients (torch.inference_mode)")
    fold = lambda t: t.reshape(-1, t.shape[-2], t.shape[-1]).contiguous()
    out = _FlashAttention.apply(fold(q), fold(k), fold(v), causal, sm_scale,
                                k_len)
    return out.reshape(q.shape)
