"""The port's flash-attention gradients against ``ray_tpu.ops`` on the same
inputs.

Inputs come from numpy and go through ``jax.grad`` of the JAX function and
through ``torch.autograd`` of the port's, in f32 on both sides. The JAX
Pallas backward runs in interpret mode, as tests/test_ops.py runs it on the
CPU; the port's ``_FlashAttention`` takes its plain forward and backward
here because the tensors lie on the CPU (the sm_90a backward kernels are
held against that plain backward on the card by chip_smoke.py). Every
cotangent is non-uniform: a plain ``.sum()`` hides a wrong
delta = rowsum(dO * O). Tolerances follow tests/test_ops.py: 2e-4 with a
non-uniform cotangent (:165), 1e-4 for cross lengths (:194).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn


def _inputs(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal(shape_k, dtype=np.float32)
    v = rng.standard_normal(shape_k, dtype=np.float32)
    w = rng.standard_normal(shape_q, dtype=np.float32)  # the cotangent
    return q, k, v, w


def _jax_grads(q, k, v, w, **kw):
    def loss(q, k, v):
        return (jattn.flash_attention(q, k, v, **kw) * w).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in
                                            (q, k, v)))
    return [np.asarray(x) for x in g]


def _port_grads(q, k, v, w, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _assert_grads(got, want, tol):
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=tol, rtol=tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_pallas_interpret(causal):
    """tests/test_ops.py:148-165 at (1, 2, 64, 8), Pallas blocks of 16."""
    q, k, v, w = _inputs((1, 2, 64, 8), (1, 2, 64, 8), seed=3)
    want = _jax_grads(q, k, v, w, causal=causal, impl="pallas_interpret",
                      block_q=16, block_k=16)
    _assert_grads(_port_grads(q, k, v, w, causal=causal), want, 2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_cross_lengths_q16_k64(causal):
    q, k, v, w = _inputs((1, 2, 16, 8), (1, 2, 64, 8), seed=4)
    want = _jax_grads(q, k, v, w, causal=causal, impl="pallas_interpret",
                      block_q=16, block_k=16)
    _assert_grads(_port_grads(q, k, v, w, causal=causal), want, 1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [48, 129])
def test_grads_at_ragged_lengths_match_scan(s, causal):
    """The Pallas path asserts divisibility (ray_tpu/ops/attention.py:301),
    so ragged lengths are held against the JAX scan path; the port's plain
    backward splits them into 64-row blocks with a short last block."""
    q, k, v, w = _inputs((1, 2, s, 16), (1, 2, s, 16), seed=s)
    want = _jax_grads(q, k, v, w, causal=causal, impl="scan", block_k=32)
    _assert_grads(_port_grads(q, k, v, w, causal=causal), want, 2e-4)


def test_dead_rows_causal_q64_k16_match_pallas():
    """Causal q_len > k_len: rows 0..47 see no key. Their lse is +inf, P = 0,
    so dq is 0 there and they add nothing to dk/dv, as in the Pallas
    backward. The JAX scan masks with -1e30 and gives those rows mean(V)
    (ROADMAP queue 3, item 5), so the port is held to Pallas here."""
    q, k, v, w = _inputs((1, 2, 64, 8), (1, 2, 16, 8), seed=5)
    want = _jax_grads(q, k, v, w, causal=True, impl="pallas_interpret",
                      block_q=16, block_k=16)
    got = _port_grads(q, k, v, w, causal=True)
    _assert_grads(got, want, 2e-4)
    assert np.all(got[0][..., :48, :] == 0.0)
    assert np.all(np.isfinite(got[1])) and np.all(np.isfinite(got[2]))
    # only the 16 live rows feed dk/dv: zeroing the dead rows' inputs
    # changes nothing
    q2, w2 = q.copy(), w.copy()
    q2[..., :48, :] = 7.0
    w2[..., :48, :] = -3.0
    again = _port_grads(q2, k, v, w2, causal=True)
    np.testing.assert_array_equal(again[1], got[1])
    np.testing.assert_array_equal(again[2], got[2])


@pytest.mark.parametrize("q_len,k_len,causal", [
    (40, 40, True), (40, 40, False), (16, 70, True), (70, 16, False),
])
def test_bwd_plain_matches_autograd_of_reference_f64(q_len, k_len, causal):
    """``_flash_bwd_plain`` (blocks of 16, ragged tails) against
    torch.autograd through the naive ``attention_reference`` in f64. The
    plain version computes in f32 inside, like the kernels, so the whole
    error is its f32 rounding: tolerance 1e-5."""
    q, k, v, w = (torch.from_numpy(a).double() for a in
                  _inputs((3, q_len, 16), (3, k_len, 16), seed=q_len))
    out, lse = tattn._flash_plain(q, k, v, causal=causal, sm_scale=0.25)
    got = tattn._flash_bwd_plain(q, k, v, out, lse, w, causal=causal,
                                 sm_scale=0.25, block_q=16, block_k=16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.attention_reference(*leaves, causal=causal, sm_scale=0.25)
    (ref * w).sum().backward()
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("block_k", [64, 32])
@pytest.mark.parametrize("q_len,k_len,causal,ref", [
    (65, 65, True, "scan"), (127, 127, False, "scan"),
    (100, 130, True, "scan"), (64, 16, True, "pallas"),
    (128, 64, True, "pallas"),
])
def test_bwd_plain_at_kernel_tiles_matches_jax(q_len, k_len, causal, ref,
                                               block_k):
    """``_flash_bwd_plain`` at the kernels' tiles (64 rows, and 64 or 32
    key columns: from D 64 up the dq kernel takes S 32 columns at a time)
    against ``jax.grad`` of the JAX function: ragged and cross lengths where the
    diagonal crosses a tile off its corner against the scan path; causal
    Sq > Sk, whose first rows see no key, against Pallas interpret (the
    scan gives those rows mean(V), ROADMAP queue 3, item 5)."""
    q, k, v, w = _inputs((1, 2, q_len, 16), (1, 2, k_len, 16),
                         seed=q_len + k_len)
    if ref == "pallas":
        want = _jax_grads(q, k, v, w, causal=causal, impl="pallas_interpret",
                          block_q=16, block_k=16)
    else:
        want = _jax_grads(q, k, v, w, causal=causal, impl="scan", block_k=32)
    tq, tk, tv, tw = (torch.from_numpy(a)[0] for a in (q, k, v, w))
    out, lse = tattn._flash_plain(tq, tk, tv, causal=causal,
                                  sm_scale=16 ** -0.5)
    got = tattn._flash_bwd_plain(tq, tk, tv, out, lse, tw, causal=causal,
                                 sm_scale=16 ** -0.5, block_q=64,
                                 block_k=block_k)
    _assert_grads([g.numpy()[None] for g in got], want, 2e-4)


def _shares_of_16_bit_limit(dtype, split, bh=2, s=256, d=32):
    """The tensor-core backward's arithmetic emulated on the CPU for one
    causal square input: S, dP and every sum in f32, P and dS rounded to
    ``dtype`` before their products (one fragment, or hi + lo with
    lo = dtype(x - hi) when ``split``), outputs rounded to ``dtype``. Returns
    each of dq, dk, dv's largest |err| / (atol + rtol |ref|) against the
    plain backward at chip_smoke.py's limits for the dtype."""
    atol, rtol = {torch.bfloat16: (1e-3, 1.6e-2),
                  torch.float16: (1e-3, 2e-3)}[dtype]
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                        dtype=np.float32)
                                    ).to(dtype).float() for _ in range(4))
    scale = d ** -0.5
    out, lse = tattn._flash_plain(q, k, v, causal=True, sm_scale=scale)
    ref = tattn._flash_bwd_plain(q, k, v, out, lse, do, causal=True,
                                 sm_scale=scale)
    live = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.exp(torch.where(live, q @ k.transpose(-1, -2) * scale,
                              -math.inf) - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - tattn._delta(out, do)[..., None])

    def fragments(x):
        hi = x.to(dtype).float()
        return hi + (x - hi).to(dtype).float() if split else hi

    p, ds = fragments(p), fragments(ds)
    got = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
           p.transpose(-1, -2) @ do)
    return [float(((g.to(dtype).float() - r).abs()
                   / (atol + rtol * r.abs())).max()) for g, r in zip(got, ref)]


@pytest.mark.parametrize("dtype,once_breaks_limit", [
    (torch.bfloat16, True), (torch.float16, False)])
def test_hi_lo_fragments_of_p_and_ds_keep_the_16_bit_limits(dtype,
                                                            once_breaks_limit):
    """Why csrc/flash_bwd.cu feeds P and dS to the tensor cores as hi + lo
    fragments: rounded once to bf16, an element whose terms cancel misses
    the bf16 limit; as hi + lo, every output is held to about its own
    rounding (~0.22 of the limit, as with the CUDA-core kernels, whose
    operands are f32)."""
    once = _shares_of_16_bit_limit(dtype, split=False)
    split = _shares_of_16_bit_limit(dtype, split=True)
    assert (max(once) > 1.0) == once_breaks_limit, once
    assert max(split) < 0.3, split


def test_bwd_plain_keeps_input_dtypes_and_delta_in_f32():
    q, k, v, w = (torch.from_numpy(a).to(torch.bfloat16) for a in
                  _inputs((2, 24, 16), (2, 24, 16), seed=8))
    out, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    dq, dk, dv = tattn.flash_attention_bwd(q, k, v, out, lse, w, causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert tattn._delta(out, w).dtype == torch.float32
    ref = tattn._flash_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                 w.float(), causal=True,
                                 sm_scale=16 ** -0.5)
    for g, r in zip((dq, dk, dv), ref):
        # bf16 output rounding: 8 mantissa bits
        torch.testing.assert_close(g.float(), r, atol=2e-2, rtol=2e-2)


def test_grads_flow_back_to_a_strided_layout():
    """The model hands the Function transposed views of c_attn's output; the
    fold makes them contiguous and the grads come back in the caller's
    layout."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 3 * 16),
                                               dtype=np.float32))
    qkv.requires_grad_()
    q, k, v = (t.reshape(2, 32, 2, 8).transpose(1, 2)
               for t in qkv.split(16, dim=-1))
    assert not q.is_contiguous()
    w = torch.from_numpy(rng.standard_normal((2, 2, 32, 8),
                                             dtype=np.float32))
    (tattn.flash_attention(q, k, v, causal=True) * w).sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    q, k, v = (t.reshape(2, 32, 2, 8).transpose(1, 2)
               for t in qkv.split(16, dim=-1))
    (tattn.attention_reference(q, k, v, causal=True) * w).sum().backward()
    torch.testing.assert_close(got, qkv.grad, atol=2e-5, rtol=2e-5)


def test_kernel_impl_with_grad_on_cpu_raises():
    q = torch.zeros(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, q, q, impl="kernel")
    t = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tattn._flash_bwd_dq_kernel(t, t, t, t, lse, lse, causal=True,
                                   sm_scale=0.25)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tattn._flash_bwd_dkv_kernel(t, t, t, t, lse, lse, causal=True,
                                    sm_scale=0.25)


def test_plain_backward_does_not_count_as_launches():
    before = (tattn.flash_fwd_launches, tattn.flash_bwd_dq_launches,
              tattn.flash_bwd_dkv_launches)
    q, k, v, w = _inputs((1, 2, 16, 8), (1, 2, 16, 8), seed=2)
    _port_grads(q, k, v, w, causal=True)
    assert (tattn.flash_fwd_launches, tattn.flash_bwd_dq_launches,
            tattn.flash_bwd_dkv_launches) == before


def test_ptxas_summary_reads_registers_and_spills(tmp_path):
    from ray_tpu_torch.ops import _build

    lib = tmp_path / "flash_bwd-0123.so"
    assert _build.ptxas_summary(lib) == {}
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function "
        "'_Z18flash_bwd_dq_kernelI13__nv_bfloat16Li64EEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z18flash_bwd_dq_kernel\n"
        "    40 bytes stack frame, 40 bytes spill stores, 40 bytes spill "
        "loads\n"
        "ptxas info    : Used 48 registers, used 1 barriers\n")
    assert _build.ptxas_summary(lib) == {
        "flash_bwd_dq_kernel/nv_bfloat16/64": "48 registers, 40 bytes spilled"}


def test_ptxas_summary_reads_the_tensor_core_kernels(tmp_path):
    """The tensor-core instantiations, mangled inside the source's anonymous
    namespace, are listed under their own names beside the CUDA-core ones."""
    from ray_tpu_torch.ops import _build

    lib = tmp_path / "flash_bwd-4567.so"
    entry = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{}"
             "Li{}EEEvPKT_S4_S4_S4_PKfS6_PS2_iiif' for 'sm_90a'\n")
    props = ("ptxas info    : Function properties for x\n"
             "    {0} bytes stack frame, {0} bytes spill stores, {0} bytes "
             "spill loads\nptxas info    : Used {1} registers, used 1 "
             "barriers\n")
    lib.with_suffix(".log").write_text(
        entry.format("23flash_bwd_dq_mma_kernelI13__nv_bfloat16", 64)
        + props.format(0, 163)
        + entry.format("24flash_bwd_dkv_mma_kernelI6__half", 128)
        + props.format(12, 255)
        + entry.format("19flash_bwd_dq_kernelI13__nv_bfloat16", 64)
        + props.format(0, 95))
    assert _build.ptxas_summary(lib) == {
        "flash_bwd_dq_mma_kernel/nv_bfloat16/64": "163 registers, 0 bytes "
                                                  "spilled",
        "flash_bwd_dkv_mma_kernel/half/128": "255 registers, 12 bytes spilled",
        "flash_bwd_dq_kernel/nv_bfloat16/64": "95 registers, 0 bytes spilled"}


def test_bwd_ab_needs_a_card():
    from ray_tpu_torch.tools import bwd_ab

    assert not torch.cuda.is_available()
    assert bwd_ab.main([]) == 2
