"""The port's attention ops against ``ray_tpu.ops`` on the same inputs.

Inputs come from numpy and go through the JAX function and its PyTorch
counterpart, in f32 on both sides. The JAX Pallas kernel runs in interpret
mode, as tests/test_ops.py runs it on the CPU; the port's wrapper takes its
plain blockwise version here because the tensors lie on the CPU (the sm_90a
kernel itself is held against that plain version on the card by
chip_smoke.py). Tolerance: atol = rtol = 2e-5, as tests/test_ops.py uses
for the forward (f32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(shape_q, shape_k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q, dtype=np.float32)
    k = rng.standard_normal(shape_k, dtype=np.float32)
    v = rng.standard_normal(shape_k, dtype=np.float32)
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("layout", ["bhsd", "bsd"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [32, 64])
def test_plain_matches_pallas_interpret(s, causal, layout):
    lead = (2, 3) if layout == "bhsd" else (4,)
    q, k, v = _qkv((*lead, s, 16), (*lead, s, 16), seed=s)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jattn.flash_attention(jq, jk, jv, causal=causal,
                                impl="pallas_interpret", block_q=16,
                                block_k=16)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [48, 129])
def test_plain_matches_scan_at_ragged_lengths(s, causal):
    q, k, v = _qkv((1, 2, s, 16), (1, 2, s, 16), seed=7)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, impl="scan",
                                block_k=32)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_k=32,
                                impl="plain")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_lengths_q16_k64(causal):
    """tests/test_ops.py:168-182: q_len < k_len, decode-style offset."""
    q, k, v = _qkv((1, 2, 16, 8), (1, 2, 64, 8), seed=4)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jattn.flash_attention(jq, jk, jv, causal=causal,
                                impl="pallas_interpret", block_q=16,
                                block_k=16)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(jattn.attention_reference(jq, jk, jv, causal=causal)),
        **TOL)


def test_causal_q64_k16_dead_rows_are_zero():
    """Causal q_len > k_len: rows 0..47 see no column. The port (and the
    kernel) give them 0, like the TPU kernel; the JAX scan and reference
    paths give mean(V) there instead (their -1e30 mask never trips the
    fully-masked guards), which this test pins as a known difference."""
    q, k, v = _qkv((1, 2, 64, 8), (1, 2, 16, 8), seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jattn.flash_attention(jq, jk, jv, causal=True,
                                impl="pallas_interpret", block_q=16,
                                block_k=16)
    out = tattn.flash_attention(tq, tk, tv, causal=True, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.all(out.numpy()[..., :48, :] == 0.0)
    scan = np.asarray(jattn.flash_attention(jq, jk, jv, causal=True,
                                            impl="scan"))
    np.testing.assert_allclose(scan[..., :48, :],
                               np.broadcast_to(v.mean(axis=-2, keepdims=True),
                                               scan[..., :48, :].shape),
                               **TOL)


@pytest.mark.parametrize("q_len,k_len,causal", [
    (32, 32, True), (32, 32, False), (16, 64, True), (64, 16, True),
])
def test_lse_matches_pallas_interpret(q_len, k_len, causal):
    """lse is (B*H, Sq) f32 in the port, the TPU kernel's lane-broadcast
    (B*H, Sq, 128) column 0; rows with no live column are +inf on both."""
    q, k, v = _qkv((4, q_len, 16), (4, k_len, 16), seed=q_len + k_len)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref_out, ref_lse = jattn._flash_pallas(
        jq, jk, jv, causal=causal, sm_scale=0.25, block_q=16, block_k=16,
        interpret=True)
    out, lse = tattn.flash_attention_fwd(tq, tk, tv, causal=causal,
                                         sm_scale=0.25)
    ref_lse = np.asarray(ref_lse)[..., 0]
    assert lse.shape == (4, q_len) and lse.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(ref_lse))
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    if q_len > k_len:
        assert np.isinf(lse.numpy()[:, :q_len - k_len]).all()


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_jax_reference(causal):
    q, k, v = _qkv((2, 2, 24, 16), (2, 2, 40, 16), seed=9)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jattn.attention_reference(jq, jk, jv, causal=causal)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, impl="reference")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_online_block_update_matches_jax():
    """One fold with causal offsets and a padded column range."""
    q, k, v = _qkv((2, 8, 16), (2, 8, 16), seed=11)
    rng = np.random.default_rng(12)
    m = rng.standard_normal((2, 8)).astype(np.float32)
    l = rng.random((2, 8)).astype(np.float32) + 0.5
    acc = rng.standard_normal((2, 8, 16)).astype(np.float32)
    kw = dict(sm_scale=0.25, q_offset=4, k_offset=8, causal=True,
              k_total=13)
    jres = jattn.online_block_update(*(jnp.asarray(a) for a in
                                       (q, k, v, m, l, acc)), **kw)
    tres = tattn.online_block_update(*(torch.from_numpy(a) for a in
                                       (q, k, v, m, l, acc)), **kw)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    jo = jattn.finalize_flash(*jres, jnp.float32)
    to = tattn.finalize_flash(*tres, torch.float32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_kernel_impl_on_cpu_tensor_raises():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="not a CUDA device"):
        tattn._flash_kernel(q[0], q[0], q[0], causal=True, sm_scale=0.25)
    with pytest.raises(ValueError, match="unknown"):
        tattn.flash_attention(q, q, q, impl="pallas")


def test_plain_calls_do_not_count_as_launches():
    before = tattn.flash_fwd_launches
    q = torch.zeros(2, 8, 16)
    tattn.flash_attention_fwd(q, q, q, causal=True)
    assert tattn.flash_fwd_launches == before
