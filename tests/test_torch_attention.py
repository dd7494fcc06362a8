"""The port's attention ops against ``ray_tpu.ops`` on the same inputs.

Inputs come from numpy and go through the JAX function and its PyTorch
counterpart, in f32 on both sides. The JAX Pallas kernel runs in interpret
mode, as tests/test_ops.py runs it on the CPU; the port's wrapper takes its
plain blockwise version here because the tensors lie on the CPU (the sm_90a
kernel itself is held against that plain version on the card by
chip_smoke.py). Tolerance: atol = rtol = 2e-5, as tests/test_ops.py uses
for the forward (f32 sums taken in another order).
"""

import math

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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq", [1, 5])
def test_plain_k_len_equals_the_live_slice(sq, causal):
    """The forward's plain version (the CPU path) with a live length
    ``k_len`` (a 0-d int32 tensor) over a static cache of 40 rows equals it
    on the live slice ``[:k_len]``, whatever the rows past it hold: at
    k_len 1 (with Sq 5 and the causal mask, rows 0..3 see no key: out 0,
    lse +inf), 9, 33 and 40."""
    rng = np.random.default_rng(20 + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, s, 16),
                                                    dtype=np.float32))
               for s in (sq, 40, 40))
    for k_len in (1, 9, 33, 40):
        tail_k, tail_v = k.clone(), v.clone()
        tail_k[:, k_len:] *= 1e4
        tail_v[:, k_len:] *= 1e4
        out, lse = tattn.flash_attention_fwd(
            q, tail_k, tail_v, causal,
            k_len=torch.tensor(k_len, dtype=torch.int32))
        ref, ref_lse = tattn.flash_attention_fwd(q, k[:, :k_len],
                                                 v[:, :k_len], causal)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6,
                                   rtol=1e-6)
        assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
        live = torch.isfinite(ref_lse)
        np.testing.assert_allclose(lse[live].numpy(), ref_lse[live].numpy(),
                                   atol=1e-6, rtol=1e-6)
        assert not out[~live].any()


def test_k_len_has_no_backward():
    """The reference has no backward for a live length: given ``k_len``,
    flash attention raises if a gradient is needed, and runs without
    one."""
    q, k, v = (torch.randn(2, 3, s, 16, requires_grad=True)
               for s in (1, 12, 12))
    k_len = torch.tensor(7, dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        tattn.flash_attention(q, k, v, causal=True, k_len=k_len)
    with torch.inference_mode():
        out = tattn.flash_attention(q, k, v, causal=True, k_len=k_len)
    assert out.shape == q.shape
    with torch.no_grad():
        plain = tattn.flash_attention(q, k, v, causal=True, k_len=k_len,
                                      impl="plain")
    assert torch.equal(out, plain)
    with pytest.raises(ValueError, match="k_len"):
        tattn.flash_attention(q, k, v, k_len=k_len, impl="reference")


def test_ptxas_summary_keys_the_live_length_builds(tmp_path):
    """``flash_fwd.cu`` builds each forward kernel with and without a live
    length (template flag ``LIVE``): the two builds get their own keys, so
    the build phase reports the registers and spills of both."""
    from ray_tpu_torch.ops import _build

    lib = tmp_path / "flash_fwd-89ab.so"
    entry = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
             "20flash_fwd_mma_kernelI13__nv_bfloat16Li128ELb{}EEEvPKT_' for "
             "'sm_90a'\n")
    props = ("ptxas info    : Function properties for x\n"
             "    {0} bytes stack frame, {0} bytes spill stores, {0} bytes "
             "spill loads\nptxas info    : Used {1} registers, used 1 "
             "barriers\n")
    lib.with_suffix(".log").write_text(entry.format(0) + props.format(0, 173)
                                       + entry.format(1) + props.format(8, 168))
    assert _build.ptxas_summary(lib) == {
        "flash_fwd_mma_kernel/nv_bfloat16/128": "173 registers, 0 bytes "
                                                "spilled",
        "flash_fwd_mma_kernel/nv_bfloat16/128/k_len": "168 registers, 8 bytes "
                                                      "spilled"}


def _fwd_share_of_16_bit_limit(dtype, split, bh=4, s=256, d=64):
    """The tensor-core forward's arithmetic emulated on the CPU for one
    causal square input: S in f32 on the kernel's 64-column k-tiles with the
    running max, P = exp(S - m) in f32 and l summed from it, P rounded to
    ``dtype`` before P V (one fragment, or hi + lo with lo = dtype(p - hi)
    when ``split``), the f32 accumulator rescaled per tile, the output
    rounded once to ``dtype``. Returns the output's largest
    |err| / (atol + rtol |ref|) against the plain forward at chip_smoke.py's
    limits for the dtype."""
    atol, rtol = {torch.bfloat16: (1e-3, 1.6e-2),
                  torch.float16: (1e-3, 2e-3)}[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                    dtype=np.float32)
                                ).to(dtype).float() for _ in range(3))
    scale = d ** -0.5
    ref, _ = tattn._flash_plain(q, k, v, causal=True, sm_scale=scale)
    live = torch.ones(s, s, dtype=torch.bool).tril()
    scores = torch.where(live, q @ k.transpose(-1, -2) * scale, -math.inf)
    m = torch.full((bh, s), -math.inf)
    l, acc = torch.zeros(bh, s), torch.zeros(bh, s, d)
    for k0 in range(0, s, 64):
        # every row sees key 0, so m is finite from the first tile on
        m_new = torch.maximum(m, scores[..., k0:k0 + 64].amax(dim=-1))
        p = torch.exp(scores[..., k0:k0 + 64] - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(dtype).float()
        p = hi + (p - hi).to(dtype).float() if split else hi
        acc = acc * alpha[..., None] + p @ v[..., k0:k0 + 64, :]
        m = m_new
    out = (acc / l[..., None]).to(dtype).float()
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


@pytest.mark.parametrize("dtype,split,breaks_limit", [
    (torch.bfloat16, False, True), (torch.bfloat16, True, False),
    (torch.float16, False, False)])
def test_fwd_p_rounding_keeps_the_16_bit_limits(dtype, split, breaks_limit):
    """Why csrc/flash_fwd.cu feeds bf16 P to P V as hi + lo fragments and
    f16 P as one: rounded once to bf16 (8 bits), P misses the bf16 limit on
    a causal input; as hi + lo, and in f16 rounded once (11 bits), the output
    is held to about its own rounding (~0.2 of the limit)."""
    share = _fwd_share_of_16_bit_limit(dtype, split)
    assert (share > 1.0) == breaks_limit, share
    if not breaks_limit:
        assert share < 0.3, share


def test_zero_and_read_launches_cover_every_kernel(monkeypatch):
    """The launch counters the smoke script and the tools read: one per
    kernel of ``KERNELS``, read and zeroed together."""
    from ray_tpu_torch.ops import attention as attn

    for i, name in enumerate(attn.KERNELS):
        monkeypatch.setattr(attn, f"{name}_launches", i + 1)
    assert attn.read_launches() == {"flash_fwd": 1, "flash_bwd_dq": 2,
                                    "flash_bwd_dkv": 3}
    attn.zero_launches()
    assert attn.read_launches() == dict.fromkeys(attn.KERNELS, 0)


def test_library_path_follows_the_included_headers(tmp_path):
    """A shared header's edit must rebuild every source that includes it:
    the library's name hashes the headers beside the source too."""
    from ray_tpu_torch.ops import _build

    src, header = tmp_path / "kernel.cu", tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// one\n")
    first = _build.library_path(src)
    assert _build.library_path(src) == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("kernel-")
    header.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.CSRC in _build._include_dirs(src)


def test_16_bit_kernel_inputs_must_be_16_byte_aligned():
    """The tensor-core kernels copy 16-byte rows: an f16 or bf16 input that
    starts off a 16-byte boundary raises; f32 (the CUDA-core kernels) does
    not care."""
    for dtype in (torch.float16, torch.bfloat16):
        t = torch.zeros(40, dtype=dtype)
        tattn._check_aligned("flash_fwd", q=t[:16])
        with pytest.raises(ValueError, match="k must start on a 16-byte"):
            tattn._check_aligned("flash_fwd", q=t[:16], k=t[1:17])
    tattn._check_aligned("flash_fwd", q=torch.zeros(40)[1:17])


def test_fwd_ab_needs_a_card():
    from ray_tpu_torch.tools import fwd_ab

    assert not torch.cuda.is_available()
    assert fwd_ab.main([]) == 2


def test_live_ab_needs_a_card_and_finds_its_variant_in_the_source():
    """``tools/live_ab.py`` builds a copy of ``flash_fwd.cu`` with the
    shared-memory read of ``k_len`` swapped for a read by every thread: the
    text it swaps must be in the source."""
    from ray_tpu_torch.tools import live_ab

    assert live_ab.SHARED in tattn._SOURCE.read_text()
    assert not torch.cuda.is_available()
    assert live_ab.main([]) == 2


def test_train_runs_plain_attention_and_grad_errors():
    """The helpers chip_smoke.py and fwd_ab.py share: ``plain_attention``
    routes the model's flash calls to impl="plain" and puts the kernel path
    back even when its body raises; ``grad_rel_errs`` gives the worst and
    the median leaf's relative error norm."""
    import ray_tpu_torch.ops as ops
    from ray_tpu_torch.tools import train_runs

    kernel_path = ops.flash_attention
    with pytest.raises(RuntimeError, match="inside"):
        with train_runs.plain_attention():
            assert ops.flash_attention.keywords == {"impl": "plain"}
            assert ops.flash_attention.func is kernel_path
            raise RuntimeError("inside")
    assert ops.flash_attention is kernel_path

    want = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0]),
            "c": torch.tensor([0.0, 2.0])}
    got = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.0, 0.0]),
           "c": torch.tensor([0.0, 2.1])}
    errs = train_runs.grad_rel_errs(got, want)
    assert errs["worst_leaf"] == "a"
    assert errs["worst"] == pytest.approx(0.1)
    assert errs["median"] == pytest.approx(0.05)
