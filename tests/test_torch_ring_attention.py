"""The port's ring attention and sequence-parallel GPT-2 step against
``ray_tpu``'s, over gloo on the CPU.

``tests/torch_model_parallel_ranks.py`` runs as 4 and as 2 gloo processes
(``tests/torch_ranks.py``: torch only, ``.npz`` in and out, a free port,
both worlds in the background while this process computes the JAX side on
the 8 virtual CPU devices of ``tests/conftest.py``).

- ``ring_self_attention`` at sp 2 and 4, causal and not, against the
  reference's on a mesh of the same size, on the same numpy q, k, v (f32):
  the output within 2e-5, and the gradients of sum(out * w) within 1e-4
  (``tests/test_ops.py``'s limits for the reference's own ring); each rank's
  gradient is its own chunk's and 0 outside it, as under ``shard_map``. The
  port's blocks run the flash kernels' plain versions (CPU tensors), the
  reference's its jnp fold.
- The GPT-2 sequence-parallel step (``attention="ring"``,
  ``build_train_step_sp``) at {"data": 2, "sp": 2} against the reference's
  on the same global batch and bridged weights, 3 AdamW steps: losses and
  parameters within 1e-4, the key part of each ``c_attn`` bias within 2 lr
  a step (``tests/test_torch_parallel.py``'s exception: its true gradient
  is 0 and Adam turns rounding noise into +-lr).
- In this process: ``tools/ring_runs.ring_fwd_bwd``, the composition of the
  ring's block step and merge that ``chip_smoke.py`` phase 26 runs on the
  card, against whole-sequence flash (in f32 within 1e-5; in bf16, through
  the kernels' plain versions, within the ring's stated limit,
  ``ring_attention.TOL_REASON``) with the
  blocks that launch counted; the block modes; and the ring refusing to
  run unbound.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import ring_self_attention as jring
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops.ring_attention import block_mode, merge_blocks
from ray_tpu_torch.tools import ring_runs
from tests.torch_ranks import Worlds

LR, STEPS, GB, T = 3e-4, 3, 4, 32
CAUSAL = [True, False]


def _ring_inputs(world):
    rng = np.random.default_rng(10 + world)
    shape = (1, 2, 8 * world, 16)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("q", "k", "v", "w")}


def _global_batch():
    ids = np.random.default_rng(3).integers(0, 512, size=(GB, T + 1),
                                            dtype=np.int64)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_weights():
    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32, attention="ring")
    return jgpt2.init_params(cfg, jax.random.PRNGKey(0))[1]


def _to_torch(tree):
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _ring_case(world, causal):
    return {"kind": "ring", "name": f"ring_{int(causal)}",
            "axes": {"sp": world}, "causal": causal}


SP_CASE = {"kind": "gpt2_sp", "name": "gpt2_sp",
           "axes": {"data": 2, "sp": 2}, "model": {}, "steps": STEPS}


def _arrays(world):
    out = {}
    for causal in CAUSAL:
        name = _ring_case(world, causal)["name"]
        out.update({f"{name}/{k}": v
                    for k, v in _ring_inputs(world).items()})
    if world == 4:
        out.update({f"gpt2_sp/batch/{k}": v
                    for k, v in _global_batch().items()})
        out.update({f"gpt2_sp/w/{k}": v
                    for k, v in _to_torch(_jax_weights()).items()})
    return out


@pytest.fixture(scope="module")
def worlds():
    cases = {4: [_ring_case(4, c) for c in CAUSAL] + [SP_CASE],
             2: [_ring_case(2, c) for c in CAUSAL]}
    with tempfile.TemporaryDirectory() as tmp:
        w = Worlds(tmp, cases, {n: _arrays(n) for n in cases})
        try:
            yield w
        finally:
            w.close()


@functools.lru_cache(maxsize=None)
def _jax_ring(world, causal):
    x = {k: jnp.asarray(v) for k, v in _ring_inputs(world).items()}
    mesh = jpar.create_mesh({"sp": world}, devices=jax.devices()[:world])

    def loss(q, k, v):
        out = jring(q, k, v, mesh, seq_axis="sp", causal=causal)
        return (out * x["w"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("world", [2, 4])
def test_ring_forward_matches_jax(worlds, world, causal):
    want, _ = _jax_ring(world, causal)
    for res in worlds.result(world, f"ring_{int(causal)}"):
        np.testing.assert_allclose(res["out"], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("world", [2, 4])
def test_ring_grads_match_jax(worlds, world, causal):
    _, grads = _jax_ring(world, causal)
    s = grads[0].shape[-2] // world
    for r, res in enumerate(worlds.result(world, f"ring_{int(causal)}")):
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(res[name],
                                       g[..., r * s:(r + 1) * s, :],
                                       atol=1e-4, rtol=1e-4, err_msg=name)
            assert res[f"{name}_outside"] == 0.0


@functools.lru_cache(maxsize=None)
def _jax_sp_run():
    cfg = jgpt2.GPT2Config.small_test(attention="ring", dtype=jnp.float32)
    model, params, tx, opt_state = jgpt2.make_train_state(
        cfg, jax.random.PRNGKey(0))
    mesh = jpar.create_mesh({"data": 2, "sp": 2},
                            devices=jax.devices()[:4])
    step = jgpt2.build_train_step_sp(model, tx, mesh, donate=False)
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in _global_batch().items()}
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return np.asarray(losses), _to_torch(params)


def assert_params(got, want, atol=1e-4, steps=STEPS, prefix="p/"):
    """Each parameter within ``atol``, the key part of a ``c_attn`` bias
    within 2 lr a step (see the module's note)."""
    for name, w in want.items():
        g = got[prefix + name]
        if name.endswith("attn.c_attn.bias"):
            c = w.shape[0] // 3
            np.testing.assert_allclose(g[c:2 * c], w[c:2 * c], rtol=0,
                                       atol=2 * LR * steps, err_msg=name)
            g = np.concatenate([g[:c], g[2 * c:]])
            w = np.concatenate([w[:c], w[2 * c:]])
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_gpt2_sp_step_matches_jax_at_data_2_sp_2(worlds):
    losses, params = _jax_sp_run()
    start = _to_torch(_jax_weights())
    for res in worlds.result(4, "gpt2_sp"):
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=1e-4)
        assert_params(res, params)
        moved = max(np.abs(res[f"p/{k}"] - v).max() for k, v in start.items())
        assert moved > STEPS * LR / 2


def test_gpt2_sp_first_loss_is_the_single_device_loss(worlds):
    """The reference's ``test_gpt2_sequence_parallel_step``: the SP loss
    equals the plain model's on the global batch (the port's at 2e-4)."""
    model = tgpt2.init_params(tgpt2.GPT2Config.small_test(
        dtype=torch.float32), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _to_torch(_jax_weights()).items()})
    with torch.no_grad():
        want = float(tgpt2.loss_fn(model, {
            k: torch.from_numpy(v) for k, v in _global_batch().items()}))
    for res in worlds.result(4, "gpt2_sp"):
        np.testing.assert_allclose(res["losses"][0], want, rtol=2e-4,
                                   atol=2e-4)
        assert res["losses"][1] < res["losses"][0]


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def _folded(seed, bh=6, s=64, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((bh, s, d), generator=g).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_composed_ring_matches_whole_sequence_flash_f32(n, causal):
    q, k, v, do = _folded(n)
    out, dq, dk, dv = ring_runs.ring_fwd_bwd(q, k, v, do, n, causal)
    scale = q.shape[-1] ** -0.5
    ref, lse = tattn._flash_plain(q, k, v, causal=causal, sm_scale=scale)
    grads = tattn._flash_bwd_plain(q, k, v, ref, lse, do, causal=causal,
                                   sm_scale=scale)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the plain ring is the same function through the same composition
    plain = ring_runs.ring_fwd_bwd(q, k, v, do, n, causal, plain=True)
    for got, want in zip(plain, (out, dq, dk, dv)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("causal", CAUSAL)
def test_composed_ring_in_bf16_within_its_stated_limit(causal):
    """bf16 through the kernels' plain versions (which round their outputs
    as the kernels do), against whole-sequence flash: within the bf16
    ``TOLS`` element by element, their rtol taken of |flash| + the
    partials' magnitudes (``ring_attention.TOL_REASON``), the backward
    against flash's fed the ring's output, and against flash's from its own
    output with the limit's delta terms added to dq and dk. Plain bf16
    ``TOLS`` alone do not hold the causal grads, whose partials cancel."""
    n = 4
    q, k, v, do = _folded(7, bh=4, s=256, d=64, dtype=torch.bfloat16)
    got, scales = ring_runs.ring_fwd_bwd(q, k, v, do, n, causal,
                                         with_scales=True)
    scale = q.shape[-1] ** -0.5
    ref, lse = tattn._flash_plain(q, k, v, causal=causal, sm_scale=scale)
    # the backward at the ring's own delta (flash's fed the ring's out)
    want = (ref, *tattn._flash_bwd_plain(q, k, v, got[0], lse, do,
                                         causal=causal, sm_scale=scale))
    own = (ref, *tattn._flash_bwd_plain(q, k, v, ref, lse, do,
                                        causal=causal, sm_scale=scale))
    limits = [1e-3 + 1.6e-2 * (w.float().abs() + sc)
              for w, sc in zip(want, scales)]
    dq_term, dk_term = ring_runs.delta_terms(q, k, do, limits[0], causal)
    tols_share = []
    for g, w, o, limit, term in zip(got, want, own, limits,
                                    (0, dq_term, dk_term, 0)):
        assert g.dtype == torch.bfloat16
        err = (g.float() - w.float()).abs()
        assert bool((err <= limit).all())
        assert bool(((g.float() - o.float()).abs() <= limit + term).all())
        tols_share.append(float((err / (1e-3 + 1.6e-2 * w.float().abs()))
                                .max()))
    if causal:
        assert max(tols_share) > 1.0


@pytest.mark.parametrize("causal", CAUSAL)
def test_ring_launches_the_live_blocks_only(causal, monkeypatch):
    """Each live block calls the forward once and each backward kernel's
    entry once: n(n+1)/2 causal, n^2 not (phase 26's 10 and 16 at n 4);
    counted around each block, the n diagonal blocks apart from the whole
    ones."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tattn, "flash_attention_fwd",
                        counted("fwd", tattn.flash_attention_fwd))
    monkeypatch.setattr(tattn, "flash_attention_bwd_from_stats",
                        counted("bwd", tattn.flash_attention_bwd_from_stats))
    _, by_kind = ring_runs.ring_fwd_bwd(*_folded(3), 4, causal,
                                        read=lambda: dict(calls))
    want = ring_runs.live_blocks(4, causal)
    assert want == (10 if causal else 16)
    assert calls == {"fwd": want, "bwd": want}
    if causal:
        assert by_kind == {"diag": {"fwd": 4, "bwd": 4},
                           "full": {"fwd": 6, "bwd": 6}}
    else:
        assert by_kind == {"full": {"fwd": 16, "bwd": 16}}


def test_block_modes_and_merge():
    assert [block_mode(2, s, True) for s in range(4)] == [False, False,
                                                          True, None]
    assert {block_mode(1, s, False) for s in range(4)} == {False}
    # merging two halves' (out, lse) gives the whole row's
    q, k, v, _ = _folded(5, s=32)
    scale = q.shape[-1] ** -0.5
    whole, lse = tattn._flash_plain(q, k, v, causal=False, sm_scale=scale)
    acc = None
    for half in (slice(0, 16), slice(16, 32)):
        acc = merge_blocks(acc, tattn._flash_plain(
            q, k[:, half], v[:, half], causal=False, sm_scale=scale))
    torch.testing.assert_close(acc[0], whole, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(acc[1], lse, atol=1e-6, rtol=1e-6)
    assert merge_blocks(acc, None) is acc


def test_ring_config_builds_and_refuses_to_run_unbound():
    cfg = tgpt2.GPT2Config.small_test(attention="ring", dtype=torch.float32)
    model = tgpt2.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel group"):
        model(torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="attention='ring'"):
        plain = tgpt2.GPT2Config.small_test(dtype=torch.float32)
        m, opt = tgpt2.make_train_state(plain, device="cpu")
        tgpt2.build_train_step_sp(m, opt, mesh=None)
