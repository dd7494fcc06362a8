"""The port's Llama against ``ray_tpu.models.llama`` on the same weights.

JAX parameters from ``init_params(..., PRNGKey(0))`` at ``small_test`` size
(vocab 256, 2 layers, 64 wide, 4 heads, 2 KV heads; also 4 and 1 KV heads)
cross through ``llama_params_from_jax``; inputs come from a numpy seed.
Both sides run in f32 (``dtype=jnp.float32`` / ``torch.float32``): the JAX
side as ``tests/test_models.py`` runs it on the CPU, the port's attention
through the kernels' plain versions (CPU tensors).

Tolerances: logits, caches and attention outputs atol = rtol = 2e-5 (f32
sums taken in another order); the loss atol = rtol = 1e-5; gradients atol
1e-5 / rtol 1e-4; parameters after AdamW steps atol 2e-5. The bf16 case
compares at atol = rtol = 5e-2: both sides round every activation to 8
significant bits (relative 2^-8 = 3.9e-3) at other places, across two
layers and a 256-way head.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (
    llama_opt_state_from_jax,
    llama_params_from_jax,
)
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.tools import llama_runs

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB = 256


def _models(n_kv_head=2, jdtype=jnp.float32, tdtype=torch.float32):
    jcfg = jllama.LlamaConfig.small_test(n_kv_head=n_kv_head, dtype=jdtype)
    jmodel, jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.small_test(n_kv_head=n_kv_head, dtype=tdtype)
    tmodel = tllama.Llama(tcfg).eval()
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _ids(shape, seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, size=shape,
                                               dtype=np.int32)
    return jnp.asarray(ids), torch.from_numpy(ids.astype(np.int64))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    pos = np.array([[0, 1, 7, 33, 127], [3, 5, 64, 65, 99]], dtype=np.int32)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    jcos, jsin = jllama.rope_frequencies(16, jnp.asarray(pos), theta)
    tcos, tsin = tllama.rope_frequencies(16, torch.from_numpy(pos), theta)
    assert tcos.shape == (2, 5, 8) and tcos.dtype == torch.float32
    _close(tcos, jcos, **TOL)
    _close(tsin, jsin, **TOL)
    ref = jllama.apply_rope(jnp.asarray(x), jcos, jsin)
    out = tllama.apply_rope(torch.from_numpy(x), tcos, tsin)
    _close(out, ref, **TOL)
    # interleaved pairs, not rotate_half: position 0 is the identity, and
    # a pair (x0, x1) at angle a becomes (x0 cos a - x1 sin a, ...)
    _close(out[0, 0], x[0, 0], atol=0, rtol=0)
    a = 1.0  # position 1, first pair: inv frequency 1
    want = x[0, 1, :, 0] * np.cos(a) - x[0, 1, :, 1] * np.sin(a)
    _close(out[0, 1, :, 0], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64), dtype=np.float32) * 3 + 0.5
    scale = rng.standard_normal(64, dtype=np.float32)
    jnorm = jllama.RMSNorm(1e-5, getattr(jnp, dtype))
    ref = jnorm.apply({"params": {"scale": jnp.asarray(scale)}},
                      jnp.asarray(x))
    tnorm = tllama.RMSNorm(64, 1e-5, getattr(torch, dtype))
    with torch.no_grad():
        tnorm.weight.copy_(torch.from_numpy(scale))
        out = tnorm(torch.from_numpy(x))
    assert out.dtype == getattr(torch, dtype)
    assert tnorm.weight.dtype == torch.float32
    tol = TOL if dtype == "float32" else dict(atol=0, rtol=2 ** -8)
    _close(out.float(), np.asarray(ref, dtype=np.float32), **tol)


@pytest.mark.parametrize("shape", [(2, 16), (1, 37)])
@pytest.mark.parametrize("n_kv_head", [4, 2, 1])
def test_forward_matches_jax(n_kv_head, shape):
    jmodel, jparams, tmodel = _models(n_kv_head)
    jids, tids = _ids(shape, seed=n_kv_head)
    ref, _ = jax.jit(jmodel.apply)({"params": jparams}, jids)
    with torch.no_grad():
        out, caches = tmodel(tids)
    assert caches is None
    assert out.shape == (*shape, VOCAB) and out.dtype == torch.float32
    _close(out, ref, **TOL)


def test_bf16_forward_close_to_jax():
    """bf16 compute over the same f32 weights on both sides."""
    jmodel, jparams, tmodel = _models(2, jnp.bfloat16, torch.bfloat16)
    jids, tids = _ids((2, 16), seed=5)
    ref, _ = jax.jit(jmodel.apply)({"params": jparams}, jids)
    with torch.no_grad():
        out, _ = tmodel(tids)
    assert out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(ref, dtype=np.float32), atol=5e-2,
           rtol=5e-2)


@pytest.mark.parametrize("n_kv_head", [2, 1])
def test_cached_decode_matches_jax_step_by_step(n_kv_head):
    """From empty caches, one token at a time: logits and every layer's
    filled caches against JAX's ``build_decode_step`` at every step, and
    the last step's logits against the full causal pass (the contract of
    ``tests/test_models.py::test_llama_decode_matches_full_pass``)."""
    jmodel, jparams, tmodel = _models(n_kv_head)
    jids, tids = _ids((2, 12), seed=6)
    cfg = tmodel.config
    jcaches = jllama.init_kv_caches(jmodel.config, 2, max_len=16)
    tcaches = tllama.init_kv_caches(cfg, 2, max_len=16, device="cpu")
    assert tcaches[0][0].shape == (2, 16, n_kv_head, cfg.head_dim)
    jdecode = jllama.build_decode_step(jmodel)
    tdecode = tllama.build_decode_step(tmodel)
    for t in range(12):
        jlogits, jcaches = jdecode(jparams, jids[:, t:t + 1], jnp.int32(t),
                                   jcaches)
        tlogits, tcaches = tdecode(tids[:, t:t + 1], t, tcaches)
        _close(tlogits, jlogits, **TOL)
        for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
            _close(tk, jk, **TOL)
            _close(tv, jv, **TOL)
    with torch.no_grad():
        full, _ = tmodel(tids)
    _close(tlogits, full[:, -1], **TOL)


def test_prefill_through_cache_path_matches_jax():
    jmodel, jparams, tmodel = _models()
    jids, tids = _ids((2, 9), seed=7)
    jlogits, jcaches = jllama._prefill(
        jmodel, jparams, jids, jllama.init_kv_caches(jmodel.config, 2,
                                                     max_len=13))
    tlogits, tcaches = tllama._prefill(
        tmodel, tids, tllama.init_kv_caches(tmodel.config, 2, max_len=13,
                                            device="cpu"))
    _close(tlogits, jlogits, **TOL)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        _close(tk, jk, **TOL)
        _close(tv, jv, **TOL)
    # rows past the prompt stay zero
    assert not tcaches[0][0][:, 9:].any()


@pytest.mark.parametrize("sq", [1, 5])
def test_live_slice_mask_equals_whole_cache_bias(sq):
    """The reference's mask (llama.py:145-151): query i at global position
    cache_index + i sees key j iff j <= cache_index + i, as a -1e9 bias
    over the whole static cache. The port passes the live part
    [:cache_index + Sq] with causal=True. The rows past it hold noise, not
    zeros, so a port that read them would differ."""
    rng = np.random.default_rng(8 + sq)
    B, L, H, KV, D, index = 2, 24, 4, 2, 16, 9
    q = rng.standard_normal((B, sq, H, D), dtype=np.float32)
    ck = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    cv = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    q_pos = index + jnp.arange(sq)
    k_pos = jnp.arange(L)
    bias = jnp.where(k_pos[None, :] <= q_pos[:, None], 0.0, -1e9)
    ref = jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        bias=bias[None, None, :, :].astype(jnp.float32))
    end = index + sq
    out = tllama.causal_attention(torch.from_numpy(q),
                                  torch.from_numpy(ck)[:, :end],
                                  torch.from_numpy(cv)[:, :end])
    assert out.shape == (B, sq, H, D)
    _close(out, ref, **TOL)


@pytest.mark.parametrize("sq", [1, 5])
def test_whole_cache_with_k_len_equals_the_reference_bias(sq):
    """What the decode now hands the kernel: the whole static cache and the
    live length ``k_len = index + Sq`` as a 0-d int32 tensor, against the
    reference's -1e9 bias over the same cache (llama.py:145-151). The rows
    past the live part hold noise, not zeros."""
    rng = np.random.default_rng(18 + sq)
    B, L, H, KV, D, index = 2, 24, 4, 2, 16, 9
    q = rng.standard_normal((B, sq, H, D), dtype=np.float32)
    ck = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    cv = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    q_pos = index + jnp.arange(sq)
    bias = jnp.where(jnp.arange(L)[None, :] <= q_pos[:, None], 0.0, -1e9)
    ref = jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        bias=bias[None, None, :, :].astype(jnp.float32))
    out = tllama.causal_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        k_len=torch.tensor(index + sq, dtype=torch.int32))
    _close(out, ref, **TOL)


def test_whole_cache_decode_hands_the_kernel_static_shapes(monkeypatch):
    """Every flash-attention call of ``generate``'s decode steps gets q, k,
    v and ``k_len`` of the same (shape, dtype): the whole cache, after the
    GQA repeat, and a 0-d int32 live length that advances by one per step.
    So every decode step launches kernels of the same shapes."""
    import ray_tpu_torch.ops as ops

    _, _, tmodel = _models()
    cfg = tmodel.config
    kernel_path = ops.flash_attention
    calls = []

    def recording(q, k, v, **kw):
        k_len = kw["k_len"]
        calls.append((tuple((tuple(t.shape), t.dtype)
                            for t in (q, k, v, k_len)), int(k_len)))
        return kernel_path(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", recording)
    _, prompt = _ids((2, 5), seed=19)
    tllama.generate(tmodel, prompt, 4)   # caches of 9 rows
    n = cfg.n_layer
    assert len(calls) == 4 * n
    prefill, decode = calls[:n], calls[n:]
    shapes = {c[0] for c in decode}
    assert len(shapes) == 1
    (q, k, v, k_len), = shapes
    assert q == ((2, cfg.n_head, 1, cfg.head_dim), torch.float32)
    assert k == v == ((2, cfg.n_head, 9, cfg.head_dim), torch.float32)
    assert k_len == ((), torch.int32)
    assert [c[1] for c in prefill] == [5] * n
    assert [c[1] for c in decode] == [6] * n + [7] * n + [8] * n


def test_generate_greedy_matches_jax_and_sampling_needs_a_generator():
    jmodel, jparams, tmodel = _models()
    jprompt, tprompt = _ids((2, 4), seed=9)
    ref = jllama.generate(jmodel, jparams, jprompt, max_new_tokens=6)
    out = tllama.generate(tmodel, tprompt, max_new_tokens=6)
    assert out.shape == (2, 10) and out.dtype == tprompt.dtype
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="generator"):
        tllama.generate(tmodel, tprompt, 2, temperature=0.5)
    draws = [tllama.generate(tmodel, tprompt, 6, temperature=1.0,
                             generator=torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0][:, :4], tprompt)


def test_decode_past_the_cache_raises_where_jax_clamps():
    """JAX's ``dynamic_update_slice`` clamps a write past the cache's end
    onto its last row and decodes on; the port raises."""
    jmodel, jparams, tmodel = _models()
    jids, tids = _ids((1, 1), seed=10)
    jcaches = jllama.init_kv_caches(jmodel.config, 1, max_len=4)
    logits, _ = jllama.build_decode_step(jmodel)(jparams, jids,
                                                 jnp.int32(4), jcaches)
    assert np.isfinite(np.asarray(logits)).all()
    tcaches = tllama.init_kv_caches(tmodel.config, 1, max_len=4,
                                    device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tllama.build_decode_step(tmodel)(tids, 4, tcaches)


def _batch(seed=11, masked=False, T=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(2, T + 1), dtype=np.int32)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    if masked:
        batch["mask"] = (rng.random((2, T)) > 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.astype(np.float32 if k == "mask"
                                          else np.int64))
             for k, v in batch.items()})


def _torch_grads(tmodel, tbatch):
    tmodel.zero_grad(set_to_none=True)
    loss = tllama.loss_fn(tmodel, tbatch)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  tmodel.named_parameters()}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_kv_head", [2, 1])
def test_loss_and_grads_match_jax(n_kv_head, masked):
    jmodel, jparams, tmodel = _models(n_kv_head)
    jbatch, tbatch = _batch(masked=masked)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(jparams, jmodel,
                                                       jbatch)
    jgrads = llama_params_from_jax(jax.tree.map(np.asarray, jgrads))
    tloss, tgrads = _torch_grads(tmodel.train(), tbatch)
    np.testing.assert_allclose(tloss, float(jloss), atol=1e-5, rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        _close(g, jgrads[name], err_msg=name, **GRAD_TOL)


def _adamw(tmodel, lr=1e-3):
    """torch's AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4) over every parameter."""
    return torch.optim.AdamW(tmodel.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def test_params_after_adamw_steps_match_optax():
    """Three AdamW steps on one batch. Llama has no biases, and no
    parameter here has an exactly zero true gradient beside rounding
    noise (embedding rows of absent tokens get exact zeros on both
    sides), so every parameter is held at atol 2e-5."""
    jmodel, jparams, tmodel = _models()
    jbatch, tbatch = _batch(seed=12)
    tx = optax.adamw(1e-3)
    jopt = tx.init(jparams)
    jstep = jllama.build_train_step(jmodel, tx, donate=False)
    topt = _adamw(tmodel.train())
    tstep = tllama.build_train_step(tmodel, topt)
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jbatch)
        tmodel, topt, tloss = tstep(tmodel, topt, tbatch)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5)
    want = llama_params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.named_parameters():
        _close(p.detach(), want[name], atol=2e-5, rtol=0, err_msg=name)
    with pytest.raises(ValueError, match="donate"):
        tllama.build_train_step(tmodel, topt, donate=False)


def test_opt_state_bridge_resumes_a_jax_train_state():
    """One optax step in JAX, then both params and optimizer state cross
    over and each side takes two more steps."""
    jmodel, jparams, tmodel = _models()
    jbatch, tbatch = _batch(seed=13)
    tx = optax.adamw(1e-3)
    jstep = jllama.build_train_step(jmodel, tx, donate=False)
    jparams, jopt, _ = jstep(jparams, tx.init(jparams), jbatch)
    tmodel.load_state_dict(llama_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    topt = _adamw(tmodel.train())
    llama_opt_state_from_jax(jax.tree.map(np.asarray, jopt), tmodel, topt)
    tstep = tllama.build_train_step(tmodel, topt)
    for _ in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, jbatch)
        tmodel, topt, _ = tstep(tmodel, topt, tbatch)
    want = llama_params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.named_parameters():
        _close(p.detach(), want[name], atol=2e-5, rtol=0, err_msg=name)


def test_params_bridge_covers_every_leaf_and_raises_on_a_missing_one():
    _, jparams, tmodel = _models()
    tree = jax.tree.map(np.asarray, jparams)
    sd = llama_params_from_jax(tree)
    assert len(sd) == len(jax.tree.leaves(tree))
    assert set(sd) == set(tmodel.state_dict())
    assert sd["h.1.attn.k_proj.weight"].shape == (32, 64)  # (out, in)
    broken = dict(tree, h_1={k: v for k, v in tree["h_1"].items()
                             if k != "post_attn_norm"})
    with pytest.raises(KeyError):
        llama_params_from_jax(broken)
    with pytest.raises(KeyError):
        llama_params_from_jax({k: v for k, v in tree.items()
                               if k != "lm_head"})


def test_num_params_matches_jax():
    for name in ("llama2_7b", "llama3_8b"):
        t = getattr(tllama.LlamaConfig, name)().num_params()
        assert t == getattr(jllama.LlamaConfig, name)().num_params()
    assert tllama.LlamaConfig.llama2_7b().num_params() == 6_738_415_616
    assert tllama.LlamaConfig.llama3_8b().num_params() == 8_030_261_248
    _, jparams, tmodel = _models()
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    n_torch = sum(p.numel() for p in tmodel.parameters())
    assert n_torch == n_jax == tmodel.config.num_params()


def test_entry_points_need_a_device_and_init_draws_flax_scales():
    cfg = tllama.LlamaConfig.small_test(dtype=torch.float32)
    for call in (lambda: tllama.init_params(cfg),
                 lambda: tllama.init_kv_caches(cfg, 1),
                 lambda: tllama.synthetic_batch(0, 2, 8, VOCAB)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    again = tllama.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    params = dict(model.named_parameters())
    assert all(torch.equal(p, params[n]) for n, p in again.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert torch.equal(params["h.0.input_norm.weight"], torch.ones(64))
    std = lambda n: float(params[n].detach().std())
    assert abs(std("embed.weight") * 64 ** 0.5 - 1) < 0.05
    assert abs(std("h.0.mlp.down_proj.weight") * 128 ** 0.5 - 1) < 0.05
    assert abs(std("lm_head.weight") * 64 ** 0.5 - 1) < 0.05
    with pytest.raises(ValueError, match="n_kv_head"):
        tllama.LlamaConfig.small_test(n_kv_head=3)


def test_remat_gives_the_same_grads():
    _, _, tmodel = _models()
    _, tbatch = _batch(seed=14)
    loss, grads = _torch_grads(tmodel.train(), tbatch)
    grads = {n: g.clone() for n, g in grads.items()}
    remat = tllama.Llama(tllama.LlamaConfig.small_test(
        dtype=torch.float32, remat=True)).train()
    remat.load_state_dict(tmodel.state_dict())
    rloss, rgrads = _torch_grads(remat, tbatch)
    assert rloss == loss
    for n, g in rgrads.items():
        _close(g, grads[n], atol=1e-7, rtol=1e-6, err_msg=n)


def test_chip_runs_drive_the_paths_at_small_size_on_the_cpu():
    """``tools/llama_runs.py``, which ``chip_smoke.py`` runs at full width
    on the card, at ``small_test`` size on the CPU: the paths and checks
    it drives, without the kernels (CPU tensors take the plain versions,
    so the kernel and plain paths agree to the bit here)."""
    cfg = tllama.LlamaConfig.small_test(dtype=torch.float32)
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = llama_runs.prompts(0, 2, 8, cfg.vocab_size, "cpu")
    tokens = tllama.generate(model, prompts, 5)
    kernel, plain = llama_runs.teacher_forced_logits_both(model, tokens, 8)
    assert len(kernel) == len(plain) == 5
    assert all(torch.equal(k, p) for k, p in zip(kernel, plain))
    assert all(torch.equal(k.argmax(-1), tokens[:, 8 + i])
               for i, k in enumerate(kernel))
    assert llama_runs.decode_equals_full_pass(model, prompts) < 2e-5
    tllama.cast_for_serving(model, torch.bfloat16)
    assert model.lm_head.weight.dtype == model.embed.weight.dtype \
        == torch.bfloat16
    assert model.norm.weight.dtype == torch.float32
    serve_cfg = tllama.LlamaConfig.small_test()  # bf16 compute
    model = tllama.init_params(serve_cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tllama.cast_for_serving(model, torch.bfloat16)
    tokens, seconds = llama_runs.time_generate(model, prompts, 4)
    assert tokens.shape == (2, 12) and seconds > 0
    times = llama_runs.time_steps(model, tokens, 8)
    assert times["decode_steps"] == 3 and "prefill_launches" not in times
    # the launch counts of the prefill and of the decode steps, zeroed
    # before each and read after it: none on CPU tensors, which take the
    # plain versions
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    calls = []

    def zero():
        calls.append("zero")
        for n in names:
            setattr(tattn, f"{n}_launches", 0)

    def read():
        calls.append("read")
        return {n: getattr(tattn, f"{n}_launches") for n in names}

    times = llama_runs.time_steps(model, tokens, 8, counts=(zero, read))
    assert calls == ["zero", "read", "zero", "read"]
    assert times["prefill_launches"] == times["decode_launches"] \
        == dict.fromkeys(names, 0)
    assert times["prefill_ms"] > 0 and times["decode_ms_per_token"] > 0
    batch = tllama.synthetic_batch(0, 2, 16, VOCAB, device="cpu")
    run = llama_runs.train(tllama.LlamaConfig.small_test(n_layer=1), batch,
                           steps=3, device="cpu")
    losses = run["losses"]
    assert len(losses) == len(run["step_ms"]) == 3 and losses[-1] < losses[0]
    # the autograd Function's plain backward against autograd through the
    # plain forward: f32 sums in another order
    grads = llama_runs.grads_both(cfg, batch, device="cpu")
    assert grads["worst"] < 1e-4
    assert grads["loss_kernel"] == grads["loss_plain"]


def test_decode_ab_needs_a_card():
    import subprocess
    import sys

    script = REPO / "ray_tpu_torch" / "tools" / "decode_ab.py"
    proc = subprocess.run([sys.executable, str(script), str(REPO)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr


def test_port_import_walk_covers_the_llama_modules():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``, so the Llama modules are among the files it
    holds to importing neither JAX nor ``ray_tpu``."""
    names = {f.relative_to(REPO).as_posix()
             for f in (REPO / "ray_tpu_torch").rglob("*.py")}
    assert {"ray_tpu_torch/models/llama.py",
            "ray_tpu_torch/tools/llama_runs.py",
            "ray_tpu_torch/models/convert.py"} <= names
