"""The port's GPT-2 against ``ray_tpu.models.gpt2`` on the same weights.

JAX parameters from ``init_params(..., PRNGKey(0))`` cross through
``params_from_jax``; both models run in f32 (``dtype=jnp.float32`` /
``torch.float32``). Logits agree to 2e-4, looser than the per-op 2e-5
because the two frameworks sum in another order across the layers.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_jax


def _bridged(attention):
    jcfg = jgpt2.GPT2Config.small_test(attention=attention, dtype=jnp.float32)
    jmodel, jparams = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tgpt2.GPT2Config.small_test(attention=attention,
                                       dtype=torch.float32)
    tmodel = tgpt2.GPT2(tcfg).eval()
    tmodel.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("shape", [(2, 32), (1, 37)])
@pytest.mark.parametrize("attention", ["flash", "auto"])
def test_logits_match_jax(attention, shape):
    jmodel, jparams, tmodel = _bridged(attention)
    ids = np.random.default_rng(sum(shape)).integers(
        0, 512, size=shape, dtype=np.int32)
    ref = jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(ids))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids.astype(np.int64)))
    assert out.shape == (*shape, 512) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_xent_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 512), dtype=np.float32) * 3
    labels = rng.integers(0, 512, size=(2, 16))
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32) if masked else None
    ref = jgpt2.fused_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    out = tgpt2.fused_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-5, rtol=1e-5)
    ll = tgpt2.token_log_likelihood(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    jll = jgpt2.token_log_likelihood(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), atol=1e-5,
                               rtol=1e-5)


def test_num_params_matches_jax():
    assert (tgpt2.GPT2Config.gpt2_124m().num_params()
            == jgpt2.GPT2Config.gpt2_124m().num_params() == 124_439_808)
    _, jparams, tmodel = _bridged("flash")
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    n_torch = sum(p.numel() for p in tmodel.parameters())
    assert n_torch == n_jax == tgpt2.GPT2Config.small_test().num_params()


def test_layernorm_eps_and_tanh_gelu_match_flax():
    """Parity traps: Flax LayerNorm eps is 1e-6 (torch defaults to 1e-5)
    and the MLP uses the tanh GELU. Inputs of small variance make the eps
    visible, inputs of large magnitude make tanh vs erf visible."""
    _, _, tmodel = _bridged("flash")
    lns = [m for m in tmodel.modules() if isinstance(m, tgpt2.LayerNorm)]
    assert len(lns) == 5 and all(m.eps == 1e-6 for m in lns)

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 64)) * 3e-3).astype(np.float32)
    jln = fnn.LayerNorm(dtype=jnp.float32)
    p = jln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = jln.apply(p, jnp.asarray(x))
    tln = tgpt2.LayerNorm(64, torch.float32)
    with torch.no_grad():
        out = tln(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    eps5 = torch.nn.functional.layer_norm(torch.from_numpy(x), (64,),
                                          eps=1e-5)
    assert (eps5 - out).abs().max() > 1e-2  # the wrong eps would show

    cfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32)
    jmlp = jgpt2.MLP(cfg)
    h = (rng.standard_normal((2, 5, 64)) * 2).astype(np.float32)
    mp = jmlp.init(jax.random.PRNGKey(1), jnp.asarray(h))["params"]
    tmlp = tgpt2.MLP(tgpt2.GPT2Config.small_test(dtype=torch.float32))
    with torch.no_grad():
        for name in ("c_fc", "c_proj"):
            getattr(tmlp, name).weight.copy_(
                torch.from_numpy(np.array(mp[name]["kernel"]).T))
            getattr(tmlp, name).bias.copy_(
                torch.from_numpy(np.array(mp[name]["bias"])))
        out = tmlp(torch.from_numpy(h))
    ref = jmlp.apply({"params": mp}, jnp.asarray(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_params_from_jax_layout_and_missing_leaf():
    _, jparams, _ = _bridged("auto")
    tree = jax.tree.map(np.asarray, jparams)
    sd = params_from_jax(tree)
    kern = tree["h_1"]["attn"]["c_attn"]["kernel"]
    assert kern.shape == (64, 192)
    np.testing.assert_array_equal(sd["h.1.attn.c_attn.weight"].numpy(),
                                  kern.T)
    np.testing.assert_array_equal(sd["h.0.ln_2.weight"].numpy(),
                                  tree["h_0"]["ln_2"]["scale"])
    del tree["h_0"]["mlp"]["c_fc"]
    with pytest.raises(KeyError):
        params_from_jax(tree)


def test_config_attention_modes():
    assert tgpt2.GPT2Config().dtype == torch.bfloat16
    ring = tgpt2.GPT2Config.small_test(attention="ring")
    assert ring.attention == "ring" and ring.sp_axis == "sp"
    with pytest.raises(ValueError):
        tgpt2.GPT2Config.small_test(attention="splash")


def test_bf16_forward_keeps_f32_params():
    """dtype=bf16: parameters stay f32, activations and logits are bf16."""
    cfg = tgpt2.GPT2Config.small_test(attention="flash")
    model = tgpt2.init_params(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = tgpt2.synthetic_batch(0, 2, 16, cfg.vocab_size, device="cpu")
    with torch.no_grad():
        logits = model(batch["input_ids"])
    assert logits.dtype == torch.bfloat16 and logits.shape == (2, 16, 512)
    with torch.no_grad():
        hidden = model(batch["input_ids"], return_hidden=True)
    assert hidden.dtype == torch.bfloat16 and hidden.shape == (2, 16, 64)
    loss = tgpt2.fused_xent(logits, batch["labels"])
    assert math.isfinite(float(loss))
    # random init near log(vocab) loss: the head is not degenerate
    assert abs(float(loss) - math.log(512)) < 2.0


def test_init_params_is_seeded():
    cfg = tgpt2.GPT2Config.small_test()
    a = tgpt2.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tgpt2.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    c = tgpt2.init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    wa, wb, wc = (m.h[0].attn.c_attn.weight.detach() for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert abs(float(wa.std()) - 64 ** -0.5) < 0.02


def test_synthetic_batch_shifts_labels():
    b = tgpt2.synthetic_batch(2, 3, 10, 100, device="cpu")
    assert b["input_ids"].shape == b["labels"].shape == (3, 10)
    assert torch.equal(b["input_ids"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(b["input_ids"], tgpt2.synthetic_batch(
        2, 3, 10, 100, device="cpu")["input_ids"])
