"""The port's ViT and ResNet against ``ray_tpu.models.vision`` on the same
weights.

Flax parameters from ``init(PRNGKey(0), ...)`` at ``small_test`` size (ViT:
32^2 images, patch 8, 64 wide, 4 heads, so S 17 and D 16; ResNet: width 16,
stages (1, 1), the CIFAR stem, and also the ImageNet stem with its max-pool
on 64^2 images) cross through ``vision_params_from_jax``; images and labels
come from a numpy seed, NHWC for Flax and NCHW for the port. The port's
attention runs through the kernels' plain versions (CPU tensors), the JAX
side as ``tests/test_models.py`` runs it.

Tolerances: f32 logits within 1e-4 of the largest |logit| (sums in another
order); the bf16 defaults within 2e-2 of it (both sides round every
activation to 8 significant bits, at other places); gradients of
``classification_loss`` in f32, each leaf's relative error norm within
1e-3; parameters after AdamW steps atol 2e-5, except the key slice of each
ViT ``qkv`` bias, whose true gradient is exactly zero (softmax does not see
a shift shared by every key), so that Adam moves it by up to lr per step
with a sign set by rounding noise on each side: within 2 lr per step.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import vision as jvision
from ray_tpu_torch.models import vision as tvision
from ray_tpu_torch.models.convert import (
    vision_opt_state_from_jax,
    vision_params_from_jax,
)
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.tools import vision_runs

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
# (kind, image size): ViT, ResNet with the CIFAR stem, ResNet with the
# ImageNet stem (7x7 stride-2 conv and 3x3 stride-2 max-pool)
KINDS = [("vit", 32), ("resnet", 32), ("resnet_imagenet", 64)]
KIND_IDS = [k for k, _ in KINDS]


def _configs(kind, jdtype=jnp.float32, tdtype=torch.float32):
    if kind == "vit":
        return (jvision.ViTConfig.small_test(dtype=jdtype),
                tvision.ViTConfig.small_test(dtype=tdtype))
    stem = dict(cifar_stem=kind == "resnet")
    return (jvision.ResNetConfig.small_test(dtype=jdtype, **stem),
            tvision.ResNetConfig.small_test(dtype=tdtype, **stem))


def _models(kind, size, jdtype=jnp.float32, tdtype=torch.float32):
    jcfg, tcfg = _configs(kind, jdtype, tdtype)
    jmodel = (jvision.ViT if kind == "vit" else jvision.ResNet)(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))["params"]
    tmodel = tvision.build_model(tcfg)
    tmodel.load_state_dict(vision_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _batch(size, seed=0, n=4, classes=10):
    rng = np.random.default_rng(seed)
    nhwc = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    labels = rng.integers(0, classes, size=(n,), dtype=np.int32)
    jbatch = {"image": jnp.asarray(nhwc), "label": jnp.asarray(labels)}
    tbatch = {"image": torch.from_numpy(nhwc.transpose(0, 3, 1, 2).copy()),
              "label": torch.from_numpy(labels.astype(np.int64))}
    return jbatch, tbatch


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


def _jax_loss(jmodel):
    def loss_of(params, batch):
        logits = jmodel.apply({"params": params}, batch["image"])
        return jvision.classification_loss(logits, batch["label"])
    return loss_of


@pytest.mark.parametrize("kind,size", KINDS, ids=KIND_IDS)
def test_forward_matches_flax(kind, size):
    jmodel, jparams, tmodel = _models(kind, size)
    jbatch, tbatch = _batch(size)
    want = np.asarray(jmodel.apply({"params": jparams}, jbatch["image"]))
    with torch.no_grad():
        got = tmodel(tbatch["image"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kind,size", KINDS, ids=KIND_IDS)
def test_bf16_forward_close_to_flax(kind, size):
    jmodel, jparams, tmodel = _models(kind, size, jnp.bfloat16,
                                      torch.bfloat16)
    jbatch, tbatch = _batch(size, seed=1)
    want = np.asarray(jmodel.apply({"params": jparams}, jbatch["image"]),
                      dtype=np.float32)
    with torch.no_grad():
        got = tmodel(tbatch["image"])
    # the heads compute in f32 on the bf16 stream
    assert got.dtype == torch.float32
    _close(got, want, atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kind,size", KINDS, ids=KIND_IDS)
def test_loss_and_grads_match_jax(kind, size):
    jmodel, jparams, tmodel = _models(kind, size)
    jbatch, tbatch = _batch(size, seed=2)
    jloss, jgrads = jax.value_and_grad(_jax_loss(jmodel))(jparams, jbatch)
    loss = tvision.loss_fn(tmodel, tbatch)
    loss.backward()
    _close(float(loss.detach()), float(jloss), atol=1e-5, rtol=1e-5)
    want = vision_params_from_jax(jax.tree.map(np.asarray, jgrads))
    rel = {n: float((p.grad - want[n]).norm() / want[n].norm().clamp_min(
        1e-12)) for n, p in tmodel.named_parameters()}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-3, (worst, rel[worst])


def _assert_params_after_steps(tmodel, jparams, steps):
    want = vision_params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in tmodel.named_parameters():
        got = p.detach().clone()
        if name.endswith(".qkv.bias"):
            C = got.shape[0] // 3
            assert float(p.grad[C:2 * C].abs().max()) < 1e-6, name
            diff = (got - want[name])[C:2 * C].abs().max()
            assert float(diff) <= 2 * LR * steps, name
            got[C:2 * C] = want[name][C:2 * C]
        _close(got, want[name], atol=2e-5, rtol=0, err_msg=name)


def _jax_steps(jmodel, jparams, jbatch, steps, opt_state=None):
    tx = optax.adamw(LR)
    opt_state = tx.init(jparams) if opt_state is None else opt_state
    step = jvision.build_train_step(jmodel, tx, donate=False)
    for _ in range(steps):
        jparams, opt_state, _ = step(jparams, opt_state, jbatch)
    return jparams, opt_state


@pytest.mark.parametrize("kind,size", KINDS, ids=KIND_IDS)
def test_params_after_adamw_steps_match_optax(kind, size):
    """Three steps of ``make_train_state``'s AdamW against
    ``optax.adamw(1e-3)`` (b2 0.999, weight decay 1e-4 on every leaf)."""
    jmodel, jparams, tmodel = _models(kind, size)
    jbatch, tbatch = _batch(size, seed=3)
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, 3)
    optimizer = tvision.make_optimizer(tmodel, LR)
    group = optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["weight_decay"] == 1e-4
    assert len(group["params"]) == len(list(tmodel.parameters()))
    step = tvision.build_train_step(tmodel, optimizer)
    for _ in range(3):
        step(tmodel, optimizer, tbatch)
    _assert_params_after_steps(tmodel, jparams, 3)
    with pytest.raises(ValueError, match="donate"):
        tvision.build_train_step(tmodel, optimizer, donate=False)


@pytest.mark.parametrize("kind,size", KINDS[:2], ids=KIND_IDS[:2])
def test_opt_state_bridge_resumes_a_jax_train_state(kind, size):
    """Two optax steps in JAX, then params and AdamW moments cross into the
    port; one more step on each side gives the same params."""
    jmodel, jparams, tmodel = _models(kind, size)
    jbatch, tbatch = _batch(size, seed=4)
    jparams, opt_state = _jax_steps(jmodel, jparams, jbatch, 2)
    tmodel.load_state_dict(vision_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    optimizer = tvision.make_optimizer(tmodel, LR)
    vision_opt_state_from_jax(jax.tree.map(np.asarray, opt_state), tmodel,
                              optimizer)
    head = optimizer.state[tmodel.head.weight]
    assert float(head["step"]) == 2.0
    jparams, _ = _jax_steps(jmodel, jparams, jbatch, 1, opt_state)
    tvision.build_train_step(tmodel, optimizer)(tmodel, optimizer, tbatch)
    _assert_params_after_steps(tmodel, jparams, 1)


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_training_reduces_loss(kind):
    """``tests/test_models.py::test_vit_forward_and_train`` and
    ``::test_resnet_forward_and_train`` on the port: 8 AdamW steps (lr
    1e-2) on one batch of 8 at the bf16 defaults lower the loss."""
    _, cfg = _configs(kind, jnp.bfloat16, torch.bfloat16)
    model, optimizer = tvision.make_train_state(
        cfg, torch.Generator().manual_seed(0), learning_rate=1e-2,
        device="cpu")
    step = tvision.build_train_step(model, optimizer)
    batch = tvision.synthetic_image_batch(1, 8, 32, cfg.num_classes,
                                          device="cpu")
    assert batch["image"].shape == (8, 3, 32, 32)
    losses = []
    for _ in range(8):
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_resnet50_cifar_overshoots_at_lr_1e3_as_the_reference_does():
    """Why ``chip_smoke.py`` trains at lr 1e-4: at the reference's default
    ``optax.adamw(1e-3)``, with no warm-up, the first Adam steps overshoot
    at full width and the loss rises. ResNet-50 with the CIFAR stem at its
    bf16 default, on bridged weights and one batch of 8: JAX and the port
    both rise over 3 steps and agree within 5 % at each (bf16 noise)."""
    jmodel = jvision.ResNet(jvision.ResNetConfig.resnet50_cifar())
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))["params"]
    tmodel = tvision.ResNet(tvision.ResNetConfig.resnet50_cifar())
    tmodel.load_state_dict(vision_params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    jbatch, tbatch = _batch(32, seed=7, n=8)
    tx = optax.adamw(1e-3)
    jopt = tx.init(jparams)
    jstep = jvision.build_train_step(jmodel, tx, donate=False)
    optimizer = tvision.make_optimizer(tmodel, 1e-3)
    tstep = tvision.build_train_step(tmodel, optimizer)
    jlosses, tlosses = [], []
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jbatch)
        _, _, tloss = tstep(tmodel, optimizer, tbatch)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    assert jlosses[-1] > jlosses[0] and tlosses[-1] > tlosses[0]
    _close(tlosses, jlosses, atol=0, rtol=5e-2)


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", ["vit_b16", "resnet50", "resnet50_cifar"])
def test_full_configs_have_the_reference_parameter_count(name):
    """Built on the meta device (no memory, no forward) against
    ``jax.eval_shape`` of the Flax init (shapes only)."""
    family = "ViT" if name.startswith("vit") else "ResNet"
    jcfg = getattr(getattr(jvision, f"{family}Config"), name)()
    tcfg = getattr(getattr(tvision, f"{family}Config"), name)()
    jmodel = getattr(jvision, family)(jcfg)
    size = tcfg.image_size
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))["params"]
    with torch.device("meta"):
        tmodel = tvision.build_model(tcfg)
    assert sum(p.numel() for p in tmodel.parameters()) == _count(shapes)
    want = vision_params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} \
        == {n: tuple(t.shape) for n, t in want.items()}


def test_resnet50_cifar_stages():
    """``tests/test_models.py::test_resnet50_config_shapes``, and the
    blocks it builds: 3, 4, 6, 3 bottlenecks, stride 2 at the first block
    of stages 1-3, a projection shortcut exactly there and at block 0."""
    cfg = tvision.ResNetConfig.resnet50_cifar()
    assert tuple(cfg.stage_sizes) == (3, 4, 6, 3) and cfg.num_classes == 10
    assert cfg.cifar_stem and cfg.image_size == 32
    with torch.device("meta"):
        model = tvision.ResNet(cfg)
    assert len(model.blocks) == 16
    firsts = {0, 3, 7, 13}
    for i, block in enumerate(model.blocks):
        assert (block.shortcut is not None) == (i in firsts), i
        assert block.conv2.stride == ((2, 2) if i in firsts - {0}
                                      else (1, 1)), i
    assert model.stem.kernel_size == (3, 3) and model.stem.stride == (1, 1)
    assert model.head.in_features == 2048
    assert model.blocks[-1].norm3.num_groups == 32
    assert model.blocks[0].norm3.num_groups == 32
    assert tvision.ResNetConfig.small_test().stage_sizes == (1, 1)


@pytest.mark.parametrize("op,kernel,stride,size", [
    ("conv", 3, 2, 16), ("conv", 7, 2, 32), ("conv", 3, 2, 15),
    ("conv", 8, 8, 32), ("max_pool", 3, 2, 16)])
def test_same_padding_matches_flax(op, kernel, stride, size):
    """Flax's ``padding="SAME"``: (0, 1) for a 3x3 stride-2 conv and the
    3x3 stride-2 max-pool on an even input, (2, 3) for the 7x7 stride-2
    stem, (1, 1) on an odd input, none for the patch embedding. torch's
    symmetric ``padding=k // 2`` gives other values on an even input."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    to_nchw = lambda y: np.asarray(y).transpose(0, 3, 1, 2)
    if op == "max_pool":
        want = to_nchw(fnn.max_pool(jnp.asarray(x), (kernel, kernel),
                                    strides=(stride, stride),
                                    padding="SAME"))
        got = tvision.max_pool_same(tx, kernel, stride)
        naive = F.max_pool2d(tx, kernel, stride, padding=kernel // 2)
    else:
        conv = fnn.Conv(4, (kernel, kernel), (stride, stride),
                        use_bias=False)
        params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        want = to_nchw(conv.apply({"params": params}, jnp.asarray(x)))
        tconv = tvision.Conv(3, 4, kernel, stride, dtype=torch.float32)
        w = torch.from_numpy(np.array(params["kernel"])).permute(3, 2, 0, 1)
        with torch.no_grad():
            tconv.weight.copy_(w)
            got = tconv(tx)
            naive = F.conv2d(tx, w, stride=stride, padding=kernel // 2)
    assert got.shape == want.shape
    _close(got.detach(), want, atol=1e-5, rtol=1e-5)
    before, after = tvision.same_pads(size, kernel, stride)
    if before != after:
        assert not np.allclose(naive.detach().numpy(), want, atol=1e-3)
    assert (tvision.same_pads(16, 3, 2), tvision.same_pads(224, 7, 2),
            tvision.same_pads(112, 3, 2), tvision.same_pads(224, 16, 16)) \
        == ((0, 1), (2, 3), (0, 1), (0, 0))


@pytest.mark.parametrize("s,d", [(17, 16), (197, 64)])
def test_vit_attention_matches_jax_non_causal(s, d):
    """The attention of ``ViTBlock`` at ``small_test``'s (S 17, D 16) and
    ViT-B/16's (S 197, D 64), non-causal: ``flash_attention`` (the autograd
    Function over the kernels' plain versions on CPU tensors) against
    ``jax.nn.dot_product_attention``, outputs and gradients, in f32."""
    rng = np.random.default_rng(s)
    B, H = 2, 3
    q, k, v, do = (rng.standard_normal((B, s, H, d), dtype=np.float32)
                   for _ in range(4))

    def jloss(q, k, v):
        return (jax.nn.dot_product_attention(q, k, v) * do).sum()

    want = jax.nn.dot_product_attention(q, k, v)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    bhsd = lambda t: t.transpose(1, 2)
    out = tattn.flash_attention(*(bhsd(t) for t in leaves),
                                causal=False).transpose(1, 2)
    (out * torch.from_numpy(do)).sum().backward()
    _close(out.detach(), want, atol=2e-5, rtol=2e-5)
    for t, g in zip(leaves, jgrads):
        _close(t.grad, g, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("kind,size,leaf", [
    ("vit", 32, "h_1/LayerNorm_1/scale"), ("vit", 32, "h_0/Dense_1/bias"),
    ("vit", 32, "pos_embed"), ("resnet", 32, "ResNetBlock_1/shortcut"),
    ("resnet", 32, "ResNetBlock_0/GroupNorm_2/bias"),
    ("resnet", 32, "GroupNorm_0/scale")])
def test_bridge_raises_on_a_missing_leaf(kind, size, leaf):
    _, jparams, _ = _models(kind, size)
    tree = jax.tree.map(np.asarray, jparams)
    tree = jax.tree_util.tree_map(lambda x: x, tree)  # plain dicts
    node = tree
    *path, last = leaf.split("/")
    for part in path:
        node = node[part]
    del node[last]
    with pytest.raises(KeyError):
        vision_params_from_jax(tree)


def test_entry_points_need_a_device_and_configs_check_themselves():
    cfg = tvision.ViTConfig.small_test()
    if not torch.cuda.is_available():
        for call in (lambda: tvision.init_params(cfg),
                     lambda: tvision.make_train_state(cfg),
                     lambda: tvision.synthetic_image_batch(0, 2, 32, 10)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    with pytest.raises(ValueError, match="dropout"):
        tvision.ViTConfig.small_test(dropout=0.1)
    assert tvision.ViTConfig.vit_b16().seq_len == 197
    assert cfg.seq_len == 17
    model = tvision.init_params(cfg, device="cpu").requires_grad_(False)
    assert float(model.cls.abs().max()) == 0.0
    assert abs(float(model.pos_embed.std()) - 0.02) < 0.005
    assert float(model.h[0].norm1.weight.min()) == 1.0
    assert float(model.h[0].qkv.bias.abs().max()) == 0.0
    std = float(model.h[0].fc1.weight.std())
    assert abs(std - 64 ** -0.5) < 0.02
    resnet = tvision.init_params(tvision.ResNetConfig.small_test(),
                                 device="cpu").requires_grad_(False)
    assert float(resnet.blocks[0].norm3.weight.min()) == 1.0
    std = float(resnet.stem.weight.std())
    assert abs(std - 27 ** -0.5) < 0.05


def test_remat_gives_the_same_grads():
    _, _, tmodel = _models("vit", 32)
    _, tbatch = _batch(32, seed=6)
    tvision.loss_fn(tmodel, tbatch).backward()
    grads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    remat = tvision.ViT(tvision.ViTConfig.small_test(dtype=torch.float32,
                                                     remat=True))
    remat.load_state_dict(tmodel.state_dict())
    tvision.loss_fn(remat, tbatch).backward()
    for n, p in remat.named_parameters():
        _close(p.grad, grads[n], atol=1e-7, rtol=1e-6, err_msg=n)


def test_chip_runs_drive_the_paths_at_small_size_on_the_cpu():
    """``tools/vision_runs.py``, which ``chip_smoke.py`` runs at full width
    on the card, at ``small_test`` size on the CPU: no kernel launches
    here (CPU tensors take the plain versions), so the kernel and plain
    paths agree to the bit."""
    cfg = tvision.ViTConfig.small_test()
    batch = tvision.synthetic_image_batch(0, 8, 32, 10, device="cpu")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    before = {n: getattr(tattn, f"{n}_launches") for n in names}
    run = vision_runs.train(cfg, batch, 3, "cpu", learning_rate=1e-2)
    assert len(run["losses"]) == len(run["step_ms"]) == 3
    assert run["losses"][-1] < run["losses"][0]
    run = vision_runs.train(tvision.ResNetConfig.small_test(), batch, 3,
                            "cpu", learning_rate=1e-2)
    assert run["losses"][-1] < run["losses"][0]
    net = vision_runs.model(tvision.ViTConfig.small_test(
        dtype=torch.float32), "cpu")
    kernel, plain = vision_runs.logits_both(net, batch["image"])
    assert torch.equal(kernel, plain) and kernel.shape == (8, 10)
    calls = vision_runs.attention_inputs(net, batch["image"], (0, 1))
    assert [c[0] for c in calls] == ["forward layer 0", "forward layer 1"]
    for _, (q, k, v), kw in calls:
        assert q.shape == k.shape == v.shape == (8 * 4, 17, 16)
        assert q.is_contiguous() and kw == {"causal": False}
        out, _ = tattn.flash_attention_fwd(q, k, v, causal=False)
        assert torch.isfinite(out).all()
    assert {n: getattr(tattn, f"{n}_launches") for n in names} == before


def test_port_import_walk_covers_the_vision_modules():
    """The AST walk of ``tests/test_torch_serve_llm.py`` takes every
    ``ray_tpu_torch/**/*.py``, so the vision modules are among the files it
    holds to importing neither JAX nor ``ray_tpu``."""
    names = {f.relative_to(REPO).as_posix()
             for f in (REPO / "ray_tpu_torch").rglob("*.py")}
    assert {"ray_tpu_torch/models/vision.py",
            "ray_tpu_torch/tools/vision_runs.py",
            "ray_tpu_torch/tools/decode_ab.py"} <= names
