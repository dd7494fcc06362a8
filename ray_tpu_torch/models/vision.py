"""Vision models in PyTorch: the port of ``ray_tpu/models/vision.py``
(ViT-B/16 and ResNet-50, forward and single-device training).

Images are NCHW (the reference is NHWC): ``synthetic_image_batch`` makes
them so and the weight bridge turns Flax's HWIO kernels into OIHW. Numerics
follow the reference, which computes in ``config.dtype`` (bf16 by default)
over f32 parameters: every Conv and Dense casts its input and weight to
``dtype`` for the product, LayerNorm and GroupNorm take their statistics in
f32 with eps 1e-6 and cast their output to ``dtype``, and both heads compute
in f32 on the ``dtype`` stream. Parity points with the Flax models:

- ``padding="SAME"`` pads ``total = max((ceil(n / s) - 1) * s + k - n, 0)``
  as (total // 2, the rest): asymmetric at stride 2 on an even input, (0, 1)
  for a 3x3 conv and the 3x3 max-pool (whose padding is -inf), (2, 3) for
  the 7x7 stem. ``same_pads`` computes it and ``F.pad`` applies it.
- ViT's patch tokens flatten in (H/p, W/p) row-major order, as the
  reference's reshape of its NHWC map; tanh-approximated GELU; attention
  without a mask through ``ray_tpu_torch.ops.flash_attention(causal=False)``
  (the sm_90a kernels on CUDA tensors, their plain versions on CPU tensors).
- GroupNorm takes ``min(32, filters)`` groups of contiguous channels, also
  on a block's 4 x filters output and its shortcut; the mean over H and W
  accumulates in f32 and rounds to ``dtype``, as ``jnp.mean`` on bf16 does.

Training: ``make_train_state`` (AdamW with the reference's
``optax.adamw(learning_rate)``: betas 0.9/0.999, eps 1e-8, weight decay 1e-4
on every parameter) and ``build_train_step`` (in place, through
``gpt2.in_place_step``). The convolutions are cuDNN's through
``F.conv2d``: the reference runs them as XLA convolutions, outside any
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.gpt2 import LN_EPS, Dense, LayerNorm


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) of Flax's ``padding="SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: Tuple[int, int], stride: Tuple[int, int],
              value: float = 0.0):
    top, bottom = same_pads(x.shape[-2], kernel[0], stride[0])
    left, right = same_pads(x.shape[-1], kernel[1], stride[1])
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """Flax ``nn.Conv(features, kernel, strides, use_bias, dtype)`` with
    its default SAME padding, on NCHW: f32 parameters, product in
    ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel, stride,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = _pad_same(x.to(dt), self.kernel_size, self.stride)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.stride)


class GroupNorm(nn.GroupNorm):
    """Flax ``nn.GroupNorm(num_groups, dtype)``: groups of contiguous
    channels, eps 1e-6, statistics in f32, output cast to ``dtype``."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype):
        super().__init__(groups, channels, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: the
    padding is -inf, so it never wins."""
    x = _pad_same(x, (kernel, kernel), (stride, stride), -float("inf"))
    return F.max_pool2d(x, kernel, stride)


# ---------------------------------------------------------------- ViT


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    # kept for parity with the JAX config, whose model never applies it;
    # no dropout is applied here either, so a nonzero value raises
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # recompute each block's activations in the backward (torch checkpoint)
    remat: bool = False

    def __post_init__(self):
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be a multiple of n_head")
        if self.image_size % self.patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        if self.dropout:
            raise ValueError(f"dropout={self.dropout}: the model applies no "
                             "dropout (the JAX model never reads it either)")

    @classmethod
    def vit_b16(cls, **kw):
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw):
        base = dict(image_size=32, patch_size=8, n_embd=64, n_layer=2,
                    n_head=4, mlp_dim=128, num_classes=10)
        base.update(kw)
        return cls(**base)

    @property
    def seq_len(self) -> int:
        """Patches plus the class token: 197 at ViT-B/16 on 224^2."""
        return (self.image_size // self.patch_size) ** 2 + 1


class ViTBlock(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        c = self.config = config
        self.norm1 = LayerNorm(c.n_embd, c.dtype)
        self.qkv = Dense(c.n_embd, 3 * c.n_embd, c.dtype)
        self.proj = Dense(c.n_embd, c.n_embd, c.dtype)
        self.norm2 = LayerNorm(c.n_embd, c.dtype)
        self.fc1 = Dense(c.n_embd, c.mlp_dim, c.dtype)
        self.fc2 = Dense(c.mlp_dim, c.n_embd, c.dtype)

    def forward(self, x):
        from ray_tpu_torch.ops import flash_attention

        c = self.config
        h = self.norm1(x)
        B, T, C = h.shape
        q, k, v = self.qkv(h).split(C, dim=-1)
        heads = lambda t: t.reshape(B, T, c.n_head, C // c.n_head
                                    ).transpose(1, 2)
        y = flash_attention(heads(q), heads(k), heads(v), causal=False)
        x = x + self.proj(y.transpose(1, 2).reshape(B, T, C))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        return x + self.fc2(h)


class ViT(nn.Module):
    """ViT with learned position embeddings and a class token; images
    (B, 3, H, W)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        c = self.config = config
        self.patch_embed = Conv(3, c.n_embd, c.patch_size, c.patch_size,
                                bias=True, dtype=c.dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, c.n_embd))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.seq_len, c.n_embd))
        self.h = nn.ModuleList(ViTBlock(c) for _ in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, c.dtype)
        self.head = Dense(c.n_embd, c.num_classes, torch.float32)

    def forward(self, images):
        c = self.config
        dt = c.dtype
        B = images.shape[0]
        # patchify = one conv with stride = patch; tokens in (H/p, W/p)
        # row-major order
        x = self.patch_embed(images).flatten(2).transpose(1, 2)
        cls = self.cls.to(dt).expand(B, 1, c.n_embd)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        remat = c.remat and torch.is_grad_enabled()
        for block in self.h:
            x = checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
        return self.head(self.ln_f(x)[:, 0])


# ---------------------------------------------------------------- ResNet


class ResNetBlock(nn.Module):
    """Bottleneck block (1x1 -> 3x3 -> 1x1) with GroupNorm. The shortcut
    projection exists where the reference's ``x.shape != y.shape``: the
    channels change or the stride is 2 (every configuration's stride-2
    block also changes the channels)."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        groups = min(32, filters)
        out = 4 * filters
        self.conv1 = Conv(in_channels, filters, 1, dtype=dtype)
        self.norm1 = GroupNorm(groups, filters, dtype)
        self.conv2 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.norm2 = GroupNorm(groups, filters, dtype)
        self.conv3 = Conv(filters, out, 1, dtype=dtype)
        self.norm3 = GroupNorm(groups, out, dtype)
        self.shortcut = self.shortcut_norm = None
        if in_channels != out or stride != 1:
            self.shortcut = Conv(in_channels, out, 1, stride, dtype=dtype)
            self.shortcut_norm = GroupNorm(groups, out, dtype)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        if self.shortcut is not None:
            x = self.shortcut_norm(self.shortcut(x))
        return F.relu(x + y)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16
    # CIFAR stem: 3x3 stride-1 conv, no max-pool (32x32 inputs)
    cifar_stem: bool = False

    @classmethod
    def resnet50(cls, **kw):
        return cls(**kw)

    @classmethod
    def resnet50_cifar(cls, **kw):
        base = dict(num_classes=10, cifar_stem=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def small_test(cls, **kw):
        base = dict(stage_sizes=(1, 1), num_classes=10, width=16,
                    cifar_stem=True)
        base.update(kw)
        return cls(**base)

    @property
    def image_size(self) -> int:
        """The input size the reference's ``make_train_state`` inits at."""
        return 32 if self.cifar_stem else 224


class ResNet(nn.Module):
    """ResNet with GroupNorm; images (B, 3, H, W)."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        c = self.config = config
        if c.cifar_stem:
            self.stem = Conv(3, c.width, 3, dtype=c.dtype)
        else:
            self.stem = Conv(3, c.width, 7, 2, dtype=c.dtype)
        self.stem_norm = GroupNorm(min(32, c.width), c.width, c.dtype)
        blocks, channels = [], c.width
        for stage, n_blocks in enumerate(c.stage_sizes):
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                filters = c.width * 2 ** stage
                blocks.append(ResNetBlock(channels, filters, stride, c.dtype))
                channels = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, c.num_classes, torch.float32)

    def forward(self, images):
        c = self.config
        x = self.stem(images.to(c.dtype))
        if not c.cifar_stem:
            x = max_pool_same(x, 3, 2)
        x = F.relu(self.stem_norm(x))
        for block in self.blocks:
            x = block(x)
        # jnp.mean over H and W: an f32 sum, rounded to dtype
        x = x.float().mean(dim=(2, 3)).to(c.dtype)
        return self.head(x)


# ---------------------------------------------------------------- shared

VisionConfig = Union[ViTConfig, ResNetConfig]
VisionModel = Union[ViT, ResNet]


def classification_loss(logits, labels):
    """Mean softmax cross-entropy over int labels, f32 accumulation."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0] - lse
    return -ll.mean()


def loss_fn(model: VisionModel, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """``classification_loss`` of the model on ``batch`` (``image``,
    ``label``), f32 scalar."""
    return classification_loss(model(batch["image"]), batch["label"])


def build_model(config: VisionConfig) -> VisionModel:
    return ViT(config) if isinstance(config, ViTConfig) else ResNet(config)


def init_params(config: VisionConfig,
                generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> VisionModel:
    """A ViT or ResNet (by the config's type) with fresh f32 parameters
    drawn from ``generator`` on the CPU (one seed, the same weights on every
    device), then moved to ``device``: the CUDA card by default, which
    raises without one (pass ``device="cpu"`` to stay on the CPU). Conv and
    Dense kernels ~ N(0, 1/fan_in), ``pos_embed`` ~ N(0, 0.02^2), the class
    token and biases 0, norm scales 1: the Flax defaults' scales, not their
    exact draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        model = build_model(config)
    model = model.to_empty(device="cpu")
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (nn.LayerNorm, nn.GroupNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, _, leaf = name.rpartition(".")
            if name == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif name == "cls" or leaf == "bias":
                p.zero_()
            elif owner in norms:
                p.fill_(1.0)
            else:  # Conv (O, I, kh, kw) or Dense (out, in): fan_in = p[0]
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return model.to(device)


def make_optimizer(model: VisionModel, learning_rate: float = 1e-3
                   ) -> torch.optim.AdamW:
    """The reference's ``optax.adamw(learning_rate)`` (b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4, no mask) as ``torch.optim.AdamW`` over
    every parameter: the class token, ``pos_embed``, biases and norm
    scales are decayed too. Not GPT-2's optimizer (betas 0.9/0.95, wd
    0.1)."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_state(config: VisionConfig,
                     generator: Optional[torch.Generator] = None,
                     learning_rate: float = 1e-3,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[VisionModel, torch.optim.AdamW]:
    """(model, optimizer): fresh parameters on ``device`` (the CUDA card by
    default, which raises without one) and their AdamW."""
    model = init_params(config, generator, device=device).train()
    return model, make_optimizer(model, learning_rate)


def build_train_step(model: VisionModel, optimizer: torch.optim.Optimizer,
                     donate: bool = True):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    optimizer step on ``loss_fn``'s gradients, in place, as
    ``gpt2.build_train_step`` (``donate=False`` is not offered)."""
    return gpt2.in_place_step(model, optimizer, loss_fn, donate)


def synthetic_image_batch(seed: int, batch_size: int, image_size: int,
                          num_classes: int,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, torch.Tensor]:
    """Standard-normal images (B, 3, H, W) f32 and int64 labels from numpy
    ``seed``, on ``device`` (the CUDA card by default, which raises without
    one)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch_size, 3, image_size, image_size),
                                 dtype=np.float32)
    labels = rng.integers(0, num_classes, size=(batch_size,))
    return {"image": torch.from_numpy(images).to(device),
            "label": torch.from_numpy(labels).to(device)}
