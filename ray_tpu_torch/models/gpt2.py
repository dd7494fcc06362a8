"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py`` (forward path).

Numerics follow the reference, which computes in ``config.dtype`` over f32
parameters: parameters stay f32 and every matmul input and activation is
cast to ``dtype`` (bf16 by default). Parity points with the Flax model:
LayerNorm eps = 1e-6 with statistics in f32, tanh-approximated GELU, causal
attention scaled by d^-1/2, ``c_attn`` split q|k|v on its last axis, and a
head tied to the token embedding.

``attention="flash"`` runs ``ray_tpu_torch.ops.flash_attention`` (the sm_90a
kernel on the card, its plain version on the CPU); ``"auto"`` is attention
written in plain tensor ops. Training (optimizer, chunked loss, remat) and
``"ring"`` attention belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # the Flax LayerNorm default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16
    # "auto": attention in plain tensor ops; "flash": the flash kernel
    attention: str = "auto"

    def __post_init__(self):
        if self.attention == "ring":
            raise NotImplementedError(
                "attention='ring' waits for the sequence-parallel slice")
        if self.attention not in ("auto", "flash"):
            raise ValueError(f"unknown attention {self.attention!r}")
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be a multiple of n_head")

    @classmethod
    def gpt2_124m(cls, **kw):
        return cls(**kw)

    @classmethod
    def small_test(cls, **kw):
        base = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                    n_head=4)
        base.update(kw)
        return cls(**base)

    def num_params(self) -> int:
        wpe = self.n_positions * self.n_embd
        wte = self.vocab_size * self.n_embd
        block = 12 * self.n_embd * self.n_embd + 13 * self.n_embd
        return wte + wpe + self.n_layer * block + 2 * self.n_embd


class Dense(nn.Linear):
    """Flax ``nn.Dense(dtype=...)``: f32 parameters, product in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=...)``: eps 1e-6, statistics in f32,
    output cast to ``dtype``."""

    def __init__(self, n_embd: int, dtype: torch.dtype):
        super().__init__(n_embd, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def _plain_causal_attention(q, k, v):
    """(B, T, H, D) causal attention in plain ops: scores and softmax in
    f32, probabilities cast back to the input dtype for the PV product."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t = s.shape[-1]
    mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
    s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.c_attn = Dense(config.n_embd, 3 * config.n_embd, config.dtype)
        self.c_proj = Dense(config.n_embd, config.n_embd, config.dtype)

    def forward(self, x):
        c = self.config
        B, T, C = x.shape
        q, k, v = self.c_attn(x).split(C, dim=-1)
        heads = c.n_head
        q = q.reshape(B, T, heads, C // heads)
        k = k.reshape(B, T, heads, C // heads)
        v = v.reshape(B, T, heads, C // heads)
        if c.attention == "flash":
            from ray_tpu_torch.ops import flash_attention

            bhsd = lambda t: t.transpose(1, 2)
            y = flash_attention(bhsd(q), bhsd(k), bhsd(v),
                                causal=True).transpose(1, 2)
        else:
            y = _plain_causal_attention(q, k, v)
        return self.c_proj(y.reshape(B, T, C))


class MLP(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.c_fc = Dense(config.n_embd, 4 * config.n_embd, config.dtype)
        self.c_proj = Dense(4 * config.n_embd, config.n_embd, config.dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(config.n_embd, config.dtype)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = LayerNorm(config.n_embd, config.dtype)
        self.mlp = MLP(config)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.n_embd)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd)
        self.h = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd, config.dtype)

    def forward(self, input_ids, return_hidden: bool = False):
        dt = self.config.dtype
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = self.wte(input_ids).to(dt) + self.wpe(pos).to(dt)
        for block in self.h:
            x = block(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        # weight-tied LM head (Flax ``wte.attend``), product in ``dtype``
        return F.linear(x, self.wte.weight.to(dt))


def token_log_likelihood(logits, labels):
    """Per-token ll = logit[label] - logsumexp(logits), in f32."""
    shifted = logits.float() - logits.detach().amax(dim=-1,
                                                    keepdim=True).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return label_logit - lse


def fused_xent(logits, labels, mask=None):
    """Masked-mean cross-entropy (see token_log_likelihood)."""
    ll = token_log_likelihood(logits, labels)
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def init_params(config: GPT2Config,
                generator: Optional[torch.Generator] = None,
                device: Union[str, torch.device] = "cpu") -> GPT2:
    """A GPT2 with fresh f32 parameters drawn from ``generator`` on the CPU
    (so one seed gives the same weights on every device), then moved to
    ``device``. Dense kernels ~ N(0, 1/fan_in), embeddings ~
    N(0, 1/n_embd), biases 0, LayerNorm scales 1: the Flax defaults' scales,
    not their exact draws."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        model = GPT2(config)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            elif name in ("wte.weight", "wpe.weight"):
                p.normal_(0.0, config.n_embd ** -0.5, generator=generator)
            else:  # Dense weight, (out, in)
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
    return model.to(device)


def synthetic_batch(seed: int, batch_size: int, seq_len: int, vocab: int,
                    device: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, torch.Tensor]:
    ids = np.random.default_rng(seed).integers(
        0, vocab, size=(batch_size, seq_len + 1), dtype=np.int64)
    ids = torch.from_numpy(ids).to(device)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
