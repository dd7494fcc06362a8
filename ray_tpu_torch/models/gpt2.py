"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py`` (forward and
single-device training).

Numerics follow the reference, which computes in ``config.dtype`` over f32
parameters: parameters stay f32 and every matmul input and activation is
cast to ``dtype`` (bf16 by default). Parity points with the Flax model:
LayerNorm eps = 1e-6 with statistics in f32, tanh-approximated GELU, causal
attention scaled by d^-1/2, ``c_attn`` split q|k|v on its last axis, and a
head tied to the token embedding.

``attention="flash"`` runs ``ray_tpu_torch.ops.flash_attention`` (the sm_90a
forward and backward kernels on the card, their plain versions on the CPU);
``"auto"`` is attention written in plain tensor ops. Training:
``make_train_state`` + ``build_train_step`` (AdamW over every parameter,
``loss_fn`` with the chunked tied-head loss when ``loss_chunks > 0``, a
checkpoint around each block when ``remat``). Data parallelism over NCCL
and ``"ring"`` attention belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device

LN_EPS = 1e-6  # the Flax LayerNorm default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    # kept for parity with the JAX config, whose model never reads it; no
    # dropout is applied here either, so a nonzero value raises
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # recompute each block's activations in the backward (torch checkpoint)
    remat: bool = False
    # "auto": attention in plain tensor ops; "flash": the flash kernels
    attention: str = "auto"
    # >0: the LM loss in ``loss_chunks`` sequence chunks, each chunk's logits
    # recomputed in the backward, so the [B, T, vocab] logits never exist
    loss_chunks: int = 0

    def __post_init__(self):
        if self.attention == "ring":
            raise NotImplementedError(
                "attention='ring' waits for the sequence-parallel slice")
        if self.attention not in ("auto", "flash"):
            raise ValueError(f"unknown attention {self.attention!r}")
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be a multiple of n_head")
        if self.dropout:
            raise ValueError(f"dropout={self.dropout}: the model applies no "
                             "dropout (the JAX model never reads it either)")

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
    """Flax ``nn.Dense(dtype=..., use_bias=...)``: f32 parameters, product
    in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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
        remat = self.config.remat and torch.is_grad_enabled()
        for block in self.h:
            # remat (JAX ``nn.remat(Block)``): keep only the block's input;
            # the backward reruns the block, flash forward kernel included
            x = checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
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


def chunked_xent_tied(hidden, embedding, labels, mask=None, n_chunks=8):
    """Tied-head LM loss computed in sequence chunks.

    Each chunk's logits (the product against the tied embedding, in
    ``hidden``'s dtype) exist only inside a ``torch.utils.checkpoint``
    region, so the backward recomputes them instead of holding them and the
    full [B, T, vocab] logits never exist. The embedding is cast once, outside
    the chunks. Unmasked, the denominator is B*T; masked, it is the mask's
    sum (at least 1)."""
    B, T, _ = hidden.shape
    if T % n_chunks:
        raise ValueError(f"sequence length {T} is not a multiple of "
                         f"loss_chunks={n_chunks}")
    t = T // n_chunks
    emb = embedding.to(hidden.dtype)

    def chunk_sums(h, lab, m):
        ll = token_log_likelihood(F.linear(h, emb), lab)
        if m is None:
            return ll.sum()
        return (ll * m.float()).sum()

    numer = hidden.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        part = slice(i * t, (i + 1) * t)
        m = None if mask is None else mask[:, part]
        numer = numer + checkpoint(chunk_sums, hidden[:, part],
                                   labels[:, part], m, use_reentrant=False)
    if mask is None:
        return -numer / (B * T)
    return -numer / torch.clamp(mask.float().sum(), min=1.0)


def loss_fn(model: GPT2, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``input_ids``,
    ``labels``, optional ``mask``), f32 scalar."""
    c = model.config
    if c.loss_chunks:
        hidden = model(batch["input_ids"], return_hidden=True)
        return chunked_xent_tied(hidden, model.wte.weight, batch["labels"],
                                 batch.get("mask"), n_chunks=c.loss_chunks)
    logits = model(batch["input_ids"])
    return fused_xent(logits, batch["labels"], batch.get("mask"))


def init_params(config: GPT2Config,
                generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> GPT2:
    """A GPT2 with fresh f32 parameters drawn from ``generator`` on the CPU
    (so one seed gives the same weights on every device), then moved to
    ``device``: the CUDA card by default, which raises without one (pass
    ``device="cpu"`` to stay on the CPU). Dense kernels ~ N(0, 1/fan_in),
    embeddings ~ N(0, 1/n_embd), biases 0, LayerNorm scales 1: the Flax
    defaults' scales, not their exact draws."""
    device = resolve_device(device)
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


def make_optimizer(model: GPT2, learning_rate: float = 3e-4,
                   weight_decay: float = 0.1) -> torch.optim.AdamW:
    """The JAX package's ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay)``
    as ``torch.optim.AdamW(betas=(0.9, 0.95), eps=1e-8)`` over **every**
    parameter (biases, LayerNorm scales and embeddings are decayed too: the
    optax recipe has no mask). Torch's decoupled decay p <- p(1 - lr*wd),
    then the Adam step, equals optax's p - lr*(adam + wd*p)."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate,
                             betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_state(config: GPT2Config,
                     generator: Optional[torch.Generator] = None,
                     learning_rate: float = 3e-4, weight_decay: float = 0.1,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[GPT2, torch.optim.AdamW]:
    """(model, optimizer): fresh parameters on ``device`` (the CUDA card by
    default, which raises without one) and their AdamW."""
    model = init_params(config, generator, device=device).train()
    return model, make_optimizer(model, learning_rate, weight_decay)


def build_train_step(model: GPT2, optimizer: torch.optim.Optimizer,
                     donate: bool = True, *, mesh=None,
                     ingraph_psum: Optional[str] = None):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    AdamW step on ``loss_fn``'s gradients, for one device.

    The step is built for ``model`` and ``optimizer`` (as the JAX step is
    built for one model and one optimizer) and raises if handed others. It
    updates the parameters and the optimizer state in place and hands back
    the same objects: that is what ``donate=True`` (the JAX step giving up
    its input buffers) means here. ``donate=False``, which would keep the
    old state alive, is not offered. ``loss`` is the step's loss as a
    detached f32 device scalar (``float(loss)`` waits for the device).

    ``mesh``/``ingraph_psum`` (data parallelism with an explicit gradient
    collective) raise NotImplementedError: data parallel over NCCL waits
    for ROADMAP queue 1's "The Train backend, data parallel and FSDP over
    NCCL"."""
    if mesh is not None or ingraph_psum is not None:
        raise NotImplementedError(
            "build_train_step(mesh=..., ingraph_psum=...): data parallel over "
            "NCCL is not ported yet (ROADMAP queue 1, \"The Train backend, "
            "data parallel and FSDP over NCCL\")")
    return in_place_step(model, optimizer, loss_fn, donate)


def in_place_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  loss, donate: bool = True, has_aux: bool = False):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    optimizer step on the gradients of ``loss(model, batch)``, updating
    ``model`` and ``optimizer`` in place; raises if handed another model
    or optimizer, and on ``donate=False``. With ``has_aux`` (as
    ``jax.value_and_grad``'s), ``loss`` returns (value, aux), a tuple of
    tensors, and the step returns (model, optimizer, value, *aux), each
    detached."""
    if not donate:
        raise ValueError("build_train_step(donate=False) is not offered: "
                         "the step updates the model in place")

    def step(step_model, step_optimizer, batch):
        if step_model is not model or step_optimizer is not optimizer:
            raise ValueError("this step was built for another model and "
                             "optimizer")
        optimizer.zero_grad(set_to_none=True)
        value, aux = loss(model, batch) if has_aux else (loss(model, batch),
                                                         ())
        value.backward()
        optimizer.step()
        return (model, optimizer, value.detach(),
                *(a.detach() for a in aux))

    return step


def synthetic_batch(seed: int, batch_size: int, seq_len: int, vocab: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random token ids from numpy ``seed`` on ``device`` (the CUDA card by
    default, which raises without one); labels are the ids shifted by one."""
    device = resolve_device(device)
    ids = np.random.default_rng(seed).integers(
        0, vocab, size=(batch_size, seq_len + 1), dtype=np.int64)
    ids = torch.from_numpy(ids).to(device)
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
