"""Llama in PyTorch: the port of ``ray_tpu/models/llama.py`` (forward,
KV-cached decode, ``generate`` and single-device training).

The Llama-2/3 family by config: RMSNorm with its statistics and scale in
f32, rotary embeddings on interleaved (even, odd) pairs with the angles in
f32, grouped-query attention (``n_kv_head`` < ``n_head``), a SwiGLU MLP, no
biases and an untied LM head. Numerics follow the reference, which
computes in ``config.dtype`` over f32 parameters: every Dense casts its
input and weight to ``dtype`` for the product (``gpt2.Dense``). For serving,
the caller casts the Dense and Embed weights to bf16 and keeps the norm
scales f32 (``cast_for_serving``), as a JAX user casts the parameter tree
before ``generate``; a Dense then finds its weight already in ``dtype`` and casts nothing.

Attention always goes through ``ray_tpu_torch.ops.flash_attention`` with
``causal=True``: the sm_90a kernels on CUDA tensors (or a raise), their
plain versions on CPU tensors. Query head n reads KV head
n // (n_head / n_kv_head), as ``jax.nn.dot_product_attention`` maps them;
K and V are repeated over the head axis before the kernel, which takes
contiguous (B*H, S, D) operands.

The decode path is static-shape, as the reference's is: each step writes
its K and V into static per-layer caches in place with ``index_copy_`` at a
device index (JAX: ``dynamic_update_slice`` with the caches donated) and
hands the kernel the whole cache with the live key length ``k_len =
cache_index + T`` as a device tensor, so every decode step launches kernels
of the same shapes. The reference attends over the whole cache with a -1e9
bias that lets query i (at position ``cache_index + i``) see key j iff
j <= ``cache_index + i``; the kernel's causal alignment on ``k_len`` gives
the same keys, and it never reads the rows past ``k_len``. A Python-int
``cache_index`` is checked against the cache's length on the host (the
reference clamps a write past the end; the port raises); a tensor index is
not read on the host, so its caller (``generate``) keeps it in range.

Tensor-parallel sharding (``shard_params_tp``, ``shard_kv_caches_tp``)
belongs to a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.gpt2 import Dense

KVCache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_embd: int = 4096
    n_head: int = 32
    n_kv_head: int = 32          # < n_head => GQA (Llama-2-70B, Llama-3)
    intermediate: int = 11008    # SwiGLU hidden dim
    n_positions: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    def __post_init__(self):
        if self.n_embd % self.n_head or self.n_head % self.n_kv_head:
            raise ValueError("n_embd must be a multiple of n_head and n_head "
                             "a multiple of n_kv_head")

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw):
        base = dict(vocab_size=128256, n_embd=4096, n_layer=32, n_head=32,
                    n_kv_head=8, intermediate=14336, n_positions=8192,
                    rope_theta=500000.0)
        base.update(kw)
        return cls(**base)

    @classmethod
    def small_test(cls, **kw):
        base = dict(vocab_size=256, n_layer=2, n_embd=64, n_head=4,
                    n_kv_head=2, intermediate=128, n_positions=128)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        emb = self.vocab_size * self.n_embd
        attn = (self.n_embd * self.n_embd
                + 2 * self.n_embd * self.n_kv_head * self.head_dim
                + self.n_embd * self.n_embd)
        mlp = 3 * self.n_embd * self.intermediate
        block = attn + mlp + 2 * self.n_embd
        # untied LM head
        return 2 * emb + self.n_layer * block + self.n_embd


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, all in f32 (the scale is held
    in f32), cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(self.compute_dtype)


def rope_frequencies(head_dim: int, positions: torch.Tensor, theta: float):
    """(..., T) int positions -> cos/sin of shape (..., T, head_dim//2),
    in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D); rotate the interleaved pairs (even, odd) by the
    position angle, in f32, and cast back to x's dtype."""
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    # cos/sin: (B, T, D/2) -> broadcast over heads
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def causal_attention(q, k, v, k_len: Optional[torch.Tensor] = None):
    """Causal attention of q (B, T, H, D) over k, v (B, S, KV, D),
    bottom-right aligned on the live key length L (``k_len``, a 0-d int32
    tensor on q's device; S without one): query i (at position L - T + i)
    sees keys j <= L - T + i, and no key j >= L. Query head n reads KV head
    n // (H / KV). Returns (B, T, H, D) in q's dtype."""
    from ray_tpu_torch.ops import flash_attention

    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    bhsd = lambda t: t.transpose(1, 2)
    return flash_attention(bhsd(q), bhsd(k.to(q.dtype)), bhsd(v.to(q.dtype)),
                           causal=True, k_len=k_len).transpose(1, 2)


class CacheSlots(NamedTuple):
    """Where a cached forward's T tokens go: ``rows`` (T,) int64, their
    rows of the cache, and ``k_len``, the live length after them (0-d
    int32); both on the device, made once per forward for every layer."""
    rows: torch.Tensor
    k_len: torch.Tensor


def _check_in_cache(index: int, T: int, cache_len: int) -> None:
    if index + T > cache_len:
        raise ValueError(f"positions {index}..{index + T - 1} run past the "
                         f"cache's {cache_len}")


def cache_slots(cache_index: Union[int, torch.Tensor], T: int,
                cache_len: int, device) -> CacheSlots:
    """``CacheSlots`` for T tokens from ``cache_index``, an int (checked
    against ``cache_len`` on the host) or a 0-d integer device tensor (not
    read on the host)."""
    if not isinstance(cache_index, torch.Tensor):
        _check_in_cache(cache_index, T, cache_len)
        cache_index = torch.tensor(cache_index, device=device)
    rows = cache_index.long() + torch.arange(T, device=device)
    return CacheSlots(rows, (rows[-1] + 1).to(torch.int32))


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = self.config = config
        d = c.head_dim
        self.q_proj = Dense(c.n_embd, c.n_head * d, c.dtype, bias=False)
        self.k_proj = Dense(c.n_embd, c.n_kv_head * d, c.dtype, bias=False)
        self.v_proj = Dense(c.n_embd, c.n_kv_head * d, c.dtype, bias=False)
        self.o_proj = Dense(c.n_head * d, c.n_embd, c.dtype, bias=False)

    def forward(self, x, positions, kv_cache: Optional[KVCache] = None,
                slots: Optional[CacheSlots] = None):
        """Full-sequence causal pass when ``kv_cache`` is None; otherwise
        x's T tokens sit at the cache rows ``slots.rows``: their K and V
        are written into the cache (B, L, n_kv_head, D) in place and they
        attend over the whole cache, live up to ``slots.k_len``."""
        c = self.config
        B, T, _ = x.shape
        d = c.head_dim
        q = self.q_proj(x).reshape(B, T, c.n_head, d)
        k = self.k_proj(x).reshape(B, T, c.n_kv_head, d)
        v = self.v_proj(x).reshape(B, T, c.n_kv_head, d)
        cos, sin = rope_frequencies(d, positions, c.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_len = None
        if kv_cache is not None:
            ck, cv = kv_cache
            ck.index_copy_(1, slots.rows, k.to(ck.dtype))
            cv.index_copy_(1, slots.rows, v.to(cv.dtype))
            k, v, k_len = ck, cv, slots.k_len
        y = causal_attention(q, k, v, k_len)
        return self.o_proj(y.reshape(B, T, c.n_head * d))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.gate_proj = Dense(c.n_embd, c.intermediate, c.dtype, bias=False)
        self.up_proj = Dense(c.n_embd, c.intermediate, c.dtype, bias=False)
        self.down_proj = Dense(c.intermediate, c.n_embd, c.dtype, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = config
        self.input_norm = RMSNorm(c.n_embd, c.rms_eps, c.dtype)
        self.attn = LlamaAttention(c)
        self.post_attn_norm = RMSNorm(c.n_embd, c.rms_eps, c.dtype)
        self.mlp = LlamaMLP(c)

    def forward(self, x, positions, kv_cache: Optional[KVCache] = None,
                slots: Optional[CacheSlots] = None):
        x = x + self.attn(self.input_norm(x), positions, kv_cache, slots)
        return x + self.mlp(self.post_attn_norm(x))


class Llama(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        c = self.config = config
        self.embed = nn.Embedding(c.vocab_size, c.n_embd)
        self.h = nn.ModuleList(LlamaBlock(c) for _ in range(c.n_layer))
        self.norm = RMSNorm(c.n_embd, c.rms_eps, c.dtype)
        self.lm_head = Dense(c.n_embd, c.vocab_size, c.dtype, bias=False)

    def forward(self, input_ids, positions=None,
                kv_caches: Optional[List[KVCache]] = None,
                cache_index: Optional[Union[int, torch.Tensor]] = None):
        """Returns (logits, kv_caches). ``kv_caches`` is a list of
        per-layer (k, v) for decode, written in place and handed back, or
        None for prefill/training (then the second result is None).
        ``cache_index``, the cache row of the first token, is an int
        (checked on the host) or a 0-d device tensor (see the module's
        note)."""
        c = self.config
        B, T = input_ids.shape
        slots = None
        if kv_caches is not None:
            if cache_index is None:
                raise ValueError("kv_caches needs a cache_index")
            slots = cache_slots(cache_index, T, kv_caches[0][0].shape[1],
                                input_ids.device)
        if positions is None:
            positions = torch.arange(T, device=input_ids.device).expand(B, T)
        x = self.embed(input_ids).to(c.dtype)
        # remat (JAX ``nn.remat(LlamaBlock)``), on the non-cache path only:
        # keep each block's input, rerun the block in the backward
        remat = c.remat and kv_caches is None and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            if remat:
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                cache = None if kv_caches is None else kv_caches[i]
                x = block(x, positions, cache, slots)
        logits = self.lm_head(self.norm(x))
        return logits, kv_caches


def init_params(config: LlamaConfig,
                generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> Llama:
    """A Llama with fresh f32 parameters on ``device``: the CUDA card by
    default, which raises without one (pass ``device="cpu"`` to stay on the
    CPU). Each parameter is drawn where it lives, from ``generator``, which
    must be a generator of that device (default: seed 0 there), so a 7-8 B
    model never passes through the host; one seed therefore gives other
    weights on the CPU than on the card. Dense kernels ~ N(0, 1/fan_in),
    the embedding ~ N(0, 1/n_embd), RMSNorm scales 1: the Flax defaults'
    scales, not their exact draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.device("meta"):
        model = Llama(config)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name == "embed.weight":
                p.normal_(0.0, config.n_embd ** -0.5, generator=generator)
            else:  # Dense weight, (out, in)
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
    return model


def cast_for_serving(model: Llama, dtype: torch.dtype = torch.bfloat16
                     ) -> None:
    """Dense and Embed weights to ``dtype`` in place, one at a time; the
    RMSNorm scales stay f32. The cast a JAX user makes of the parameter
    tree before ``generate``: with f32 weights every decode step would
    re-cast all of them."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.data = module.weight.data.to(dtype)


def loss_fn(model: Llama, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``input_ids``,
    ``labels``, optional ``mask``), f32 scalar."""
    logits, _ = model(batch["input_ids"])
    return gpt2.fused_xent(logits, batch["labels"], batch.get("mask"))


def build_train_step(model: Llama, optimizer: torch.optim.Optimizer,
                     donate: bool = True):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    step of ``optimizer`` on ``loss_fn``'s gradients, in place, as
    ``gpt2.build_train_step`` (``donate=False`` is not offered)."""
    return gpt2.in_place_step(model, optimizer, loss_fn, donate)


def init_kv_caches(config: LlamaConfig, batch_size: int,
                   max_len: Optional[int] = None, dtype=None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> List[KVCache]:
    """Static-shape per-layer (k, v) caches for decode, zeros of shape
    (B, L, n_kv_head, D) in ``dtype`` (default the config's), on ``device``
    (the CUDA card by default, which raises without one)."""
    device = resolve_device(device)
    L = max_len or config.n_positions
    dtype = dtype or config.dtype
    shape = (batch_size, L, config.n_kv_head, config.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.n_layer)]


@torch.inference_mode()
def _decode_step(model: Llama, token, index: Union[int, torch.Tensor],
                 caches: List[KVCache]):
    """One token per sequence at cache row ``index``: an int, checked
    against the caches' length on the host, or a 0-d integer tensor on the
    device, which no part of the step reads on the host."""
    B = token.shape[0]
    if not isinstance(index, torch.Tensor):
        _check_in_cache(index, 1, caches[0][0].shape[1])
        index = torch.tensor(index, device=token.device)
    positions = index.long().reshape(1, 1).expand(B, 1)
    logits, caches = model(token, positions=positions, kv_caches=caches,
                           cache_index=index)
    return logits[:, -1, :], caches


@torch.inference_mode()
def _prefill(model: Llama, ids, caches: List[KVCache]):
    B, T = ids.shape
    positions = torch.arange(T, device=ids.device).expand(B, T)
    logits, caches = model(ids, positions=positions, kv_caches=caches,
                           cache_index=0)
    return logits[:, -1, :], caches


def build_decode_step(model: Llama):
    """Single-token decode: (token (B, 1), index, caches) ->
    (next-token logits (B, vocab), caches), the caches written in place at
    ``index`` (an int, or a 0-d device tensor; see ``_decode_step``).
    Every step has the same shapes. Runs under ``torch.inference_mode()``."""
    return lambda token, index, caches: _decode_step(model, token, index,
                                                     caches)


def generate(model: Llama, prompt_ids: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (argmax) or sampled generation: one cache-filling prefill
    over the prompt (B, T), then single-token decode steps; returns
    (B, T + max_new_tokens) ids in the prompt's dtype. Sampling draws from
    softmax(logits / temperature) with ``generator`` (on the model's
    device), which it needs: ``temperature > 0`` without one raises."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires an explicit generator")
    B, T = prompt_ids.shape
    device = model.embed.weight.device
    with torch.inference_mode():
        caches = init_kv_caches(model.config, B, max_len=T + max_new_tokens,
                                device=device)
        logits, caches = _prefill(model, prompt_ids, caches)
        # the decode steps' cache row, on the device, advanced in place; the
        # caches hold T + max_new_tokens rows, so it never runs past them
        index = torch.tensor(T, device=device)
        out = [prompt_ids]
        for i in range(max_new_tokens):
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = logits.argmax(dim=-1, keepdim=True)
            tok = tok.to(prompt_ids.dtype)
            out.append(tok)
            if i + 1 < max_new_tokens:
                logits, caches = _decode_step(model, tok, index, caches)
                index += 1
        return torch.cat(out, dim=1)


def synthetic_batch(seed: int, batch_size: int, seq_len: int, vocab: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """``gpt2.synthetic_batch``: random ids from numpy ``seed``, labels
    shifted by one, on ``device`` (CUDA by default)."""
    return gpt2.synthetic_batch(seed, batch_size, seq_len, vocab, device)
