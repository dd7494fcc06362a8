"""Switch-Transformer LM in PyTorch: the port of ``ray_tpu/models/moe_lm.py``
(forward and single-device training).

A GPT-2 decoder in which every ``moe_every``-th block (block i when
``(i + 1) % moe_every == 0``) replaces its dense MLP with a Switch top-1
mixture of experts (``ray_tpu_torch.ops.moe``). Numerics follow the
reference: attention, LayerNorms, the dense blocks and the tied head
compute in ``config.dtype`` (bf16 by default) over f32 parameters, as
GPT-2's do; the MoE FFN runs in f32 (tokens cast to f32, f32 router and
expert weights) and its output is cast back to ``dtype``. Each MoE block
adds its load-balance loss, and ``loss_fn`` returns ``lm + aux_loss_coeff *
mean(aux)`` with (lm, aux); aux is 0.0 without an MoE block.

The reference's blocks attend with ``jax.nn.dot_product_attention`` (fused
attention on a TPU); the port's run ``ops.flash_attention(causal=True)``
(GPT-2's ``CausalSelfAttention`` with ``attention="flash"``): the sm_90a
kernels on CUDA tensors, their plain versions on CPU tensors. The MoE
blocks dispatch tokens by index (``moe.moe_ffn``), not by the reference's
one-hot einsums, with the same outputs to the bit.

Training: ``make_train_state`` (GPT-2's AdamW: betas 0.9/0.95, weight decay
0.1 on every parameter, the reference's ``optax.adamw``) and
``build_train_step`` (in place, through ``gpt2.in_place_step``); the step
returns (model, optimizer, loss, lm, aux). Expert parallelism inside the
model (``ep_axis``, ``shard_train_state_ep``) waits for the parallel layer;
the ops-level EP pattern is ``moe.moe_ffn_ep`` with ``moe.ep_loss_and_grads``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.gpt2 import LayerNorm
from ray_tpu_torch.ops import moe


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    num_experts: int = 8
    moe_every: int = 2          # every k-th block gets a MoE FFN
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    # the reference's mesh axis for moe_ffn_ep inside its shard_map; the
    # port has no mesh yet, so any value raises
    ep_axis: Optional[str] = None

    def __post_init__(self):
        if self.ep_axis is not None:
            raise NotImplementedError(
                "ep_axis waits for the parallel layer (ROADMAP queue 1, "
                "\"TP, SP, PP and EP\"); the ops-level pattern is "
                "ops.moe.moe_ffn_ep over torch.distributed groups")
        if self.n_embd % self.n_head:
            raise ValueError("n_embd must be a multiple of n_head")

    @classmethod
    def small_test(cls, **kw):
        base = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2,
                    n_head=2, num_experts=4, moe_every=1,
                    dtype=torch.float32)
        base.update(kw)
        return cls(**base)

    def is_moe(self, layer: int) -> bool:
        return (layer + 1) % self.moe_every == 0

    def gpt2_config(self) -> gpt2.GPT2Config:
        """The GPT-2 configuration of the attention and dense parts."""
        return gpt2.GPT2Config(vocab_size=self.vocab_size,
                               n_positions=self.n_positions,
                               n_embd=self.n_embd, n_layer=self.n_layer,
                               n_head=self.n_head, dtype=self.dtype,
                               attention="flash")


# a dense block is GPT-2's: ln_1, attn, ln_2, mlp
DenseBlock = gpt2.Block


class MoEBlock(nn.Module):
    """Pre-LN block: causal self-attention, then the Switch MoE FFN in f32
    on the LayerNormed stream. Returns (x, aux)."""

    def __init__(self, config: MoELMConfig):
        super().__init__()
        c = config
        D, E = c.n_embd, c.num_experts
        self.config = c
        self.ln_1 = LayerNorm(D, c.dtype)
        self.attn = gpt2.CausalSelfAttention(c.gpt2_config())
        self.ln_2 = LayerNorm(D, c.dtype)
        self.router = nn.Parameter(torch.empty(D, E))
        self.wi = nn.Parameter(torch.empty(E, D, 4 * D))
        self.wo = nn.Parameter(torch.empty(E, 4 * D, D))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.config
        x = x + self.attn(self.ln_1(x))
        h = self.ln_2(x)
        B, T, D = h.shape
        params = {"router": self.router, "wi": self.wi, "wo": self.wo}
        # looked up at call time, so that a caller can swap the dispatch
        out, aux = moe.moe_ffn(params, h.reshape(B * T, D).float(),
                               capacity_factor=c.capacity_factor)
        return x + out.reshape(B, T, D).to(c.dtype), aux


class MoELM(nn.Module):
    def __init__(self, config: MoELMConfig):
        super().__init__()
        c = config
        self.config = c
        self.wte = nn.Embedding(c.vocab_size, c.n_embd)
        self.wpe = nn.Embedding(c.n_positions, c.n_embd)
        self.h = nn.ModuleList(
            MoEBlock(c) if c.is_moe(i) else DenseBlock(c.gpt2_config())
            for i in range(c.n_layer))
        self.ln_f = LayerNorm(c.n_embd, c.dtype)

    def forward(self, input_ids) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(logits in ``dtype`` through the tied head, each MoE block's aux
        loss in block order)."""
        dt = self.config.dtype
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = self.wte(input_ids).to(dt) + self.wpe(pos).to(dt)
        aux_terms = []
        for block in self.h:
            if isinstance(block, MoEBlock):
                x, aux = block(x)
                aux_terms.append(aux)
            else:
                x = block(x)
        x = self.ln_f(x)
        return F.linear(x, self.wte.weight.to(dt)), aux_terms


def init_params(config: MoELMConfig,
                generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None) -> MoELM:
    """An MoELM with fresh f32 parameters drawn from ``generator`` on the
    CPU (one seed, the same weights on every device), then moved to
    ``device``: the CUDA card by default, which raises without one (pass
    ``device="cpu"`` to stay on the CPU). GPT-2's scales for its parts
    (``gpt2.init_params``); the router (D, E) and ``wi`` (E, D, 4D) ~
    N(0, 1/D) and ``wo`` (E, 4D, D) ~ N(0, 1/4D): the reference's scales,
    not its draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        model = MoELM(config)
    model = model.to_empty(device="cpu")
    D = config.n_embd
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "bias":
                p.zero_()
            elif ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0)
            elif name in ("wte.weight", "wpe.weight") or leaf == "router":
                p.normal_(0.0, D ** -0.5, generator=generator)
            else:  # Dense (out, in), wi (E, D, 4D), wo (E, 4D, D)
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
    return model.to(device)


def loss_fn(model: MoELM, batch: Dict[str, torch.Tensor], aux_coeff: float
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(lm + aux_coeff * aux, (lm, aux)): ``gpt2.fused_xent`` of the logits
    on ``batch`` (``input_ids``, ``labels``, optional ``mask``) and the mean
    of the MoE blocks' aux losses (0.0 without an MoE block), f32."""
    logits, aux_terms = model(batch["input_ids"])
    lm = gpt2.fused_xent(logits, batch["labels"], batch.get("mask"))
    aux = (sum(aux_terms) / len(aux_terms) if aux_terms
           else lm.new_zeros(()))
    return lm + aux_coeff * aux, (lm, aux)


def make_train_state(config: MoELMConfig,
                     generator: Optional[torch.Generator] = None,
                     learning_rate: float = 3e-4,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[MoELM, torch.optim.AdamW]:
    """(model, optimizer): fresh parameters on ``device`` (the CUDA card by
    default, which raises without one) and the reference's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)`` over every
    parameter (``gpt2.make_optimizer``)."""
    model = init_params(config, generator, device=device).train()
    return model, gpt2.make_optimizer(model, learning_rate)


def build_train_step(model: MoELM, optimizer: torch.optim.Optimizer,
                     donate: bool = True):
    """``step(model, optimizer, batch) -> (model, optimizer, loss, lm,
    aux)``: one AdamW step on ``loss_fn``'s gradients with the config's
    ``aux_loss_coeff``, in place, as ``gpt2.build_train_step``
    (``donate=False`` is not offered)."""
    loss = functools.partial(loss_fn, aux_coeff=model.config.aux_loss_coeff)
    return gpt2.in_place_step(model, optimizer, loss, donate, has_aux=True)
