"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py`` (forward,
training, and data, sequence, tensor and pipeline parallelism).

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
checkpoint around each block when ``remat``). Data parallelism:
``shard_train_state`` wraps the model in DDP over a mesh's data axes or
shards it with FSDP2 (HSDP with a data axis too), ``shard_batch`` gives a
rank its slice of the global batch, and ``build_train_step(mesh=...)``
reduces the gradients with DDP's allreduce, FSDP2's reduce-scatter, or the
chunked or int8 collectives of ``ray_tpu_torch.parallel`` as a DDP
communication hook.

Model parallelism (each a step over a ``parallel.create_mesh`` DeviceMesh
that takes the GLOBAL batch, as the reference's jitted steps do, and hands
each rank its block):

- sequence (``attention="ring"``, ``build_train_step_sp``): the batch split
  over (data, sp), ``ops.ring_attention`` over the sp axis's group, the
  positions offset by sp_rank * T_local, and the gradients averaged over
  both axes after the backward;
- tensor (``shard_params_tp``, ``shard_train_state_tp``): Megatron's layout
  by ``parallel.apply_tp_plan`` (``c_attn`` and ``c_fc`` column-parallel,
  ``c_proj`` row-parallel, the rest replicated), DDP over the data axis;
  attention runs on a rank's H/n heads;
- pipeline (``make_pipeline_train_state``, ``shard_pipeline_state``,
  ``build_train_step_pp``): the reference's tree as ``GPT2Pipeline``, each
  pipeline rank keeping its stage of blocks and the replicated embeddings,
  the blocks run by ``parallel.pipeline_apply``.
"""

from __future__ import annotations

import dataclasses
import math
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
    # "auto": attention in plain tensor ops; "flash": the flash kernels;
    # "ring": ring attention over the sequence-parallel group the model is
    # bound to (``build_train_step_sp`` binds the mesh's ``sp_axis``)
    attention: str = "auto"
    sp_axis: str = "sp"
    # >0: the LM loss in ``loss_chunks`` sequence chunks, each chunk's logits
    # recomputed in the backward, so the [B, T, vocab] logits never exist
    loss_chunks: int = 0

    def __post_init__(self):
        if self.attention not in ("auto", "flash", "ring"):
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
    in ``dtype``. Under tensor parallelism (``parallel.apply_tp_plan``)
    ``tp_mode`` is "col" (the weight holds this rank's output features: the
    input's gradient is summed over ``tp_group``) or "row" (its input
    features: the product is summed over ``tp_group``). In a row product
    the group's first rank adds the replicated bias inside its product,
    rounded once with it as the plain product rounds it (over a group of
    one the two are the same op); the others add it as an exact zero
    (bias - bias.detach()), so that every rank's bias gets the same
    gradient, the sum of the replicated output's."""

    tp_mode: Optional[str] = None
    tp_group = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.tp_mode is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        import torch.distributed as dist

        from ray_tpu_torch.parallel import collectives

        if self.tp_mode == "col":
            x = collectives.pbroadcast(x, self.tp_group)
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        first = bias is None or dist.get_rank(self.tp_group) == 0
        y = F.linear(x.to(dt), self.weight.to(dt), bias if first else None)
        if not first:
            y = y + (bias - bias.detach())
        return collectives.psum_replicated(y, self.tp_group)


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
    # the sequence-parallel group of attention="ring" (GPT2.set_sp_group)
    sp_group = None

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.c_attn = Dense(config.n_embd, 3 * config.n_embd, config.dtype)
        self.c_proj = Dense(config.n_embd, config.n_embd, config.dtype)

    def forward(self, x):
        c = self.config
        B, T, _ = x.shape
        # this rank's heads: all of them, or H/n under tensor parallelism
        width = self.c_attn.weight.shape[0] // 3
        head_dim = c.n_embd // c.n_head
        q, k, v = (t.reshape(B, T, width // head_dim, head_dim)
                   for t in self.c_attn(x).split(width, dim=-1))
        if c.attention == "ring":
            from ray_tpu_torch.ops.ring_attention import ring_attention

            if self.sp_group is None:
                raise ValueError("attention='ring' needs the model bound to "
                                 "a sequence-parallel group: "
                                 "build_train_step_sp or set_sp_group")
            bhsd = lambda t: t.transpose(1, 2)
            y = ring_attention(bhsd(q), bhsd(k), bhsd(v),
                               axis_name=self.sp_group,
                               causal=True).transpose(1, 2)
        elif c.attention == "flash":
            from ray_tpu_torch.ops import flash_attention

            bhsd = lambda t: t.transpose(1, 2)
            y = flash_attention(bhsd(q), bhsd(k), bhsd(v),
                                causal=True).transpose(1, 2)
        else:
            y = _plain_causal_attention(q, k, v)
        return self.c_proj(y.reshape(B, T, width))


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
    sp_group = None

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.n_embd)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd)
        self.h = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(config.n_embd, config.dtype)

    def set_sp_group(self, group) -> None:
        """Bind ``attention="ring"`` to a sequence-parallel process group:
        the input is this rank's chunk of the sequence, rank i of the group
        holding chunk i (the reference binds its ``sp_axis`` by running the
        model inside ``shard_map``)."""
        self.sp_group = group
        for block in self.h:
            block.attn.sp_group = group

    def forward(self, input_ids, return_hidden: bool = False):
        dt = self.config.dtype
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None, :]
        if self.config.attention == "ring" and self.sp_group is not None:
            import torch.distributed as dist

            # T is this rank's chunk: offset to its global positions
            pos = pos + dist.get_rank(self.sp_group) * T
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
    numer = chunked_ll_sum(hidden, embedding, labels, mask, n_chunks)
    if mask is None:
        return -numer / (B * T)
    return -numer / torch.clamp(mask.float().sum(), min=1.0)


def chunked_ll_sum(hidden, embedding, labels, mask=None, n_chunks=8):
    """The sum of the tokens' log-likelihoods (times ``mask``) through the
    tied head, in ``n_chunks`` sequence chunks as ``chunked_xent_tied``
    computes them; f32 scalar."""
    T = hidden.shape[1]
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
    return numer


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


class LossModel(nn.Module):
    """``loss_fn`` of ``model`` as one module's forward: what DDP and FSDP2
    wrap. The loss reads the tied head (``model.wte.weight``) outside the
    model's own forward, so only a forward around the whole loss lets DDP's
    reducer and FSDP2's unshard/reshard see every use of it."""

    def __init__(self, model: GPT2):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return loss_fn(self.model, batch)


def _is_wrapped(model: nn.Module) -> bool:
    from torch.nn.parallel import DistributedDataParallel as DDP

    return isinstance(model, (DDP, LossModel))


def shard_train_state(model: GPT2, optimizer: torch.optim.Optimizer, mesh,
                      fsdp: bool = False):
    """(wrapped model, optimizer) for data parallelism over ``mesh`` (a
    ``parallel.create_mesh`` DeviceMesh): the model's loss (``LossModel``)
    wrapped in DDP over the group of the mesh's data-like axes (the axes
    ``shard_batch`` splits the batch over; replicated parameters), or, with
    ``fsdp=True`` and an ``fsdp`` axis, sharded with FSDP2 over it (HSDP
    with a ``data`` axis too; ``parallel.shard_params_fsdp``). The
    optimizer is the one given, re-pointed at the wrapped parameters
    (FSDP2 replaces them with DTensors): every param group keeps its
    parameters, in order, and all its hyperparameters and options; any
    state moves across, sharded like its parameter. Build the step on what
    this returns."""
    from collections import defaultdict

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.nn.parallel import DistributedDataParallel as DDP

    from ray_tpu_torch.parallel import mesh_utils

    if _is_wrapped(model):
        raise ValueError("shard_train_state: the model is already wrapped")
    name_of = {p: n for n, p in model.named_parameters()}
    held = [p for g in optimizer.param_groups for p in g["params"]]
    if any(p not in name_of for p in held):
        raise ValueError("shard_train_state: the optimizer holds a tensor "
                         "that is not a parameter of the model")
    loss_model = LossModel(model)
    if fsdp and "fsdp" in mesh.mesh_dim_names:
        # the tied embedding stays with the root's unit: the head reads it
        # after the embedding's own forward, when its unit has resharded
        wrapped = mesh_utils.shard_params_fsdp(loss_model, mesh,
                                               leave_to_root=(model.wte,))
    else:
        group = _data_group(mesh)
        dev = next(model.parameters()).device
        wrapped = DDP(loss_model, process_group=group,
                      device_ids=[dev.index] if dev.type == "cuda" else None)
    new = dict(model.named_parameters())
    state = defaultdict(dict)
    for group in optimizer.param_groups:
        params = [new[name_of[p]] for p in group["params"]]
        for old, p in zip(group["params"], params):
            if old not in optimizer.state:
                continue
            state[p] = {
                k: distribute_tensor(v, p.device_mesh, p.placements)
                if isinstance(p, DTensor) and torch.is_tensor(v)
                and v.shape == old.shape else v
                for k, v in optimizer.state[old].items()}
        group["params"] = params
    optimizer.state = state
    return wrapped, optimizer


def _data_group(mesh):
    """The process group over the mesh's data-like axes: one axis's group,
    or the whole default group when the mesh is only data-like axes."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh_utils

    axes = mesh_utils.data_sharding(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(mesh.mesh_dim_names) <= set(axes):
        return dist.group.WORLD
    raise ValueError(f"mesh axes {mesh.mesh_dim_names}: DDP over several "
                     "data axes beside other axes is not supported")


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of the global ``batch``: the leading dim split
    over the mesh's data-like axes (the reference's ``data_sharding``)."""
    from ray_tpu_torch.parallel import mesh_utils

    i, n = mesh_utils.shard_index(mesh, mesh_utils.data_sharding(mesh))
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split over "
                             f"{n} data shards")
        b = v.shape[0] // n
        out[k] = v[i * b:(i + 1) * b]
    return out


def _comm_hook(mode: str, chunks: int):
    """A DDP communication hook giving the MEAN of each bucket over the
    process group (its ``state``) through ``parallel.collectives``:
    "chunked" splits the bucket into ``chunks`` all-reduces (the split
    differs from the reference's per-parameter one; the sums do not);
    "quantized" quantizes each parameter's gradient in the bucket with its
    own scale, as the reference's per-leaf ``quantized_psum``."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import collectives

    def hook(group, bucket):
        buf = bucket.buffer()
        if mode == "chunked":
            reduced = collectives.chunked_psum(buf, group, chunks=chunks)
            reduced = reduced / dist.get_world_size(group)
        else:
            sizes = [p.numel() for p in bucket.parameters()]
            reduced = collectives.quantized_psum(buf, group, mean=True,
                                                 segments=sizes)
        buf.copy_(reduced)
        fut = torch.futures.Future()
        fut.set_result(buf)
        return fut

    return hook


def build_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                     donate: bool = True, *, mesh=None,
                     batch_axis: str = "data",
                     ingraph_psum: Optional[str] = None,
                     psum_chunks: Optional[int] = None):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    AdamW step on ``loss_fn``'s gradients.

    The step is built for ``model`` and ``optimizer`` (as the JAX step is
    built for one model and one optimizer) and raises if handed others. It
    updates the parameters and the optimizer state in place and hands back
    the same objects: that is what ``donate=True`` (the JAX step giving up
    its input buffers) means here. ``donate=False``, which would keep the
    old state alive, is not offered. ``loss`` is the step's loss as a
    detached f32 device scalar (``float(loss)`` waits for the device).

    Data parallelism: ``model`` and ``optimizer`` from
    ``shard_train_state`` and each rank's ``shard_batch`` block; with
    ``mesh``, ``loss`` is the global batch's mean (an all-reduce over the
    data axes), as the reference's. With no mode, DDP's own allreduce (or
    FSDP2's reduce-scatter) gives the mean gradient. ``ingraph_psum`` (or
    the ``train_ingraph_psum`` flag, usually armed per run via
    ``TorchConfig(ingraph_psum=...)``) registers a DDP communication hook
    instead: "chunked" splits each bucket's allreduce into ``psum_chunks``
    collectives, "quantized" rides the int8 wire (``quantized_psum``);
    both give the MEAN over ``batch_axis``'s group. A mode needs a mesh and
    a DDP model, and ``batch_axis`` must be the one axis the batch is split
    over (``shard_batch`` splits it over every data-like axis of the mesh):
    the port refuses a reduction over fewer axes than the split. As in the
    reference, ``batch_axis`` matters only with a mode. The loss is
    averaged over every axis the batch is split over."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

    mode = _cfg.train_ingraph_psum if ingraph_psum is None else ingraph_psum
    if mode and mesh is None:
        raise ValueError(
            f"ingraph_psum={mode!r} needs an explicit mesh: the collective "
            "runs over the mesh's data group")
    if mode not in ("", "chunked", "quantized"):
        raise ValueError(f"unknown ingraph_psum mode: {mode!r}")
    if not _is_wrapped(model):
        if mesh is not None:
            raise ValueError("build_train_step(mesh=...) takes the model "
                             "shard_train_state returns")
        return in_place_step(model, optimizer, loss_fn, donate)
    from ray_tpu_torch.parallel import collectives, mesh_utils

    split = mesh_utils.data_sharding(mesh) if mesh is not None else ()
    if mode:
        if split != (batch_axis,):
            raise ValueError(f"batch_axis {batch_axis!r}: the batch is split "
                             f"over the mesh's data-like axes {split}, and "
                             "the gradients must be reduced over the same")
        from torch.nn.parallel import DistributedDataParallel as DDP

        if not isinstance(model, DDP):
            raise ValueError(f"ingraph_psum={mode!r} runs as a DDP "
                             "communication hook: shard_train_state(fsdp="
                             "False)")
        chunks = int(psum_chunks if psum_chunks is not None
                     else _cfg.train_ingraph_psum_chunks)
        model.register_comm_hook(mesh.get_group(batch_axis),
                                 _comm_hook(mode, chunks))
    step = in_place_step(model, optimizer, lambda m, batch: m(batch), donate)
    if mesh is None:
        return step

    groups = mesh_utils.axis_groups(mesh, split)

    def global_step(step_model, step_optimizer, batch):
        step_model, step_optimizer, loss = step(step_model, step_optimizer,
                                                batch)
        for group in groups:
            loss = collectives.pmean(loss, group)
        return step_model, step_optimizer, loss

    return global_step


def in_place_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  loss, donate: bool = True, has_aux: bool = False,
                  grad_sync=None):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``: one
    optimizer step on the gradients of ``loss(model, batch)``, updating
    ``model`` and ``optimizer`` in place; raises if handed another model
    or optimizer, and on ``donate=False``. With ``has_aux`` (as
    ``jax.value_and_grad``'s), ``loss`` returns (value, aux), a tuple of
    tensors, and the step returns (model, optimizer, value, *aux), each
    detached. ``grad_sync()``, if given, runs between the backward and the
    optimizer's step (a gradient reduction)."""
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
        if grad_sync is not None:
            grad_sync()
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


# ---------------------------------------------------------------------------
# model parallelism
# ---------------------------------------------------------------------------

def _mesh_block(mesh, axes_dims: Dict[str, int],
                batch: Dict[str, torch.Tensor], keys=None
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of the global ``batch``: for each (mesh axis, dim)
    of ``axes_dims`` (axes the mesh lacks are skipped), that dim split over
    the axis, block i on the axis's rank i."""
    out = {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        for axis, dim in axes_dims.items():
            if axis not in mesh.mesh_dim_names:
                continue
            n = mesh.size(mesh.mesh_dim_names.index(axis))
            if v.shape[dim] % n:
                raise ValueError(f"{k}: dim {dim} of {tuple(v.shape)} does "
                                 f"not split over {n} {axis} shards")
            size = v.shape[dim] // n
            v = v.narrow(dim, mesh.get_local_rank(axis) * size, size)
        out[k] = v
    return out


def _grads(params):
    return [p.grad for p in params if p.grad is not None]


def build_train_step_sp(model: GPT2, optimizer: torch.optim.Optimizer, mesh,
                        *, sp_axis: str = "sp", batch_axis: str = "data",
                        donate: bool = True):
    """Sequence-parallel step ``step(model, optimizer, batch) -> (model,
    optimizer, loss)`` over ``mesh``: each rank takes its block of the
    global batch, the batch dim split over ``batch_axis`` and the sequence
    dim over ``sp_axis`` (ring attention over that axis's group; the model
    must be built with ``attention="ring"`` and is bound to the group);
    parameters replicated, the gradients averaged over both axes after the
    backward (one flat all-reduce per axis) and the loss too, so every rank
    holds the global batch's mean loss. The ring's P2P traffic runs on the
    sp group, the gradient reduction after the backward."""
    from ray_tpu_torch.parallel import collectives

    if model.config.attention != "ring":
        raise ValueError("build_train_step_sp needs attention='ring'")
    groups = [mesh.get_group(batch_axis), mesh.get_group(sp_axis)]
    n = math.prod(collectives._size(g) for g in groups)
    model.set_sp_group(groups[1])
    params = list(model.parameters())
    dims = {batch_axis: 0, sp_axis: 1}

    def local_loss(m, batch):
        return loss_fn(m, _mesh_block(mesh, dims, batch,
                                      ("input_ids", "labels")))

    step = in_place_step(
        model, optimizer, local_loss, donate,
        grad_sync=lambda: collectives.psum_tensors_(_grads(params), groups,
                                                    scale=1.0 / n))

    def sp_step(step_model, step_optimizer, batch):
        step_model, step_optimizer, loss = step(step_model, step_optimizer,
                                                batch)
        for g in groups:
            loss = collectives.pmean(loss, g) if collectives._size(g) > 1 \
                else loss
        return step_model, step_optimizer, loss

    return sp_step


def shard_params_tp(model: GPT2, mesh=None, model_axis: str = "model"
                    ) -> Dict[str, str]:
    """Megatron-style tensor parallelism as a per-parameter plan ({name:
    placement}, ``parallel.mesh_utils.TP_PLACEMENTS``): ``c_attn`` and
    ``c_fc`` column-parallel, ``c_proj`` row-parallel with one all-reduce
    after it, embeddings, LayerNorms, the tied head and ``c_proj``'s bias
    replicated (the reference's shardings). A torch weight is (out, in), so
    the reference's ``P(None, "model")`` kernel is "col" here, a split of
    dim 0. ``c_attn`` is one fused (3C, C) weight split q|k|v: a contiguous
    split of its 3C rows would not give a rank whole heads, so it is
    "col_qkv", each of q, k and v split on its own (the reference's GSPMD
    layout computes the same function, resharding as XLA needs). With a
    ``mesh``, the heads and widths are checked against the axis's size."""
    if mesh is not None:
        n = mesh.size(mesh.mesh_dim_names.index(model_axis))
        c = model.config
        if c.n_head % n:
            raise ValueError(f"n_head={c.n_head} does not split over {n} "
                             "model shards")
    plan = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if "c_attn" in parts:
            plan[name] = "col_qkv"
        elif "c_fc" in parts:
            plan[name] = "col"
        elif "c_proj" in parts and parts[-1] == "weight":
            plan[name] = "row"
        else:
            plan[name] = "rep"
    return plan


def _slice_optimizer_state(optimizer, placements: Dict[nn.Parameter, str],
                           index: int, n: int, full_shapes) -> None:
    """Cut each parameter's optimizer state as its parameter was cut."""
    from ray_tpu_torch.parallel.mesh_utils import tp_slice

    for p, placement in placements.items():
        for k, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.shape == full_shapes[p]:
                optimizer.state[p][k] = tp_slice(v, placement, index, n)


def shard_train_state_tp(model: GPT2, optimizer: torch.optim.Optimizer,
                         mesh, model_axis: str = "model"):
    """(wrapped model, optimizer) for tensor parallelism over ``mesh``'s
    ``model_axis``: ``shard_params_tp``'s plan placed by
    ``parallel.apply_tp_plan`` (each rank keeps its part of every split
    parameter, in place; its optimizer state is cut alike), then the loss
    wrapped as ``shard_train_state`` wraps it: DDP over the mesh's data
    axes, or ``LossModel`` alone on a mesh without one. Build the step
    with ``build_train_step(model, optimizer, mesh=mesh)`` and hand it each
    rank's ``shard_batch`` block, as for DP."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    from ray_tpu_torch.parallel import mesh_utils

    if _is_wrapped(model):
        raise ValueError("shard_train_state_tp: the model is already wrapped")
    plan = shard_params_tp(model, mesh, model_axis)
    params = dict(model.named_parameters())
    full = {p: p.shape for p in params.values()}
    mesh_utils.apply_tp_plan(model, plan, mesh, model_axis)
    n = mesh.size(mesh.mesh_dim_names.index(model_axis))
    _slice_optimizer_state(optimizer, {params[k]: v for k, v in plan.items()},
                           mesh.get_local_rank(model_axis), n, full)
    loss_model = LossModel(model)
    if not mesh_utils.data_sharding(mesh):
        return loss_model, optimizer
    dev = next(model.parameters()).device
    return DDP(loss_model, process_group=_data_group(mesh),
               device_ids=[dev.index] if dev.type == "cuda" else None), \
        optimizer


class GPT2Pipeline(nn.Module):
    """GPT-2 laid out as the reference's pipeline tree: ``embed`` holds
    ``wte``, ``wpe`` and ``ln_f`` (replicated on every pipeline rank), and
    ``stages[s][j]`` is block s * n_layer/S + j. After
    ``shard_pipeline_state`` a rank keeps only its own stage's blocks (the
    other stages are empty)."""

    def __init__(self, config: GPT2Config, n_stages: int):
        super().__init__()
        if config.n_layer % n_stages:
            raise ValueError(f"n_layer={config.n_layer} not divisible by "
                             f"n_stages={n_stages}")
        if config.attention == "ring":
            raise ValueError("the pipeline runs attention='flash' or "
                             "'auto', not 'ring'")
        per = config.n_layer // n_stages
        self.config = config
        self.embed = nn.ModuleDict({
            "wte": nn.Embedding(config.vocab_size, config.n_embd),
            "wpe": nn.Embedding(config.n_positions, config.n_embd),
            "ln_f": LayerNorm(config.n_embd, config.dtype)})
        self.stages = nn.ModuleList(
            nn.ModuleList(Block(config) for _ in range(per))
            for _ in range(n_stages))

    @classmethod
    def from_gpt2(cls, model: GPT2, n_stages: int) -> "GPT2Pipeline":
        """The pipeline layout of ``model``'s own modules (no copy)."""
        with torch.device("meta"):
            pp = cls(model.config, n_stages)
        per = model.config.n_layer // n_stages
        pp.embed = nn.ModuleDict({"wte": model.wte, "wpe": model.wpe,
                                  "ln_f": model.ln_f})
        pp.stages = nn.ModuleList(
            nn.ModuleList(model.h[s * per:(s + 1) * per])
            for s in range(n_stages))
        return pp


def make_pipeline_train_state(config: GPT2Config,
                              generator: Optional[torch.Generator] = None,
                              n_stages: int = 1,
                              learning_rate: float = 3e-4,
                              weight_decay: float = 0.1,
                              device: Optional[Union[str, torch.device]] = None
                              ) -> Tuple[GPT2Pipeline, torch.optim.AdamW]:
    """(pipeline model, optimizer): the transformer blocks regrouped into
    ``n_stages`` stages (``GPT2Pipeline``), embeddings and the final
    LayerNorm replicated. Initialised from the SAME init as
    ``make_train_state``, so a PP run compares with the DP run of the same
    seed; the optimizer is ``make_optimizer``'s."""
    pp = GPT2Pipeline.from_gpt2(init_params(config, generator, device),
                                n_stages).train()
    return pp, make_optimizer(pp, learning_rate, weight_decay)


def _keep_params(optimizer: torch.optim.Optimizer, keep) -> None:
    """Drop from ``optimizer`` every parameter (and its state) not in
    ``keep``."""
    for group in optimizer.param_groups:
        group["params"] = [p for p in group["params"] if p in keep]
    for p in [p for p in optimizer.state if p not in keep]:
        del optimizer.state[p]


def shard_pipeline_state(model: GPT2Pipeline,
                         optimizer: torch.optim.Optimizer, mesh,
                         axis: str = "pipeline"):
    """(model, optimizer) with only this rank's stage: the rank at position
    s of ``axis`` keeps ``stages[s]`` and the replicated ``embed``; the
    other stages' blocks are dropped, with their optimizer state (the
    reference shards the stacked stage axis over the pipeline axis)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n != len(model.stages):
        raise ValueError(f"{len(model.stages)} stages over a pipeline axis "
                         f"of {n}")
    me = mesh.get_local_rank(axis)
    for s in range(n):
        if s != me:
            model.stages[s] = nn.ModuleList()
    _keep_params(optimizer, set(model.parameters()))
    return model, optimizer


def build_train_step_pp(model: GPT2Pipeline,
                        optimizer: torch.optim.Optimizer, mesh, *,
                        n_microbatches: int, axis: str = "pipeline",
                        batch_axis: str = "data", donate: bool = True):
    """Pipelined step ``step(model, optimizer, batch) -> (model, optimizer,
    loss)`` over a (data, pipeline) mesh, on the model and optimizer of
    ``shard_pipeline_state``.

    Each rank takes its block of the global batch (split over
    ``batch_axis``; ``input_ids``, ``labels`` and an optional ``mask``),
    embeds it as ``GPT2.forward`` does (the reference's step sums the two
    embeddings in f32 before its cast to ``dtype``: the same in f32), runs
    its OWN stage in ``parallel.pipeline_apply`` over ``n_microbatches``,
    and every rank computes the head and the loss on the replicated
    outputs (in ``loss_chunks`` chunks, as ``loss_fn``, when the config
    has them), masked to the LAST pipeline rank and normalised by the
    global token count: numerator and count are summed over (pipeline,
    data) by ``collectives.psum_replicated``, so every rank holds the one
    global loss. Gradient bookkeeping, as the reference's: stage grads
    arrive complete on their rank and are summed over data; the replicated
    ``embed`` grads are partial per rank (the tied ``wte`` is read by stage
    0's embedding and the last stage's head) and are summed over (pipeline,
    data)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.pipeline import axis_size, pipeline_apply

    c, M = model.config, n_microbatches
    pp_group = mesh.get_group(axis)
    groups = [pp_group]
    if batch_axis in mesh.mesh_dim_names:
        groups.append(mesh.get_group(batch_axis))
    S = axis_size(pp_group)
    me = dist.get_rank(pp_group)
    own = model.stages[me]
    if not len(own) or any(len(st) for s, st in enumerate(model.stages)
                           if s != me):
        raise ValueError("build_train_step_pp takes the model of "
                         "shard_pipeline_state")
    stage_params = list(own.parameters())
    embed_params = list(model.embed.parameters())

    def stage_fn(blocks, x):
        for block in blocks:
            x = block(x)
        return x

    def local_loss(m, batch):
        batch = _mesh_block(mesh, {batch_axis: 0}, batch)
        ids, labels = batch["input_ids"], batch["labels"]
        B, T = ids.shape
        if B % M:
            raise ValueError(f"batch of {B} per data shard does not split "
                             f"into {M} microbatches")
        emb = m.embed
        pos = torch.arange(T, device=ids.device)[None, :]
        x = emb["wte"](ids).to(c.dtype) + emb["wpe"](pos).to(c.dtype)
        mb = x.reshape(M, B // M, T, x.shape[-1])
        y = pipeline_apply(stage_fn, own, mb, axis_name=pp_group)
        y = emb["ln_f"](y.reshape(B, T, -1).to(c.dtype))
        mask = batch.get("mask")
        mask = torch.ones(ids.shape, device=y.device) if mask is None \
            else mask.float()
        if c.loss_chunks:
            ll_sum = chunked_ll_sum(y, emb["wte"].weight, labels, mask,
                                    c.loss_chunks)
        else:
            ll = token_log_likelihood(
                F.linear(y, emb["wte"].weight.to(c.dtype)), labels)
            ll_sum = (ll * mask).sum()
        is_last = torch.tensor(me == S - 1, device=y.device)
        numer = torch.where(is_last, -ll_sum, 0.0)
        denom = torch.where(is_last, mask.sum(), 0.0)
        for g in groups:
            numer = collectives.psum_replicated(numer, g)
            denom = collectives.psum_replicated(denom, g)
        return numer / torch.clamp(denom, min=1.0)

    def sync():
        collectives.psum_tensors_(_grads(stage_params), groups[1:])
        collectives.psum_tensors_(_grads(embed_params), groups)

    return in_place_step(model, optimizer, local_loss, donate,
                         grad_sync=sync)
