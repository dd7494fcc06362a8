"""Llama runs for ``chip_smoke.py``: serving through ``generate`` and its
decode steps, the kernel path against the plain attention on the same
weights, and a few training steps.

Each function takes a model or a config and a device, so the same code
runs at full width on the card (``chip_smoke.py``) and at ``small_test``
size on the CPU (``tests/test_torch_llama.py``). ``plain_attention`` (from
``train_runs``) routes the model's flash-attention calls to the kernels'
plain version; on CPU tensors both paths are the plain version.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.tools.train_runs import (
    capture_attention,
    grad_rel_errs,
    plain_attention,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompts(seed: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """(batch, length) random token ids from numpy ``seed``."""
    ids = np.random.default_rng(seed).integers(0, vocab, size=(batch, length))
    return torch.from_numpy(ids).to(device)


def teacher_forced_logits(model: llama.Llama, tokens: torch.Tensor,
                          prompt_len: int) -> List[torch.Tensor]:
    """The logits ``generate`` reads, with ``tokens`` (B, S) fed in: the
    prefill's last position over ``tokens[:, :prompt_len]``, then one decode
    step per later token but the last; S - prompt_len tensors (B, vocab)."""
    B, S = tokens.shape
    caches = llama.init_kv_caches(model.config, B, S,
                                  device=tokens.device)
    logits, caches = llama._prefill(model, tokens[:, :prompt_len], caches)
    out = [logits]
    index = torch.tensor(prompt_len, device=tokens.device)
    for t in range(prompt_len, S - 1):
        logits, caches = llama._decode_step(model, tokens[:, t:t + 1], index,
                                            caches)
        index += 1
        out.append(logits)
    return out


def teacher_forced_logits_both(model: llama.Llama, tokens: torch.Tensor,
                               prompt_len: int
                               ) -> Tuple[List[torch.Tensor],
                                          List[torch.Tensor]]:
    """``teacher_forced_logits`` through the kernels, then through the
    plain attention, on the same weights and tokens."""
    kernel = teacher_forced_logits(model, tokens, prompt_len)
    with plain_attention():
        plain = teacher_forced_logits(model, tokens, prompt_len)
    return kernel, plain


def logit_errors(got: List[torch.Tensor], want: List[torch.Tensor]
                 ) -> Dict[str, float]:
    """Over all steps: the largest |got - want|, the same over the largest
    |want|, and ||got - want|| / ||want||, in f32."""
    g = torch.stack([x.float() for x in got])
    w = torch.stack([x.float() for x in want])
    err = (g - w).abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_to_max": float(err.max() / w.abs().max()),
            "rel_norm": float((g - w).norm() / w.norm())}


def attention_inputs(model: llama.Llama, tokens: torch.Tensor,
                     prompt_len: int, layers: Sequence[int]
                     ) -> List[Tuple[str, Tuple[torch.Tensor, ...], dict]]:
    """The inputs the model hands flash attention at ``layers`` during
    the prefill of ``tokens[:, :prompt_len]`` and during the decode step of
    the token at ``prompt_len``: (label, (q, k, v) folded to (B*H, S, D) as
    the kernel takes them, the call's keywords: ``causal`` and the live
    length ``k_len``)."""
    B, S = tokens.shape
    device = tokens.device
    caches = llama.init_kv_caches(model.config, B, S, device=device)
    with capture_attention(layers) as prefill:
        llama._prefill(model, tokens[:, :prompt_len], caches)
    with capture_attention(layers) as decode:
        llama._decode_step(model, tokens[:, prompt_len:prompt_len + 1],
                           torch.tensor(prompt_len, device=device), caches)
    return [(f"{step} layer {i}", *calls[i])
            for step, calls in (("prefill", prefill), ("decode", decode))
            for i in layers]


def decode_equals_full_pass(model: llama.Llama, ids: torch.Tensor) -> float:
    """The full causal pass's last logits against a step-by-step decode of
    ``ids`` from empty caches: max |difference| over max |full|."""
    B, T = ids.shape
    with torch.inference_mode():
        full, _ = model(ids)
        caches = llama.init_kv_caches(model.config, B, T, device=ids.device)
        for t in range(T):
            logits, caches = llama._decode_step(model, ids[:, t:t + 1], t,
                                                caches)
        full = full[:, -1].float()
        return float((logits.float() - full).abs().max() / full.abs().max())


def time_generate(model: llama.Llama, prompt_ids: torch.Tensor,
                  new_tokens: int) -> Tuple[torch.Tensor, float]:
    """(tokens, seconds) of one ``generate`` call, host clock to a sync."""
    _sync(prompt_ids.device)
    t0 = time.perf_counter()
    tokens = llama.generate(model, prompt_ids, new_tokens)
    _sync(prompt_ids.device)
    return tokens, time.perf_counter() - t0


def time_steps(model: llama.Llama, tokens: torch.Tensor, prompt_len: int,
               counts: Optional[Tuple[Callable[[], None],
                                      Callable[[], dict]]] = None
               ) -> Dict[str, object]:
    """The steps of ``generate`` again on the tokens it produced: the
    prefill of ``tokens[:, :prompt_len]`` (host clock to a sync), then one
    decode step per later token but the last, at a device index advanced in
    place, with one sync after the last (so the host runs ahead as in
    ``generate``). ``counts``, a pair of
    functions (zero, read) of the kernels' launch counts, adds the launches
    of the prefill and of the decode steps, each zeroed just before and
    read just after, outside the timed spans."""
    zero, read = counts or (lambda: None, lambda: None)
    device = tokens.device
    B, S = tokens.shape
    caches = llama.init_kv_caches(model.config, B, S, device=device)
    tp_group = model.h[0].attn.k_proj.tp_group
    if tp_group is not None:  # as ``generate`` splits them
        caches = llama.shard_kv_caches_tp(caches, tp_group)
    _sync(device)
    zero()
    t0 = time.perf_counter()
    _, caches = llama._prefill(model, tokens[:, :prompt_len], caches)
    _sync(device)
    t1 = time.perf_counter()
    prefill_launches = read()
    index = torch.tensor(prompt_len, device=device)
    zero()
    t2 = time.perf_counter()
    for t in range(prompt_len, S - 1):
        _, caches = llama._decode_step(model, tokens[:, t:t + 1], index,
                                       caches)
        index += 1
    _sync(device)
    t3 = time.perf_counter()
    decode_launches = read()
    steps = S - 1 - prompt_len
    out = {"prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_token": (t3 - t2) / max(steps, 1) * 1e3,
           "decode_steps": steps}
    if counts is not None:
        out.update(prefill_launches=prefill_launches,
                   decode_launches=decode_launches)
    return out


def _model(cfg: llama.LlamaConfig, device, seed: int = 0) -> llama.Llama:
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama.init_params(cfg, gen, device=device)


def train(cfg: llama.LlamaConfig, batch: Dict[str, torch.Tensor],
          steps: int, device) -> Dict[str, List[float]]:
    """``steps`` AdamW steps (``gpt2.make_optimizer``: lr 3e-4, betas 0.9,
    0.95, weight decay 0.1) on one batch from weights of seed 0: each
    step's loss and its ms on the host clock to a sync."""
    device = torch.device(device)
    model = _model(cfg, device).train()
    optimizer = gpt2.make_optimizer(model)
    step = llama.build_train_step(model, optimizer)
    losses, step_ms = [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        model, optimizer, loss = step(model, optimizer, batch)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    del model, optimizer, step
    return {"losses": losses, "step_ms": step_ms}


def grads_both(cfg: llama.LlamaConfig, batch: Dict[str, torch.Tensor],
               device) -> Dict[str, object]:
    """One batch's gradients from weights of seed 0 through the kernels and
    through the plain attention: ``grad_rel_errs`` of the first against
    the second, and both losses."""
    model = _model(cfg, torch.device(device)).train()
    runs = []
    for path in (contextlib.nullcontext, plain_attention):
        model.zero_grad(set_to_none=True)
        with path():
            loss = llama.loss_fn(model, batch)
        loss.backward()
        runs.append((float(loss.detach()),
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    (kloss, kgrads), (ploss, pgrads) = runs
    del model, runs
    return {"loss_kernel": kloss, "loss_plain": ploss,
            **grad_rel_errs(kgrads, pgrads)}
