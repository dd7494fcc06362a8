"""GPT-2-124M runs on the card, shared by ``chip_smoke.py`` and
``tools/fwd_ab.py`` so that both time and check one and the same path.

``train_bf16`` is the training path of ``chip_smoke.py`` phase 8: full
width, bf16 compute over f32 weights, ``loss_chunks=8``, AdamW, weights from
seed 0, one fixed batch of 16 x 1024 from seed 1, 3 warm-up and 10 timed
steps. ``step_grads`` is one step of a configuration from the same seeded
weights, and ``plain_attention`` routes the model's flash-attention calls to
the kernels' plain version, so the two paths can be compared on one set of
weights. Each runs with whatever kernel libraries ``ops.attention`` has
loaded.
"""

from __future__ import annotations

import contextlib
import functools
import statistics
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ray_tpu_torch.models import gpt2

BATCH, SEQ, WARMUP, TIMED = 16, 1024, 3, 10


def bf16_config() -> gpt2.GPT2Config:
    """The training path's configuration (``bench.py``'s first flash one)."""
    return gpt2.GPT2Config.gpt2_124m(attention="flash", loss_chunks=8)


@contextlib.contextmanager
def plain_attention():
    """Route the model's flash-attention calls to the kernel's plain
    version (f32 math on the same inputs, same output dtype)."""
    import ray_tpu_torch.ops as ops

    kernel_path = ops.flash_attention
    ops.flash_attention = functools.partial(kernel_path, impl="plain")
    try:
        yield
    finally:
        ops.flash_attention = kernel_path


@contextlib.contextmanager
def capture_attention(calls: Sequence[int]):
    """Record what the model hands flash attention: yields a dict that
    fills, for each call number in ``calls`` (counted from 0 in the order
    the calls are made, one per layer in a forward), with (q, k, v) folded
    to (B*H, S, D) as the kernel takes them (copies) and the call's
    keywords. The calls still run the kernel path."""
    import ray_tpu_torch.ops as ops

    kernel_path = ops.flash_attention
    seen: Dict[int, Tuple[Tuple[torch.Tensor, ...], dict]] = {}
    count = 0

    def recording(q, k, v, **kw):
        nonlocal count
        if count in calls:
            fold = lambda t: t.detach().reshape(-1, *t.shape[-2:]).clone(
                memory_format=torch.contiguous_format)
            seen[count] = (tuple(fold(t) for t in (q, k, v)), kw)
        count += 1
        return kernel_path(q, k, v, **kw)

    ops.flash_attention = recording
    try:
        yield seen
    finally:
        ops.flash_attention = kernel_path


def _state(cfg):
    model, optimizer = gpt2.make_train_state(
        cfg, torch.Generator().manual_seed(0))
    return model, optimizer, gpt2.build_train_step(model, optimizer)


def train_bf16(warmup: int = WARMUP, timed: int = TIMED
               ) -> Tuple[List[float], float]:
    """(the losses of all steps, ms per step over the timed steps)."""
    cfg = bf16_config()
    model, optimizer, step = _state(cfg)
    batch = gpt2.synthetic_batch(1, BATCH, SEQ, cfg.vocab_size)
    losses = []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        model, optimizer, loss = step(model, optimizer, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    del model, optimizer, step, batch
    torch.cuda.empty_cache()
    return [float(x) for x in losses], step_ms


def step_grads(cfg: gpt2.GPT2Config, batch: Dict[str, torch.Tensor]
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {parameter name: gradient}) of one step on ``batch`` from the
    seeded weights."""
    model, optimizer, step = _state(cfg)
    _, _, loss = step(model, optimizer, batch)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, optimizer, step
    torch.cuda.empty_cache()
    return float(loss), grads


def grad_rel_errs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                  ) -> Dict[str, object]:
    """Per parameter ||got - want|| / ||want||: the worst leaf, its error
    and the median over all leaves."""
    rel = {n: float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
           for n in want}
    worst = max(rel, key=rel.get)
    return {"worst_leaf": worst, "worst": rel[worst],
            "median": statistics.median(rel.values())}
