"""Switch-MoE LM runs for ``chip_smoke.py``: training steps, one step's
gradients, the share of tokens each MoE block drops, and the reference's
one-hot dispatch in place of the path's index dispatch.

Each function takes a config and a device, so the same code runs at full
width on the card (``chip_smoke.py``) and at ``small_test`` size on the CPU
(``tests/test_torch_moe_lm.py``). Weights come from seed 0, drawn on the
CPU. ``train_runs.plain_attention`` routes the model's flash-attention calls
to the kernels' plain version; ``one_hot_dispatch`` routes its MoE blocks to
``moe.moe_ffn_dense``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from ray_tpu_torch.models import moe_lm
from ray_tpu_torch.ops import moe


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state(cfg: moe_lm.MoELMConfig, device, learning_rate: float = 3e-4):
    """(model, optimizer, step) from weights of seed 0 on ``device``."""
    model, optimizer = moe_lm.make_train_state(
        cfg, torch.Generator().manual_seed(0), learning_rate, device=device)
    return model, optimizer, moe_lm.build_train_step(model, optimizer)


def train(cfg: moe_lm.MoELMConfig, batch: Dict[str, torch.Tensor],
          steps: int, device, learning_rate: float = 3e-4,
          counts=None) -> Dict[str, object]:
    """``steps`` AdamW steps on one batch from weights of seed 0: each
    step's loss, lm and aux, its ms on the host clock to a sync, and each
    MoE block's share of dropped tokens on the batch before the first step
    and after the last. ``counts`` = (zero, read) brackets the steps alone:
    ``zero()`` just before the first, ``read()`` just after the last, its
    result returned as ``launches``."""
    device = torch.device(device)
    model, optimizer, step = state(cfg, device, learning_rate)
    start = drop_shares(model, batch)
    run = {"losses": [], "lm": [], "aux": [], "step_ms": []}
    if counts is not None:
        counts[0]()
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        model, optimizer, loss, lm, aux = step(model, optimizer, batch)
        _sync(device)
        run["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, value in (("losses", loss), ("lm", lm), ("aux", aux)):
            run[key].append(float(value))
    if counts is not None:
        run["launches"] = counts[1]()
    run["drop_shares"] = {"start": start, "end": drop_shares(model, batch)}
    run["params"] = sum(p.numel() for p in model.parameters())
    del model, optimizer, step
    return run


def step_grads(cfg: moe_lm.MoELMConfig, batch: Dict[str, torch.Tensor],
               device) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, {parameter name: gradient}) of one step on ``batch`` from the
    seeded weights."""
    model, optimizer, step = state(cfg, torch.device(device))
    _, _, loss, _, _ = step(model, optimizer, batch)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model, optimizer, step
    return float(loss), grads


@contextlib.contextmanager
def one_hot_dispatch():
    """Route the MoE blocks to the reference's dense (T, E, C) one-hot
    dispatch and combine (``moe.moe_ffn_dense``), the plain version of the
    index dispatch."""
    index_path = moe.moe_ffn
    moe.moe_ffn = moe.moe_ffn_dense
    try:
        yield
    finally:
        moe.moe_ffn = index_path


def drop_shares(model: moe_lm.MoELM, batch: Dict[str, torch.Tensor]
                ) -> List[float]:
    """Each MoE block's share of the batch's tokens that its experts'
    capacity drops, in block order, from one forward without gradients."""
    shares: List[float] = []
    index_path = moe.moe_ffn

    def recording(params, x, capacity_factor):
        E = params["router"].shape[1]
        capacity = moe.expert_capacity(x.shape[0], E, capacity_factor)
        keep = moe.route(x @ params["router"], capacity)[2]
        shares.append(1.0 - float(keep.sum()) / x.shape[0])
        return index_path(params, x, capacity_factor)

    moe.moe_ffn = recording
    try:
        with torch.inference_mode():
            model(batch["input_ids"])
    finally:
        moe.moe_ffn = index_path
    return shares
