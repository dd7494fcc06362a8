"""ViT and ResNet runs for ``chip_smoke.py``: a few training steps, the
kernel path against the plain attention on the same weights, and the
inputs the model hands flash attention.

Each function takes a config or a model and a device, so the same code
runs at full width on the card (``chip_smoke.py``) and at ``small_test``
size on the CPU (``tests/test_torch_vision.py``). ``plain_attention``
(from ``train_runs``) routes the model's flash-attention calls to the
kernels' plain version; on CPU tensors both paths are the plain version.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

from ray_tpu_torch.models import vision
from ray_tpu_torch.tools.train_runs import capture_attention, plain_attention


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model(cfg: vision.VisionConfig, device, seed: int = 0
          ) -> vision.VisionModel:
    """Fresh weights of ``seed`` (drawn on the CPU) on ``device``."""
    return vision.init_params(cfg, torch.Generator().manual_seed(seed),
                              device=device)


def train(cfg: vision.VisionConfig, batch: Dict[str, torch.Tensor],
          steps: int, device, learning_rate: float = 1e-3
          ) -> Dict[str, List[float]]:
    """``steps`` steps of ``make_train_state``'s AdamW (the reference's
    ``optax.adamw(learning_rate)``) on one batch from weights of seed 0:
    each step's loss and its ms on the host clock to a sync."""
    device = torch.device(device)
    net, optimizer = vision.make_train_state(
        cfg, torch.Generator().manual_seed(0), learning_rate, device=device)
    step = vision.build_train_step(net, optimizer)
    losses, step_ms = [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        net, optimizer, loss = step(net, optimizer, batch)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    del net, optimizer, step
    return {"losses": losses, "step_ms": step_ms}


def logits_both(net: vision.VisionModel, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logits through the kernels, then through the plain attention,
    on the same weights and images (no gradients)."""
    with torch.inference_mode():
        kernel = net(images)
        with plain_attention():
            plain = net(images)
    return kernel, plain


def attention_inputs(net: vision.ViT, images: torch.Tensor,
                     layers: Sequence[int]
                     ) -> List[Tuple[str, Tuple[torch.Tensor, ...], dict]]:
    """The inputs a ViT's forward on ``images`` hands flash attention at
    ``layers``: (label, (q, k, v) folded to (B*H, S, D) as the kernel takes
    them, the call's keywords)."""
    with torch.inference_mode(), capture_attention(layers) as calls:
        net(images)
    return [(f"forward layer {i}", *calls[i]) for i in layers]
