"""Entry point: the flagship model's forward on the card.

Counterpart of ``__graft_entry__.entry()``: GPT-2-124M (n_positions 1024,
``attention="flash"``, so every layer runs the sm_90a flash kernel) and a
(2, 256) batch of random token ids, on the CUDA device unless ``device``
says otherwise.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.device import resolve_device


def entry(device=None):
    """Returns ``(forward, (model, batch))``; ``forward(model, batch)``
    gives the (2, 256, 50257) logits. Raises without a CUDA device unless
    ``device`` is given."""
    from ray_tpu_torch.models import gpt2

    dev = resolve_device(device)
    config = gpt2.GPT2Config.gpt2_124m(n_positions=1024, attention="flash")
    model = gpt2.init_params(config, torch.Generator().manual_seed(0),
                             device=dev).eval()
    batch = gpt2.synthetic_batch(1, 2, 256, config.vocab_size,
                                 device=dev)["input_ids"]

    def forward(model, input_ids):
        with torch.inference_mode():
            return model(input_ids)

    return forward, (model, batch)
