"""Models the serving engine drives: synthetic for CPU CI, GPT-2 on the card.

``SyntheticLLM`` is the reference's LLM-shaped prefill+decode function:
each token's KV vector is a deterministic function of (token, position),
and each decoded token is a deterministic function of the KV CONTENTS the
sequence's block table points at, so prefix-cache correctness is
assertable. Its outputs equal ``ray_tpu``'s token for token.

``GPT2LLM`` runs ``ray_tpu_torch.models.gpt2`` with greedy decode by full
re-forward per step, exactly as the reference adapter does (no KV
threading into the model yet). With ``attention="flash"`` on a CUDA device
every forward runs the flash-attention kernel once per layer.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device

VOCAB = 50_257  # gpt2-sized token space


def _record_kv_vec(token: int, pos: int, kv_dim: int) -> np.ndarray:
    base = (int(token) * 2654435761 + pos * 40503) & 0xFFFFFFFF
    idx = np.arange(kv_dim, dtype=np.float32)
    return ((base % 977) / 977.0 + idx * 1e-3).astype(np.float32)


class SyntheticLLM:
    """Deterministic prefill/decode over externally-paged KV."""

    def __init__(self, kv_dim: int = 64, step_delay_s: float = 0.0):
        self.kv_dim = int(kv_dim)
        self.step_delay_s = float(step_delay_s)
        # fixed projection the KV "content hash" is read through, so the
        # next-token function depends on every float of every page
        rng = np.random.default_rng(1234)
        self._probe = rng.standard_normal(self.kv_dim).astype(np.float32)

    def kv_vec(self, token: int, pos: int) -> np.ndarray:
        """KV for one (token, position): position-mixed so reusing a page
        at the wrong depth corrupts the output (which a test would catch)."""
        return _record_kv_vec(token, pos, self.kv_dim)

    def step_cost(self, batch_size: int):
        """One decode step's forward pass for the whole running batch."""
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)

    def next_token(self, kv_views: Sequence[np.ndarray], n_tokens: int,
                   tokens=None) -> int:
        """Greedy 'sampling': a hash of the attended KV state (``tokens`` is
        ignored). Reads the actual page bytes, so stale/corrupt/missing
        pages change the output."""
        acc = 0.0
        for v in kv_views:
            acc += float(np.dot(v.reshape(-1, self.kv_dim).sum(axis=0),
                                self._probe))
        return int(abs(int(acc * 1e4)) + n_tokens * 31) % VOCAB


class GPT2LLM:
    """GPT-2 adapter: greedy decode by full re-forward per step.

    ``config_kwargs`` override ``GPT2Config.small_test`` (as in the
    reference), so full GPT-2-124M width is ``vocab_size=50257,
    n_positions=1024, n_embd=768, n_layer=12, n_head=12``. Weights come
    from ``torch.Generator().manual_seed(seed)``, or from a Flax tree via
    ``load_params``."""

    def __init__(self, device=None, seed: int = 0, step_delay_s: float = 0.0,
                 **config_kwargs):
        from ray_tpu_torch.models import gpt2

        self.device = resolve_device(device)
        self.config = gpt2.GPT2Config.small_test(**config_kwargs)
        self.model = gpt2.init_params(
            self.config, torch.Generator().manual_seed(seed),
            device=self.device).eval()
        self.kv_dim = self.config.n_embd
        self.step_delay_s = float(step_delay_s)
        self.forwards = 0  # full forward passes run (one per decoded token)

    def load_params(self, tree: Mapping[str, Any]):
        """Load a Flax GPT-2 parameter tree of numpy arrays."""
        from ray_tpu_torch.models.convert import params_from_jax

        self.model.load_state_dict(params_from_jax(tree))

    def kv_vec(self, token: int, pos: int) -> np.ndarray:
        # the adapter does not thread external KV into the model yet; pages
        # still hold a deterministic per-token record so paging and prefix
        # reuse exercise the same machinery
        return _record_kv_vec(token, pos, self.kv_dim)

    def step_cost(self, batch_size: int):
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)

    def logits(self, tokens: List[int]) -> torch.Tensor:
        """(T, vocab) logits of one sequence."""
        with torch.inference_mode():
            ids = torch.tensor([tokens], dtype=torch.long, device=self.device)
            out = self.model(ids)[0]
        self.forwards += 1
        return out

    def forward_next(self, tokens: List[int]) -> int:
        return int(torch.argmax(self.logits(list(tokens))[-1]))

    def next_token(self, kv_views, n_tokens: int, tokens=None) -> int:
        if tokens is None:
            raise ValueError("GPT2LLM.next_token needs the sequence's tokens")
        return self.forward_next(list(tokens))


def load_model(kv_dim: int = 64, step_delay_s: float = 0.0,
               real_model: bool = False, device=None,
               model_kwargs: Optional[Dict[str, Any]] = None):
    """Model factory the server uses: synthetic unless ``real_model``. A
    real model that cannot be built raises; nothing falls back to the
    synthetic one."""
    if real_model:
        return GPT2LLM(device=device, step_delay_s=step_delay_s,
                       **(model_kwargs or {}))
    return SyntheticLLM(kv_dim=kv_dim, step_delay_s=step_delay_s)
