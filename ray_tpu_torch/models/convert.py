"""Weight bridge: the Flax GPT-2 parameter tree to the torch ``state_dict``.

The tree holds numpy arrays (``jax.tree.map(np.asarray, params)`` on the
JAX side), so this module needs neither JAX nor the JAX package. Dense
``kernel`` is (in, out) and becomes a Linear ``weight`` (out, in); LayerNorm
``scale`` becomes ``weight``; Embed ``embedding`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _get(tree: Mapping[str, Any], path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict for ``ray_tpu_torch.models.gpt2.GPT2`` from a Flax tree of
    numpy arrays; raises KeyError on a missing leaf."""
    n_layer = sum(1 for k in tree if k.startswith("h_"))
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(tree["wte"]["embedding"]),
        "wpe.weight": _t(tree["wpe"]["embedding"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    for i in range(n_layer):
        blk = tree[f"h_{i}"]
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = _t(blk[ln]["scale"])
            sd[f"h.{i}.{ln}.bias"] = _t(blk[ln]["bias"])
        for path in _DENSE:
            dense = _get(blk, path)
            name = f"h.{i}." + path.replace("/", ".")
            sd[f"{name}.weight"] = _t(dense["kernel"]).T.contiguous()
            sd[f"{name}.bias"] = _t(dense["bias"])
    return sd
