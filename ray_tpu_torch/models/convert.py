"""Weight bridge: the Flax GPT-2 parameter tree to the torch ``state_dict``,
and optax's AdamW state to torch's.

The trees hold numpy arrays (``jax.tree.map(np.asarray, tree)`` on the JAX
side), so this module needs neither JAX nor the JAX package. Dense
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


def opt_state_from_jax(opt_state_tree, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer) -> None:
    """Load optax's adamw state into ``optimizer`` (a ``torch.optim.AdamW``
    over ``model``'s parameters), so a JAX train state resumes in the port.

    ``opt_state_tree`` is the optax state with numpy leaves, the tuple of
    ``optax.adamw``'s chain; its ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) becomes each parameter's ``step``, ``exp_avg`` and
    ``exp_avg_sq``, with the moments laid out as ``params_from_jax`` lays
    out the parameters (Dense kernels transposed).
    Raises ValueError without an Adam state and KeyError on a missing leaf."""
    adam = next((s for s in opt_state_tree
                 if all(hasattr(s, f) for f in ("count", "mu", "nu"))), None)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    count = float(np.asarray(adam.count))
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    index = {id(p): name for name, p in model.named_parameters()}
    # a state dict numbers the parameters in param-group order; loading it
    # moves the moments to each parameter's device and dtype
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, p in enumerate(params):
        name = index[id(p)]
        state[i] = {"step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"]})
