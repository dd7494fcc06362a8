"""Weight bridge: the Flax GPT-2, Llama, ViT, ResNet and Switch-MoE LM
parameter trees to the torch ``state_dict``s, and optax's AdamW state to
torch's.

The trees hold numpy arrays (``jax.tree.map(np.asarray, tree)`` on the JAX
side), so this module needs neither JAX nor the JAX package. Dense
``kernel`` is (in, out) and becomes a Linear ``weight`` (out, in); Conv
``kernel`` is HWIO and becomes a Conv2d ``weight`` OIHW; LayerNorm and
GroupNorm ``scale`` become ``weight``; Embed ``embedding`` becomes
``weight``. The MoE router and stacked expert weights keep their layout.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")
_LLAMA_DENSE = ("attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj",
                "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")


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
    return _gpt2_blocks(tree, lambda i: False)


def moe_lm_params_from_jax(tree: Mapping[str, Any], moe_every: int
                           ) -> Dict[str, torch.Tensor]:
    """State dict for ``ray_tpu_torch.models.moe_lm.MoELM`` from a Flax tree
    of numpy arrays: block ``h_i`` is an MoE block when ``(i + 1) %
    moe_every == 0`` (its ``router`` (D, E), ``wi`` (E, D, 4D) and ``wo``
    (E, 4D, D) cross as they are), else GPT-2's; raises KeyError on a
    missing leaf."""
    return _gpt2_blocks(tree, lambda i: (i + 1) % moe_every == 0)


def _gpt2_blocks(tree, is_moe) -> Dict[str, torch.Tensor]:
    n_layer = sum(1 for k in tree if k.startswith("h_"))
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(tree["wte"]["embedding"]),
        "wpe.weight": _t(tree["wpe"]["embedding"]),
    }
    _norm(sd, "ln_f", tree["ln_f"])
    for i in range(n_layer):
        blk, name = tree[f"h_{i}"], f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            _norm(sd, f"{name}.{ln}", blk[ln])
        moe = is_moe(i)
        for path in _DENSE[:2] if moe else _DENSE:
            _dense(sd, f"{name}." + path.replace("/", "."), _get(blk, path))
        if moe:
            for leaf in ("router", "wi", "wo"):
                sd[f"{name}.{leaf}"] = _t(blk[leaf])
    return sd


def llama_params_from_jax(tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """State dict for ``ray_tpu_torch.models.llama.Llama`` from a Flax tree
    of numpy arrays; raises KeyError on a missing leaf."""
    n_layer = sum(1 for k in tree if k.startswith("h_"))
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(tree["embed"]["embedding"]),
        "norm.weight": _t(tree["norm"]["scale"]),
        "lm_head.weight": _t(tree["lm_head"]["kernel"]).T.contiguous(),
    }
    for i in range(n_layer):
        blk = tree[f"h_{i}"]
        for norm in ("input_norm", "post_attn_norm"):
            sd[f"h.{i}.{norm}.weight"] = _t(blk[norm]["scale"])
        for path in _LLAMA_DENSE:
            name = f"h.{i}." + path.replace("/", ".")
            sd[f"{name}.weight"] = _t(_get(blk, path)["kernel"]).T.contiguous()
    return sd


def _dense(sd, name, leaf):
    sd[f"{name}.weight"] = _t(leaf["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _t(leaf["bias"])


def _conv(sd, name, leaf, bias: bool = False):
    sd[f"{name}.weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
    if bias:
        sd[f"{name}.bias"] = _t(leaf["bias"])


def _norm(sd, name, leaf):
    sd[f"{name}.weight"] = _t(leaf["scale"])
    sd[f"{name}.bias"] = _t(leaf["bias"])


def vision_params_from_jax(tree: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """State dict for ``ray_tpu_torch.models.vision.ViT`` (a tree with
    ``patch_embed``) or ``ResNet`` from a Flax tree of numpy arrays, under
    the names Flax generated (``h_i/LayerNorm_0``, ``Dense_0``,
    ``ResNetBlock_i/Conv_k``, ``GroupNorm_k``, ``shortcut``, ...); raises
    KeyError on a missing leaf."""
    sd: Dict[str, torch.Tensor] = {}
    if "patch_embed" in tree:
        _conv(sd, "patch_embed", tree["patch_embed"], bias=True)
        sd["cls"] = _t(tree["cls"])
        sd["pos_embed"] = _t(tree["pos_embed"])
        for i in range(sum(1 for k in tree if k.startswith("h_"))):
            blk, name = tree[f"h_{i}"], f"h.{i}"
            _norm(sd, f"{name}.norm1", blk["LayerNorm_0"])
            _dense(sd, f"{name}.qkv", blk["qkv"])
            _dense(sd, f"{name}.proj", blk["proj"])
            _norm(sd, f"{name}.norm2", blk["LayerNorm_1"])
            _dense(sd, f"{name}.fc1", blk["Dense_0"])
            _dense(sd, f"{name}.fc2", blk["Dense_1"])
        _norm(sd, "ln_f", tree["ln_f"])
    else:
        _conv(sd, "stem", tree["stem"])
        _norm(sd, "stem_norm", tree["GroupNorm_0"])
        for i in range(sum(1 for k in tree if k.startswith("ResNetBlock_"))):
            blk, name = tree[f"ResNetBlock_{i}"], f"blocks.{i}"
            for k in range(3):
                _conv(sd, f"{name}.conv{k + 1}", blk[f"Conv_{k}"])
                _norm(sd, f"{name}.norm{k + 1}", blk[f"GroupNorm_{k}"])
            if "shortcut" in blk or "shortcut_norm" in blk:
                _conv(sd, f"{name}.shortcut", blk["shortcut"])
                _norm(sd, f"{name}.shortcut_norm", blk["shortcut_norm"])
    _dense(sd, "head", tree["head"])
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
    _load_adam(opt_state_tree, model, optimizer, params_from_jax)


def llama_opt_state_from_jax(opt_state_tree, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """``opt_state_from_jax`` for a Llama: the moments laid out as
    ``llama_params_from_jax`` lays out the parameters."""
    _load_adam(opt_state_tree, model, optimizer, llama_params_from_jax)


def vision_opt_state_from_jax(opt_state_tree, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> None:
    """``opt_state_from_jax`` for a ViT or ResNet: the moments laid out as
    ``vision_params_from_jax`` lays out the parameters."""
    _load_adam(opt_state_tree, model, optimizer, vision_params_from_jax)


def moe_lm_opt_state_from_jax(opt_state_tree, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> None:
    """``opt_state_from_jax`` for an MoE LM: the moments laid out as
    ``moe_lm_params_from_jax`` lays out the parameters, with the model's
    ``config.moe_every``."""
    _load_adam(opt_state_tree, model, optimizer, functools.partial(
        moe_lm_params_from_jax, moe_every=model.config.moe_every))


def _load_adam(opt_state_tree, model, optimizer, convert) -> None:
    adam = next((s for s in opt_state_tree
                 if all(hasattr(s, f) for f in ("count", "mu", "nu"))), None)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    count = float(np.asarray(adam.count))
    mu, nu = convert(adam.mu), convert(adam.nu)
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
