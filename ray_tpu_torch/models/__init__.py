"""ray_tpu_torch.models — model families ported to PyTorch."""

from ray_tpu_torch.models import gpt2, llama, moe_lm, vision
from ray_tpu_torch.models.convert import (
    llama_opt_state_from_jax,
    llama_params_from_jax,
    moe_lm_opt_state_from_jax,
    moe_lm_params_from_jax,
    opt_state_from_jax,
    params_from_jax,
    vision_opt_state_from_jax,
    vision_params_from_jax,
)
from ray_tpu_torch.models.gpt2 import (
    build_train_step,
    chunked_xent_tied,
    loss_fn,
    make_optimizer,
    make_train_state,
)

__all__ = [
    "build_train_step",
    "chunked_xent_tied",
    "gpt2",
    "llama",
    "llama_opt_state_from_jax",
    "llama_params_from_jax",
    "loss_fn",
    "make_optimizer",
    "make_train_state",
    "moe_lm",
    "moe_lm_opt_state_from_jax",
    "moe_lm_params_from_jax",
    "opt_state_from_jax",
    "params_from_jax",
    "vision",
    "vision_opt_state_from_jax",
    "vision_params_from_jax",
]
