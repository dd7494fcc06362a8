"""ray_tpu_torch.models — model families ported to PyTorch."""

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import params_from_jax

__all__ = ["gpt2", "params_from_jax"]
