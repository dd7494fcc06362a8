"""ray_tpu_torch.ops — hand-written Hopper kernels with their plain versions."""

from ray_tpu_torch.ops.attention import (
    attention_reference,
    finalize_flash,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    online_block_update,
)

__all__ = [
    "attention_reference",
    "finalize_flash",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "online_block_update",
]
