"""ray_tpu_torch.ops — hand-written Hopper kernels with their plain versions."""

from ray_tpu_torch.ops.attention import (
    attention_reference,
    finalize_flash,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    online_block_update,
)
from ray_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_self_attention,
)

__all__ = [
    "attention_reference",
    "finalize_flash",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "online_block_update",
    "ring_attention",
    "ring_self_attention",
]
