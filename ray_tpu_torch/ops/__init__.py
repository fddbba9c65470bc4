"""ray_tpu_torch.ops: attention, ring attention, RoPE and the hand-written CUDA
kernels."""

from ray_tpu_torch.ops.attention import (
    blockwise_attention,
    dot_product_attention,
    reference_attention,
)
from ray_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
)
from ray_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded

__all__ = [
    "blockwise_attention",
    "dot_product_attention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "reference_attention",
    "ring_attention",
    "ring_attention_sharded",
]
