from ray_tpu_torch.ops.attention import (
    flash_attention,
    flash_backward_reference,
    flash_forward_reference,
    mha_reference,
    ring_attention,
    ulysses_attention,
)
from ray_tpu_torch.ops.paged_attention import (
    PageAllocator,
    launch_counts,
    paged_decode_attention,
    paged_decode_attention_batch,
    reset_launch_counts,
)

__all__ = ["flash_attention",
           "flash_backward_reference", "flash_forward_reference",
           "mha_reference", "ring_attention", "ulysses_attention",
           "PageAllocator", "launch_counts", "paged_decode_attention",
           "paged_decode_attention_batch", "reset_launch_counts"]
