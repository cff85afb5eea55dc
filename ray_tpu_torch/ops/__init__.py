from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.ops.paged_attention import (
    PageAllocator,
    launch_counts,
    paged_decode_attention,
    paged_decode_attention_batch,
    reset_launch_counts,
)

__all__ = ["mha_reference", "PageAllocator", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_batch",
           "reset_launch_counts"]
