from ray_tpu_torch.models.convert import init_params, params_from_flax
from ray_tpu_torch.models.generate import Generator, SamplingParams
from ray_tpu_torch.models.llama import (
    LLAMA2_7B,
    LLAMA2_13B,
    LLAMA3_8B,
    TINY,
    LlamaConfig,
    LlamaModel,
    PagedKVCache,
    count_flops_per_token,
    cross_entropy_loss,
    init_kv_caches,
)
from ray_tpu_torch.models.moe import (
    MIXTRAL_8X7B,
    MOE_RULES,
    TINY_MOE,
    MoEConfig,
    MoEModel,
    moe_aux_loss,
)

__all__ = [
    "LlamaConfig", "LlamaModel", "LLAMA2_7B", "LLAMA2_13B", "LLAMA3_8B",
    "TINY", "PagedKVCache", "init_kv_caches", "init_params",
    "params_from_flax", "Generator", "SamplingParams",
    "cross_entropy_loss", "count_flops_per_token", "MoEConfig", "MoEModel",
    "MIXTRAL_8X7B", "TINY_MOE", "MOE_RULES", "moe_aux_loss",
]
