from ray_tpu_torch.models.convert import init_params, params_from_flax
from ray_tpu_torch.models.dit import (
    DiT,
    DiTConfig,
    count_dit_params,
    ddim_sample,
    ddpm_loss,
)
from ray_tpu_torch.models.encoder import (
    BERT_BASE,
    BERT_LARGE,
    T5_BASE,
    T5_LARGE,
    TINY_ENCDEC,
    TINY_ENCODER,
    EncDecConfig,
    Encoder,
    EncoderConfig,
    EncoderDecoder,
    mlm_loss,
    seq2seq_loss,
)
from ray_tpu_torch.models.generate import Generator, SamplingParams, generate
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
from ray_tpu_torch.models.ssm import (
    MAMBA_130M,
    MAMBA_790M,
    SSM_RULES,
    TINY_SSM,
    SSMConfig,
    SSMModel,
    init_ssm_state,
    ssm_decode_step,
    ssm_prefill,
)
from ray_tpu_torch.models.vit import (
    VIT_B16,
    VIT_L16,
    VIT_TINY,
    ViT,
    ViTConfig,
    vit_loss,
)

__all__ = [
    "LlamaConfig", "LlamaModel", "LLAMA2_7B", "LLAMA2_13B", "LLAMA3_8B",
    "TINY", "PagedKVCache", "init_kv_caches", "init_params",
    "params_from_flax", "Generator", "SamplingParams", "generate",
    "cross_entropy_loss", "count_flops_per_token", "MoEConfig", "MoEModel",
    "MIXTRAL_8X7B", "TINY_MOE", "MOE_RULES", "moe_aux_loss",
    "ViT", "ViTConfig", "VIT_B16", "VIT_L16", "VIT_TINY", "vit_loss",
    "DiT", "DiTConfig", "ddpm_loss", "ddim_sample", "count_dit_params",
    "Encoder", "EncoderConfig", "BERT_BASE", "BERT_LARGE", "TINY_ENCODER",
    "mlm_loss", "EncoderDecoder", "EncDecConfig", "T5_BASE", "T5_LARGE",
    "TINY_ENCDEC", "seq2seq_loss",
    "SSMModel", "SSMConfig", "MAMBA_130M", "MAMBA_790M", "TINY_SSM",
    "SSM_RULES", "init_ssm_state", "ssm_decode_step", "ssm_prefill",
]
