"""Vision Transformer. Port of ray_tpu/models/vit.py.

Images are (batch, height, width, channels), as in the reference; the
patch embedding is a stride-`patch_size` convolution, and the patches a
(batch, tokens, d_model) sequence behind a class token. Parameter names
follow the flax tree (`layers.{i}.attn.q_proj.weight` for
`layers_{i}/attn/q_proj/kernel`), so TRANSFORMER_RULES shard ViT as they
shard the decoder. Every Dense has a bias; the norms are flax's
LayerNorm in f32.

Attention follows the reference's rule: the flash kernels when
`attention == "flash"` and the sequence (patches + 1) is a multiple of
128, else the plain `mha_reference`. At VIT_B16 and VIT_L16 that is 197
tokens: no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ray_tpu_torch.models.layers import LayerNorm, ParamModel, gelu, linear
from ray_tpu_torch.ops.attention import flash_attention, mha_reference


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    attention: str = "flash"  # or "reference"
    pool: str = "cls"  # or "mean"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_B16 = ViTConfig()
VIT_L16 = ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)
VIT_TINY = ViTConfig(image_size=32, patch_size=8, num_classes=10, d_model=64,
                     n_layers=2, n_heads=4, d_ff=128, dtype=torch.float32,
                     attention="reference")


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        width = cfg.n_heads * cfg.head_dim
        self.q_proj, self.k_proj, self.v_proj = (
            linear(cfg.d_model, width, cfg.dtype, device, bias=True)
            for _ in range(3))
        self.o_proj = linear(width, cfg.d_model, cfg.dtype, device, bias=True)

    def forward(self, x):
        cfg = self.cfg
        B, T, _ = x.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        x = x.to(cfg.dtype)
        q, k, v = (p(x).view(B, T, H, Dh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if cfg.attention == "flash" and T % 128 == 0:
            out = flash_attention(q, k, v, None, False)
        else:
            out = mha_reference(q, k, v, causal=False)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, H * Dh))


class ViTMLP(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.up_proj = linear(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                              bias=True)
        self.down_proj = linear(cfg.d_ff, cfg.d_model, cfg.dtype, device,
                                bias=True)

    def forward(self, x):
        return self.down_proj(gelu(self.up_proj(x.to(self.dtype))))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.attn = ViTAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.mlp = ViTMLP(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(ParamModel):
    raw_init = {r"^cls_token$": ("zeros",), r"^pos_embed$": ("normal", 0.02)}

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            # flax's Conv pads "SAME": no padding only when the patches
            # tile the image
            raise ValueError(f"image size {cfg.image_size} is not a "
                             f"multiple of the patch size {cfg.patch_size}")
        self.cfg = cfg
        D, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, D, p, stride=p, dtype=cfg.dtype,
                                     device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, dtype=cfg.dtype,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches + 1, D, dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(ViTBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.norm = LayerNorm(D, device=device)
        self.lm_head = linear(D, cfg.num_classes, cfg.dtype, device,
                              bias=True)

    def forward(self, images):
        """images (B, H, W, 3), RGB -> logits (B, num_classes) in f32."""
        cfg = self.cfg
        B = images.shape[0]
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)           # (B, patches, D), row-major
        x = torch.cat([self.cls_token.expand(B, 1, cfg.d_model), x], dim=1)
        x = x + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        x = self.norm(x)
        pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
        return self.lm_head(pooled.to(cfg.dtype)).float()


def vit_loss(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
