"""DiT: the diffusion transformer. Port of ray_tpu/models/dit.py.

Patchify, N transformer blocks with adaptive layer norm conditioned on
(timestep, class), unpatchify to the noise prediction (Peebles & Xie).
Images are (batch, height, width, channels). Attention is non-causal
through the flash kernels (`attention="flash"`, forward and backward) or
the plain `mha_reference`; q, k and v are the model's views of one qkv
projection, which the kernels load as they are.

The conditioning layers are f32 whatever `cfg.dtype` is, as in the
reference: `t_embed`, `label_embed`, each block's `adaLN` and
`final_proj`, beside the f32 norms. `adaLN` and `final_proj` start at
zero (adaLN-Zero), so a fresh model predicts 0.

`ddpm_loss` and `ddim_sample` take a torch.Generator where the reference
takes a PRNG key; `_ddpm_loss` and `_ddim_sample` take the draws
themselves (the timesteps, noise and label-drop mask; the starting
noise). The reference's `lax.scan` over the sampler's steps is a Python
loop here, two forwards a step under guidance as there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.layers import LayerNorm, ParamModel, gelu, linear
from ray_tpu_torch.ops.attention import flash_attention, mha_reference


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 32
    channels: int = 3
    patch_size: int = 4
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 6
    num_classes: int = 10          # 0 disables class conditioning
    timesteps: int = 1000
    dtype: Any = torch.bfloat16
    attention: str = "flash"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, f32. t: (B,) in [0, timesteps)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class AdaLNBlock(nn.Module):
    """Transformer block with adaLN-Zero conditioning (the DiT block)."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.adaLN = linear(D, 6 * D, torch.float32, device, bias=True)
        self.norm = LayerNorm(D, use_scale=False, use_bias=False,
                              device=device)
        self.qkv = linear(D, 3 * D, cfg.dtype, device)
        self.proj = linear(D, D, cfg.dtype, device)
        self.mlp_in = linear(D, 4 * D, cfg.dtype, device, bias=True)
        self.mlp_out = linear(4 * D, D, cfg.dtype, device, bias=True)

    def forward(self, x, cond):
        cfg = self.cfg
        B, S, D = x.shape
        mod = self.adaLN(F.silu(cond))[:, None, :]
        shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=-1)

        h = (self.norm(x) * (1 + scale1) + shift1).to(cfg.dtype)
        # q, k, v: views (B, H, S, Dh) of one (B, S, 3H, Dh) projection
        q, k, v = self.qkv(h).view(B, S, 3 * cfg.n_heads, cfg.head_dim) \
            .transpose(1, 2).chunk(3, dim=1)
        if cfg.attention == "flash":
            attn = flash_attention(q, k, v)
        else:
            attn = mha_reference(q, k, v)
        attn = self.proj(attn.transpose(1, 2).reshape(B, S, D))
        x = x + gate1.to(cfg.dtype) * attn

        h = (self.norm(x) * (1 + scale2) + shift2).to(cfg.dtype)
        h = self.mlp_out(gelu(self.mlp_in(h)))
        return x + gate2.to(cfg.dtype) * h


class DiT(ParamModel):
    raw_init = {r"\.adaLN\.weight$": ("zeros",),
                r"^final_proj\.weight$": ("zeros",),
                r"^pos_embed$": ("normal", 0.02)}

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, p2c = cfg.d_model, cfg.patch_size ** 2 * cfg.channels
        self.patch_embed = linear(p2c, D, cfg.dtype, device, bias=True)
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches, D, dtype=cfg.dtype, device=device))
        self.t_embed = linear(D, D, torch.float32, device, bias=True)
        # the extra row is the null class (label dropout, guidance)
        self.label_embed = nn.Embedding(
            cfg.num_classes + 1, D, dtype=torch.float32, device=device) \
            if cfg.num_classes else None
        self.blocks = nn.ModuleList(AdaLNBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(D, device=device)
        self.final_proj = linear(D, p2c, torch.float32, device, bias=True)

    def forward(self, images, t, labels=None):
        """images (B, H, W, C) noisy input, t (B,) timesteps, labels (B,)
        class ids or None -> the predicted noise (B, H, W, C) in f32."""
        cfg = self.cfg
        B, H, W, C = images.shape
        p = cfg.patch_size
        x = images.reshape(B, H // p, p, W // p, p, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, cfg.num_patches, p * p * C)
        x = self.patch_embed(x.to(cfg.dtype)) + self.pos_embed

        cond = self.t_embed(timestep_embedding(t, cfg.d_model))
        if cfg.num_classes and labels is not None:
            cond = cond + self.label_embed(labels.long())

        for block in self.blocks:
            x = block(x, cond)

        x = self.final_proj(self.final_norm(x))
        x = x.reshape(B, H // p, W // p, p, p, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# DDPM training + DDIM sampling
# ---------------------------------------------------------------------------


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """The f32 values of the reference's jnp.linspace (endpoint included):
    start (1 - s) + stop s at s = i * (1 / (num - 1)), in f32 (XLA
    multiplies by the reciprocal where jax divides), then stop."""
    if num == 1:
        return np.array([start], np.float32)
    s = np.arange(num - 1, dtype=np.float32) * (np.float32(1)
                                                / np.float32(num - 1))
    out = np.float32(start) * (np.float32(1) - s) + np.float32(stop) * s
    return np.append(out, np.float32(stop))


def diffusion_schedule(cfg: DiTConfig, device=None):
    """Cosine alpha-bar schedule (Nichol & Dhariwal), f32, T + 1 entries."""
    t = torch.from_numpy(_linspace(0, 1, cfg.timesteps + 1)).to(device)
    f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return (f / f[0]).clamp(1e-5, 1.0)


def _ddpm_loss(model: DiT, images, labels, t, noise, drop):
    """The loss at given draws: timesteps t (B,) int, noise shaped as
    images, drop (B,) bool (labels replaced by the null class)."""
    cfg = model.cfg
    # alpha_bar[0] == 1 is no noise: index t + 1, so each sample has some
    alpha_bar = diffusion_schedule(cfg, images.device)[t.long() + 1][
        :, None, None, None]
    noisy = alpha_bar.sqrt() * images + (1 - alpha_bar).sqrt() * noise
    if cfg.num_classes and labels is not None:
        labels = torch.where(drop, cfg.num_classes, labels.long())
    pred = model(noisy, t.float(), labels)
    return ((pred - noise) ** 2).mean()


def ddpm_loss(model: DiT, images, labels, generator: torch.Generator,
              label_drop_prob: float = 0.1):
    """Noise-prediction MSE at uniformly drawn timesteps, the labels
    dropped to the null class with label_drop_prob; the draws come from
    `generator` (on the images' device)."""
    cfg, B, dev = model.cfg, images.shape[0], images.device
    t = torch.randint(0, cfg.timesteps, (B,), generator=generator,
                      device=dev)
    noise = torch.randn(images.shape, generator=generator, device=dev)
    drop = torch.rand(B, generator=generator, device=dev) < label_drop_prob
    return _ddpm_loss(model, images, labels, t, noise, drop)


def sample_timesteps(cfg: DiTConfig, steps: int) -> list[int]:
    """The sampler's alpha-bar indices, T down to 1, as the reference's
    jnp.linspace(T, 1, steps).astype(int32) gives them (its f32 values
    truncated: 666, not 667, a third of the way from 1000 to 1)."""
    return _linspace(cfg.timesteps, 1, steps).astype(np.int32).tolist()


@torch.no_grad()
def _ddim_step(model: DiT, x, t: int, t_next: int, alpha_bar, labels=None,
               guidance: float = 0.0):
    """One DDIM step from x at the noise level alpha_bar[t] to that of
    t_next, where t_next 0 means x0 itself (alpha_bar 1)."""
    ab_t = alpha_bar[t]
    ab_n = alpha_bar[t_next] if t_next else torch.ones((), device=x.device)
    # training conditions on t with the noise level alpha_bar[t + 1]; here
    # the level is alpha_bar[t], so condition on t - 1
    t_batch = torch.full((x.shape[0],), t - 1, dtype=torch.float32,
                         device=x.device)
    eps = model(x, t_batch, labels)
    if guidance > 0 and labels is not None:
        eps_u = model(x, t_batch, torch.full_like(labels,
                                                  model.cfg.num_classes))
        eps = eps_u + (1 + guidance) * (eps - eps_u)
    x0 = ((x - (1 - ab_t).sqrt() * eps) / ab_t.sqrt()).clamp(-3.0, 3.0)
    return ab_n.sqrt() * x0 + (1 - ab_n).sqrt() * eps


def _ddim_sample(model: DiT, x, *, steps: int = 50, labels=None,
                 guidance: float = 0.0):
    """DDIM from the starting noise x (num, H, W, C) f32: the alpha-bar
    indices T down to 1, then x0."""
    alpha_bar = diffusion_schedule(model.cfg, x.device)
    ts = sample_timesteps(model.cfg, steps)
    for t, t_next in zip(ts, ts[1:] + [0]):
        x = _ddim_step(model, x, t, t_next, alpha_bar, labels, guidance)
    return x


def ddim_sample(model: DiT, generator: torch.Generator, *, num: int,
                steps: int = 50, labels=None, guidance: float = 0.0):
    """Deterministic DDIM sampler from noise drawn with `generator` (on
    the model's device); classifier-free guidance when guidance > 0 and
    labels are given. Returns (num, H, W, C) f32."""
    cfg = model.cfg
    x = torch.randn((num, cfg.image_size, cfg.image_size, cfg.channels),
                    generator=generator, device=model.pos_embed.device)
    return _ddim_sample(model, x, steps=steps, labels=labels,
                        guidance=guidance)


def count_dit_params(cfg: DiTConfig) -> int:
    D = cfg.d_model
    p2c = cfg.patch_size ** 2 * cfg.channels
    per_block = (
        6 * D * D + 6 * D          # adaLN kernel + bias
        + 3 * D * D                # qkv (no bias)
        + D * D                    # attn out proj (no bias)
        + 4 * D * D + 4 * D        # mlp_in kernel + bias
        + 4 * D * D + D)           # mlp_out kernel + bias
    extra = (
        p2c * D + D                # patch embed (+bias)
        + cfg.num_patches * D      # positional embedding
        + D * D + D                # t_embed
        + ((cfg.num_classes + 1) * D if cfg.num_classes else 0)
        + 2 * D                    # final_norm scale+bias
        + D * p2c + p2c)           # final proj (+bias)
    return cfg.n_layers * per_block + extra
