"""Bidirectional encoder (BERT family) and encoder-decoder (T5 family).
Port of ray_tpu/models/encoder.py.

Activations are (batch, seq, d_model); the projections have no bias; the
norms are flax's LayerNorm in f32 (epsilon 1e-6). Attention is the
reference's plain f32 form, with no kernel: scores over sqrt(head_dim),
an additive -1e30 where the causal mask or the (batch, keys) validity
mask says no, softmax, and the weighted values. The MLM and seq2seq
logits come from the tied token embedding, in `cfg.dtype`. Parameter
names follow the flax tree (`layer.{i}.attn.q_proj.weight` for
`layer_{i}/attn/q_proj/kernel`; `enc_{i}`, `dec_{i}` in the
encoder-decoder), so TRANSFORMER_RULES shard both families.

On DTensors the attention runs on each rank's shards (`local_map`): the
batch over dp and fsdp, the heads over tp.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.models.layers import LayerNorm, ParamModel, gelu, linear
from ray_tpu_torch.models.llama import cross_entropy_loss

_NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Shared blocks
# ---------------------------------------------------------------------------


def _attend(q, k, v, mask, causal: bool):
    """q (B, Sq, H, Dh), k and v (B, Sk, H, Dh), mask (B, Sk) bool or
    None -> (B, Sq, H, Dh) f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~s.new_ones(s.shape[-2:], dtype=torch.bool).tril(),
                          _NEG_INF)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.float())


def _attend_local(q, k, v, mask, causal: bool):
    """_attend on each rank's shards of DTensors."""
    mesh = q.device_mesh
    heads = [Shard(0) if a in ("dp", "fsdp") else Shard(2) if a == "tp"
             else Replicate() for a in mesh.mesh_dim_names]
    batch = [Shard(0) if a in ("dp", "fsdp") else Replicate()
             for a in mesh.mesh_dim_names]
    fn = functools.partial(_attend, causal=causal)
    if mask is None:
        return local_map(lambda q, k, v: fn(q, k, v, None),
                         out_placements=heads, in_placements=(heads,) * 3,
                         device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    return local_map(fn, out_placements=heads,
                     in_placements=(heads,) * 3 + (batch,), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, mask)


class _Attention(nn.Module):
    """Full attention: bidirectional, causal, or cross (keys and values
    from `kv`)."""

    def __init__(self, d_model: int, n_heads: int, dtype, causal=False,
                 device=None):
        super().__init__()
        self.n_heads, self.dtype, self.causal = n_heads, dtype, causal
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (
            linear(d_model, d_model, dtype, device) for _ in range(4))

    def forward(self, x, kv=None, mask=None):
        kv = x if kv is None else kv
        B, Sq, D = x.shape
        Sk, H = kv.shape[1], self.n_heads
        q = self.q_proj(x).view(B, Sq, H, D // H)
        k = self.k_proj(kv).view(B, Sk, H, D // H)
        v = self.v_proj(kv).view(B, Sk, H, D // H)
        attend = _attend_local if isinstance(q, DTensor) else _attend
        out = attend(q, k, v, mask, self.causal)
        return self.o_proj(out.reshape(B, Sq, D).to(self.dtype))


class _MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.up_proj = linear(d_model, d_ff, dtype, device)
        self.down_proj = linear(d_ff, d_model, dtype, device)

    def forward(self, x):
        return self.down_proj(gelu(self.up_proj(x)))


# ---------------------------------------------------------------------------
# Encoder (BERT family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16


BERT_BASE = EncoderConfig()
BERT_LARGE = EncoderConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)
TINY_ENCODER = EncoderConfig(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=4, d_ff=128, max_seq_len=64,
                             dtype=torch.float32)


class EncoderBlock(nn.Module):
    """Pre-norm block; `c` is an EncoderConfig or an EncDecConfig."""

    def __init__(self, c, device=None):
        super().__init__()
        self.dtype = c.dtype
        self.ln_attn = LayerNorm(c.d_model, device=device)
        self.attn = _Attention(c.d_model, c.n_heads, c.dtype, device=device)
        self.ln_mlp = LayerNorm(c.d_model, device=device)
        self.mlp = _MLP(c.d_model, c.d_ff, c.dtype, device)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_attn(x).to(self.dtype), mask=mask)
        return x + self.mlp(self.ln_mlp(x).to(self.dtype))


class _Embedded(ParamModel):
    """The token embedding (tied to the output logits) and the learned
    positions of both families."""

    raw_init = {r"^pos_embed$": ("normal", 0.02)}

    def __init__(self, c, device=None):
        super().__init__()
        self.cfg = c
        self.tok_embed = nn.Embedding(c.vocab_size, c.d_model, dtype=c.dtype,
                                      device=device)
        self.pos_embed = nn.Parameter(torch.empty(
            c.max_seq_len, c.d_model, dtype=c.dtype, device=device))

    def _embed(self, tokens):
        return self.tok_embed(tokens) + self.pos_embed[None, :tokens.shape[1]]

    def _attend_vocab(self, x):
        """The tied-embedding logits, in cfg.dtype (flax's Embed.attend)."""
        return x.to(self.cfg.dtype) @ self.tok_embed.weight.T


class Encoder(_Embedded):
    """Bidirectional transformer encoder with an MLM head: forward gives
    (features (B, S, D) f32, logits (B, S, vocab) in cfg.dtype);
    `pooled` mean-pools the valid tokens for classification heads."""

    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__(cfg, device)
        self.layer = nn.ModuleList(EncoderBlock(cfg, device)
                                   for _ in range(cfg.n_layers))
        self.ln_final = LayerNorm(cfg.d_model, device=device)

    def forward(self, tokens, mask=None):
        """mask: (B, S) bool of valid tokens; None means all valid."""
        x = self._embed(tokens)
        for block in self.layer:
            x = block(x, mask)
        x = self.ln_final(x)
        return x, self._attend_vocab(x)

    @staticmethod
    def pooled(features, mask):
        m = mask[..., None].to(features.dtype)
        return (features * m).sum(1) / m.sum(1).clamp(min=1.0)


def mlm_loss(logits, targets, mlm_mask):
    """Cross-entropy only at the masked positions (the BERT objective)."""
    return cross_entropy_loss(logits, targets, mask=mlm_mask)


# ---------------------------------------------------------------------------
# Encoder-decoder (T5 family)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    vocab_size: int = 32128
    d_model: int = 768
    n_layers: int = 12          # per stack
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16


T5_BASE = EncDecConfig()
T5_LARGE = EncDecConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)
TINY_ENCDEC = EncDecConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                           d_ff=128, max_seq_len=64, dtype=torch.float32)


class DecoderBlock(nn.Module):
    def __init__(self, c: EncDecConfig, device=None):
        super().__init__()
        self.dtype = c.dtype
        self.ln_self = LayerNorm(c.d_model, device=device)
        self.self_attn = _Attention(c.d_model, c.n_heads, c.dtype,
                                    causal=True, device=device)
        self.ln_cross = LayerNorm(c.d_model, device=device)
        self.cross_attn = _Attention(c.d_model, c.n_heads, c.dtype,
                                     device=device)
        self.ln_mlp = LayerNorm(c.d_model, device=device)
        self.mlp = _MLP(c.d_model, c.d_ff, c.dtype, device)

    def forward(self, x, enc, enc_mask):
        x = x + self.self_attn(self.ln_self(x).to(self.dtype))
        x = x + self.cross_attn(self.ln_cross(x).to(self.dtype), kv=enc,
                                mask=enc_mask)
        return x + self.mlp(self.ln_mlp(x).to(self.dtype))


class EncoderDecoder(_Embedded):
    """Seq2seq transformer: bidirectional encoder, causal decoder with
    cross-attention (the T5 shape, pre-norm). forward gives the logits
    (B, S_tgt, vocab) in cfg.dtype."""

    def __init__(self, cfg: EncDecConfig, device=None):
        super().__init__(cfg, device)
        self.enc = nn.ModuleList(EncoderBlock(cfg, device)
                                 for _ in range(cfg.n_layers))
        self.ln_enc = LayerNorm(cfg.d_model, device=device)
        self.dec = nn.ModuleList(DecoderBlock(cfg, device)
                                 for _ in range(cfg.n_layers))
        self.ln_dec = LayerNorm(cfg.d_model, device=device)

    def forward(self, src_tokens, tgt_tokens, src_mask=None):
        x = self._embed(src_tokens)
        for block in self.enc:
            x = block(x, src_mask)
        enc = self.ln_enc(x).to(self.cfg.dtype)
        y = self._embed(tgt_tokens)
        for block in self.dec:
            y = block(y, enc, src_mask)
        return self._attend_vocab(self.ln_dec(y))


def seq2seq_loss(logits, targets, mask=None):
    """The shared cross-entropy under the seq2seq name."""
    return cross_entropy_loss(logits, targets, mask=mask)
