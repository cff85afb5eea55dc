"""Llama-family decoder. Port of ray_tpu/models/llama.py.

Parameter names follow the flax tree (`layers.{i}.attn.q_proj.weight`
for `layers_{i}/attn/q_proj/kernel`; see models/convert.py). Activations
are (batch, seq, d_model), attention internals (batch, heads, seq,
head_dim), RMSNorm in f32 with f32 scales (flax's default param dtype).

`Attention` has three branches, chosen by the cache it is given: the
paged pool (batched single-token decode through the paged decode kernel),
a dense per-sequence cache (prefill, the Generator's decode, and the
dense engine's decode with a write offset per row), and no
cache (training and full forwards: `attention="flash"` through the flash
kernels, `"reference"`, or the sequence-parallel `"ring"` and `"ulysses"`
over the mesh's sp axis).

With DTensor parameters (train/spmd.py's sharded state) every tensor the
forward makes is a DTensor too, in both passes: the RoPE tables are
replicated DTensors, a full forward slices them where it would index them
with an arange, and the causal mask is made from the scores.

Training: `cfg.remat` recomputes each decoder layer in the backward
(`torch.utils.checkpoint`), `cross_entropy_loss` is the logsumexp form,
and `count_flops_per_token` gives 6N for MFU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.models.layers import ParamModel
from ray_tpu_torch.ops.attention import (
    flash_attention,
    mha_reference,
    ring_attention,
    ulysses_attention,
)
from ray_tpu_torch.ops.paged_attention import paged_decode_attention_batch

_NEG_INF = -1e30


class PagedKVCache(NamedTuple):
    """Per-layer paged KV state for batched single-token decode."""

    k_pool: Any    # (P, Hkv, page_size, D)
    v_pool: Any    # (P, Hkv, page_size, D)
    table: Any     # (B, NP) int32 pool indices per sequence
    length: Any    # (B,) int32 tokens already cached (= write offset)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # attention without a cache: "flash" (the CUDA kernels), "reference"
    # (plain torch), "ring" or "ulysses" (sequence parallel over "sp").
    attention: str = "flash"
    remat: bool = True
    # "full": recompute everything in the backward (least memory);
    # "dots": keep the projections' matmul outputs and recompute the rest,
    # as JAX's dots_with_no_batch_dims_saveable.
    remat_policy: str = "dots"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


LLAMA2_7B = LlamaConfig()
LLAMA2_13B = LlamaConfig(d_model=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                         d_ff=13824)
LLAMA3_8B = LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                        n_heads=32, n_kv_heads=8, d_ff=14336,
                        rope_theta=500000.0, max_seq_len=8192)
TINY = LlamaConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=4, d_ff=256, max_seq_len=256,
                   dtype=torch.float32, attention="reference", remat=False)


def rope_frequencies(head_dim: int, max_len: int, theta: float, device=None):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                     # (max_len, head_dim/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """x: (B, H, S, D). positions: (B, S), (S,), or None for 0..S-1 (a
    slice of the tables, the same rows as an arange). Half-split
    rotation."""
    if positions is None:
        cos_p = cos[:x.shape[2]][None, None]
        sin_p = sin[:x.shape[2]][None, None]
    elif positions.dim() == 1:
        cos_p = cos[positions][None, None]
        sin_p = sin[positions][None, None]
    else:
        cos_p = cos[positions][:, None]
        sin_p = sin[positions][:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def _linear(cfg: LlamaConfig, device, d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=cfg.dtype, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        lin = functools.partial(_linear, cfg, device)
        self.q_proj = lin(cfg.d_model, Hq * Dh)
        self.k_proj = lin(cfg.d_model, Hkv * Dh)
        self.v_proj = lin(cfg.d_model, Hkv * Dh)
        self.o_proj = lin(Hq * Dh, cfg.d_model)

    def forward(self, x, positions, rope, kv_cache=None):
        cfg = self.cfg
        B, S, _ = x.shape
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q_proj(x).view(B, S, Hq, Dh).transpose(1, 2)   # (B,H,S,D)
        k = self.k_proj(x).view(B, S, Hkv, Dh).transpose(1, 2)
        v = self.v_proj(x).view(B, S, Hkv, Dh).transpose(1, 2)
        cos, sin = rope
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        if isinstance(kv_cache, PagedKVCache):
            # Batched single-token decode over the shared page pool: write
            # this step's K/V into each sequence's current page, then
            # attend over its page table (GQA inside the kernel). The
            # pools are updated in place where JAX returns donated copies.
            pc = kv_cache
            ps = pc.k_pool.shape[2]
            pages = pc.table.gather(1, (pc.length // ps).long()[:, None])[:, 0]
            pages, offs = pages.long(), (pc.length % ps).long()
            # [pages, :, offs] on a (P, Hkv, page, D) pool addresses one
            # (B, Hkv, D) row set; inactive slots all hit the dummy page.
            pc.k_pool[pages, :, offs] = k[:, :, 0, :]
            pc.v_pool[pages, :, offs] = v[:, :, 0, :]
            length = pc.length + 1
            out = paged_decode_attention_batch(
                q[:, :, 0, :].contiguous(), pc.k_pool, pc.v_pool, pc.table,
                length)
            out = out[:, :, None, :].to(cfg.dtype)
            out = out.transpose(1, 2).reshape(B, S, Hq * Dh)
            return self.o_proj(out), PagedKVCache(pc.k_pool, pc.v_pool,
                                                  pc.table, length)

        new_cache = None
        if kv_cache is not None:
            # Append to the dense cache at cache_len, in place (a cache
            # belongs to one prefill or one generate call, or to the
            # dense engine's slots).
            ck, cv, cache_len = kv_cache
            if torch.is_tensor(cache_len):
                # Per-row offsets, the port of the reference engine's vmap
                # over one sequence's decode step: row b writes at
                # cache_len[b]. An offset past the cache lands on its last
                # row, as dynamic_update_slice clamps it. No host sync.
                if S != 1:
                    raise ValueError("per-row cache offsets take one token "
                                     f"a row, got {S}")
                rows = torch.arange(B, device=x.device)
                at = cache_len.long().clamp_max(ck.shape[2] - 1)
                ck[rows, :, at] = k[:, :, 0]
                cv[rows, :, at] = v[:, :, 0]
            else:
                ck[:, :, cache_len:cache_len + S] = k
                cv[:, :, cache_len:cache_len + S] = v
            k, v = ck, cv
            new_cache = (ck, cv, cache_len + S)   # before the GQA repeat

        if Hkv != Hq:  # GQA: query head h reads KV head h // (Hq // Hkv)
            k = k.repeat_interleave(Hq // Hkv, dim=1)
            v = v.repeat_interleave(Hq // Hkv, dim=1)

        if kv_cache is not None:
            # Attention over every cache row, masked by position.
            total = k.shape[2]
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                             k.float()) / math.sqrt(Dh)
            kpos = torch.arange(total, device=x.device)[None, None, None, :]
            qpos = positions[:, None, :, None] if positions.dim() == 2 \
                else positions[None, None, :, None]
            s = s.masked_fill(kpos > qpos, _NEG_INF)
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", p,
                               v.float()).to(cfg.dtype)
        elif cfg.attention == "flash":
            out = flash_attention(q, k, v, None, True)
        elif cfg.attention == "ring":
            out = ring_attention(q, k, v, axis="sp", causal=True)
        elif cfg.attention == "ulysses":
            out = ulysses_attention(q, k, v, axis="sp", causal=True)
        else:
            out = mha_reference(q, k, v, causal=True)

        out = out.transpose(1, 2).reshape(B, S, Hq * Dh)
        out = self.o_proj(out)
        if kv_cache is not None:
            return out, new_cache
        return out


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _linear(cfg, device, cfg.d_model, cfg.d_ff)
        self.up_proj = _linear(cfg, device, cfg.d_model, cfg.d_ff)
        self.down_proj = _linear(cfg, device, cfg.d_ff, cfg.d_model)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device)
        self.post_attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, rope, kv_cache=None):
        h = self.input_norm(x)
        if kv_cache is not None:
            attn, new_cache = self.attn(h, positions, rope, kv_cache)
        else:
            attn = self.attn(h, positions, rope)
            new_cache = None
        x = x + attn
        x = x + self.mlp(self.post_attn_norm(x))
        if kv_cache is not None:
            return x, new_cache
        return x


# "dots": the outputs of the projections' matmuls (nn.Linear on a
# (B, S, d) input runs one aten.mm) are saved, everything else, flash
# attention included, is recomputed in the backward.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)},
}


class DecoderModel(ParamModel):
    """What the port's decoders share: the RoPE tables as the buffers
    `rope_cos`/`rope_sin` (train/spmd.py replicates them on a mesh)."""

    def _set_buffers(self, device):
        # RoPE tables computed once per model, f32, (max_seq_len, D/2).
        cos, sin = rope_frequencies(self.cfg.head_dim, self.cfg.max_seq_len,
                                    self.cfg.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)


class LlamaModel(DecoderModel):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                  dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.lm_head = None if cfg.tie_embeddings else _linear(
            cfg, device, cfg.d_model, cfg.vocab_size)
        self._set_buffers(device)

    def forward(self, tokens, positions=None, kv_caches=None):
        cfg = self.cfg
        if positions is None and kv_caches is not None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        rope = (self.rope_cos, self.rope_sin)
        x = self.embed(tokens)
        # Remat only where a backward follows, as nn.remat matters only
        # under jax.grad.
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()
        new_caches = []
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, c = layer(x, positions, rope, kv_caches[i])
                new_caches.append(c)
            elif remat:
                x = checkpoint(layer, x, positions, rope, use_reentrant=False,
                               **_REMAT_CONTEXT[cfg.remat_policy])
            else:
                x = layer(x, positions, rope)
        x = self.norm(x)
        if cfg.tie_embeddings:
            logits = x.to(cfg.dtype) @ self.embed.weight.T
        else:
            logits = self.lm_head(x)
        logits = logits.float()
        if kv_caches is not None:
            return logits, new_caches
        return logits


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int, device=None):
    Dh = cfg.head_dim
    shape = (batch, cfg.n_kv_heads, max_len, Dh)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device), 0)
            for _ in range(cfg.n_layers)]


def _whole_last_dim(t):
    """t, or for a DTensor t, t gathered along its last dim (the vocab)
    and with its partial sums reduced (the MoE's expert-parallel output
    leaves them): DTensor's gather over a sharded or partial vocab leaves
    a masked partial result that its redistribution then misreads."""
    if not isinstance(t, DTensor):
        return t
    last = t.dim() - 1
    placements = [p if isinstance(p, Shard) and p.dim not in (-1, last)
                  else Replicate() for p in t.placements]
    return t.redistribute(t.device_mesh, placements)


def cross_entropy_loss(logits, targets, mask=None):
    """Mean next-token negative log-likelihood, in the logsumexp form: no
    normalized (B, S, V) array is kept beside the logits."""
    l32 = _whole_last_dim(logits.float())
    lse = torch.logsumexp(l32, dim=-1)
    picked = l32.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


def count_flops_per_token(cfg: LlamaConfig) -> float:
    """Forward+backward FLOPs per token as 6 x the parameter count; no
    attention FLOPs are counted."""
    n = (cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
         + cfg.n_layers * (
             cfg.d_model * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
             + cfg.n_heads * cfg.head_dim * cfg.d_model
             + 3 * cfg.d_model * cfg.d_ff))
    return 6.0 * n
