"""Autoregressive generation over a dense KV cache. Port of
ray_tpu/models/generate.py.

Prefill runs the whole prompt through the dense-cache branch of
`Attention` (f32 einsum attention with a position mask; no kernel), then
each decode step appends one token. The paged engine is held against
this Generator: greedy output must match token for token.

Sampling: greedy, temperature, top-k, nucleus (top-p).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_kv_caches

_NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 64
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → disabled
    top_p: float = 1.0         # 1 → disabled
    eos_token: int | None = None


def categorical(logits, generator: torch.Generator):
    """One draw per row from softmax(logits), by the Gumbel-max trick
    (what jax.random.categorical does; the random bits differ)."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def sample_logits(logits, generator: torch.Generator, params: SamplingParams):
    """logits: (B, V) → tokens (B,). top-p applies after top-k."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Smallest set whose mass ≥ top_p; keep at least one. An index
        # past the end (JAX fills it with NaN) masks nothing, as the
        # clamped last (smallest) value does.
        cutoff_idx = (cum < params.top_p).sum(-1, keepdim=True).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, _NEG_INF)
    return categorical(logits, generator)


class Generator:
    """Dense-cache generation for one (model, batch, max_len).

    Usage::

        gen = Generator(cfg, params, batch=1, max_len=512)
        out = gen.generate(prompt_tokens, SamplingParams(max_new_tokens=32))
    """

    def __init__(self, cfg: LlamaConfig, params, *, batch: int,
                 max_len: int, rng_seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.model = LlamaModel.from_params(cfg, params, self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)

    @torch.no_grad()
    def generate(self, prompt_tokens, params: SamplingParams | None = None
                 ) -> np.ndarray:
        """prompt_tokens: (B, S) array/list, all rows full width S.
        Returns (B, max_new_tokens) (shorter if eos_token ends all rows)."""
        sp = params or SamplingParams()
        prompts = np.asarray(prompt_tokens, dtype=np.int64)
        if prompts.ndim == 1:
            prompts = prompts[None]
        B, S = prompts.shape
        if B != self.batch:
            raise ValueError(f"generator built for batch={self.batch}, got {B}")
        if S + sp.max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds the bucket "
                             f"max_len={self.max_len}")
        dev = self.device
        with device_context(dev):
            caches = init_kv_caches(self.cfg, B, self.max_len, dev)
            tokens = torch.from_numpy(prompts).to(dev)
            positions = torch.arange(S, device=dev).expand(B, S)
            logits, caches = self.model(tokens, positions, kv_caches=caches)
            logits = logits[:, S - 1]
            out = np.zeros((B, sp.max_new_tokens), np.int32)
            pos = torch.full((B,), S, dtype=torch.long, device=dev)
            finished = np.zeros((B,), bool)
            for i in range(sp.max_new_tokens):
                token = sample_logits(logits, self._rng, sp)
                tok_np = token.cpu().numpy()
                out[:, i] = tok_np
                if sp.eos_token is not None:
                    finished |= tok_np == sp.eos_token
                    if finished.all():
                        out = out[:, : i + 1]
                        break
                if i + 1 < sp.max_new_tokens:
                    logits, caches = self.model(token[:, None], pos[:, None],
                                                kv_caches=caches)
                    logits = logits[:, 0]
                    pos = pos + 1
        return out



def generate(cfg: LlamaConfig, params, prompt_tokens,
             sampling: SamplingParams | None = None, *,
             max_len: int | None = None, device=None) -> np.ndarray:
    """One-shot convenience wrapper around Generator: its bucket is
    `max_len`, else the prompt plus max_new_tokens, capped at
    cfg.max_seq_len."""
    prompts = np.asarray(prompt_tokens, dtype=np.int64)
    if prompts.ndim == 1:
        prompts = prompts[None]
    sp = sampling or SamplingParams()
    bucket = max_len or min(cfg.max_seq_len,
                            prompts.shape[1] + sp.max_new_tokens)
    gen = Generator(cfg, params, batch=prompts.shape[0], max_len=bucket,
                    device=device)
    return gen.generate(prompts, sp)
