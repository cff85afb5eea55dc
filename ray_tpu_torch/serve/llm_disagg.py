"""Disaggregated LLM serving, the engine side: the prefix cache and the
prefill pool's engine. Port of ray_tpu/serve/llm_disagg.py:49-246.

- **`PrefixCache`**: a cross-request KV cache keyed on the prompt
  tokens, LRU and bounded. A full hit skips prefill compute entirely (the
  cached last-position logits are sampled with this request's params), a
  partial hit (a cached prompt is a strict prefix of the new one)
  prefills only the suffix, a miss runs the whole bucketed prefill.
- **`PrefillEngine`**: the bucketed whole-prompt prefill and the suffix
  prefill over a cached prefix, both through the dense-cache branch of
  the model's attention. Its result (per-layer KV trimmed to the prompt
  and the first sampled token) goes to a decode engine's
  `LLMEngine.submit_prefilled` as it is.

The prefill pool's server, the decode pool, the router and their
deployment (`PrefillServer`, `DecodeServer`, `DisaggHandle`,
`deploy_disagg`) need the runtime and are not ported yet. The runtime's
serve-disagg gauges become the module-level `disagg_counts`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.models.generate import SamplingParams, sample_logits
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_kv_caches

# The serve-disagg events (the reference's gauges), counted in-process.
disagg_counts = dict.fromkeys(
    ("streams_started", "streams_completed", "stream_resumes",
     "streams_evacuated", "fallback_reprefills", "prefix_full_hits",
     "prefix_partial_hits"), 0)
_counts_lock = threading.Lock()


def _note(event: str, n: int = 1) -> None:
    """Count n serve-disagg events; an unknown event is ignored, as the
    reference's gauge ignores it."""
    with _counts_lock:
        if event in disagg_counts:
            disagg_counts[event] += int(n)


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------


class PrefixCache:
    """Cross-request KV cache keyed on prompt tokens (LRU, bounded).

    Entries hold the host-side per-layer KV for one full prompt plus the
    last-position logits. Lookup semantics:

      full    — the exact prompt was seen before: reuse its KV AND its
                last-token logits (zero prefill compute; only sampling
                runs, with THIS request's params).
      partial — a cached prompt is a strict prefix of the new one:
                prefill only the suffix on top of the cached KV.
      miss    — run the whole bucketed prefill.

    The host KV is CPU tensors, where the reference keeps numpy: numpy
    has no bfloat16."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max(1, max_entries)
        self._entries: OrderedDict[tuple, dict] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, prompt) -> tuple[str, dict | None]:
        key = tuple(int(t) for t in prompt)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return "full", entry
            best_key, best = None, None
            for k, e in self._entries.items():
                n = len(k)
                if n < len(key) and key[:n] == k:
                    if best_key is None or n > len(best_key):
                        best_key, best = k, e
            if best is not None:
                self._entries.move_to_end(best_key)
                self.hits += 1
                return "partial", best
            self.misses += 1
            return "miss", None

    def insert(self, prompt, kv_host: list, last_logits) -> None:
        key = tuple(int(t) for t in prompt)
        with self._lock:
            self._entries[key] = {
                "prefix_len": len(key),
                "kv": kv_host,  # [(k, v)] per layer, (Hkv, plen, D) on host
                "logits": torch.as_tensor(last_logits).to("cpu"),
            }
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            n = len(self._entries)
        total = self.hits + self.misses
        return {"entries": n, "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}


# ---------------------------------------------------------------------------
# Prefill pool
# ---------------------------------------------------------------------------


class PrefillEngine:
    """The prefill pool's programs: bucketed whole-prompt prefill plus a
    suffix variant that continues on top of a cached KV prefix (the
    prefix-cache partial-hit path).

    params: the model's state_dict; given the dict a decode engine was
    built from, on the same device, the two share the weights' tensors.
    device: None means CUDA and raises without a card. Both prefills
    write one (1, Hkv, max_len, D) cache pair per layer that is kept
    between calls and never zeroed: rows past a call's window hold an
    earlier call's keys, which every query masks by position. Calls from
    several threads take turns on it."""

    def __init__(self, cfg: LlamaConfig, params, *, max_len: int = 1024,
                 rng_seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.model = LlamaModel.from_params(cfg, params, self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._kv = [(k, v) for k, v, _l in
                    init_kv_caches(cfg, 1, max_len, self.device)]
        self._lock = threading.Lock()

    def _prefill_one(self, tokens):
        """tokens: (1, bucket) right-padded. Returns the (bucket, V)
        logits; the KV lands in rows [0, bucket) of the engine's cache."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        logits, _ = self.model(tokens, positions,
                               kv_caches=[(k, v, 0) for k, v in self._kv])
        return logits[0]

    def _prefill_suffix(self, tokens, start: int):
        """tokens: (1, sbucket) right-padded suffix at absolute positions
        start.. on top of the prefix in rows [0, start) of the engine's
        cache. The write window [start, start + sbucket) must fit max_len
        (callers guard). Returns the (sbucket, V) logits."""
        positions = start + torch.arange(tokens.shape[1],
                                         device=self.device)[None]
        logits, _ = self.model(tokens, positions,
                               kv_caches=[(k, v, start) for k, v in self._kv])
        return logits[0]

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _sample_first(self, last_logits, sp: SamplingParams) -> int:
        tok = sample_logits(last_logits.to(self.device)[None], self._rng, sp)
        return int(tok[0])

    def _tokens(self, row: np.ndarray, width: int) -> torch.Tensor:
        padded = np.zeros((1, width), np.int64)
        padded[0, :len(row)] = row
        return torch.from_numpy(padded).to(self.device)

    @torch.no_grad()
    def prefill(self, prompt, sp: SamplingParams,
                cache: PrefixCache | None = None) -> dict:
        """Run (or skip, on a cache hit) prefill for one prompt. Returns
        {"kv": [(k, v)] per layer, (Hkv, prompt_len, D) on the device,
        "first_token", "prompt_len", "kv_len", "prefix_hit"}."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        hit, entry = cache.lookup(prompt) if cache is not None \
            else ("miss", None)
        if hit == "partial":
            start = entry["prefix_len"]
            if start + self._bucket(plen - start) > self.max_len:
                # The suffix's write window would run past max_len: run
                # the whole-prompt path instead (correctness over reuse).
                hit, entry = "miss", None
        with self._lock, device_context(self.device):
            if hit == "full":
                kv = [(k.to(self.device), v.to(self.device))
                      for k, v in entry["kv"]]
                first = self._sample_first(entry["logits"], sp)
                _note("prefix_full_hits")
                return {"kv": kv, "first_token": first, "prompt_len": plen,
                        "kv_len": plen, "prefix_hit": "full"}
            if hit == "partial":
                start = entry["prefix_len"]
                for (kb, vb), (k, v) in zip(self._kv, entry["kv"]):
                    kb[0, :, :start] = k[:, :start]
                    vb[0, :, :start] = v[:, :start]
                logits = self._prefill_suffix(
                    self._tokens(prompt[start:], self._bucket(plen - start)),
                    start)
                last_logits = logits[plen - start - 1]
                _note("prefix_partial_hits")
            else:
                logits = self._prefill_one(
                    self._tokens(prompt, self._bucket(plen)))
                last_logits = logits[plen - 1]
            # Copies: the engine's cache is overwritten by the next call.
            kv = [(k[0, :, :plen].clone(), v[0, :, :plen].clone())
                  for k, v in self._kv]
            if cache is not None:
                cache.insert(prompt,
                             [(k.to("cpu", copy=True), v.to("cpu", copy=True))
                              for k, v in kv], last_logits)
            first = self._sample_first(last_logits, sp)
        return {"kv": kv, "first_token": first, "prompt_len": plen,
                "kv_len": plen, "prefix_hit": hit}
