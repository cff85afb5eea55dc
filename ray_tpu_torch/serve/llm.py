"""Continuous-batching LLM engine over a paged KV pool. Port of the paged
mode of ray_tpu/serve/llm.py.

- **Slot-based continuous batching.** The decode batch is a fixed set of
  `max_batch` slots; new requests prefill into free slots while the other
  slots keep decoding.
- **Paged KV.** Slots share one pool of fixed-size KV pages per layer and
  attend over their page tables through the paged decode kernel
  (ops/paged_attention.py); `PageAllocator` keeps the free list on the
  host. Memory is bounded by `kv_pool_tokens` resident tokens: admission
  defers requests while the pool is dry, and pages return to the free
  list the moment a stream completes.
- **Batched prefill.** Same-bucket admissions prefill together at a fixed
  width W = min(8, max_batch); a lone request takes the single-sequence
  path. Prefill runs the dense-cache branch and scatters its KV into the
  sequence's pages.
- **Chunked decode.** Each engine tick runs `decode_chunk` steps with
  sampling on the device; only the (K, B) token block reaches the host.
- **Streaming with backpressure.** `submit()` returns a handle whose
  bounded queue yields tokens as they are produced; a consumer that stops
  draining parks its slot.

The engine thread owns the device: it makes the engine's device current
and launches on that thread's current stream. Not ported yet (ROADMAP
queue A, "dense engine mode, chunked prefill, submit_prefilled/drain
snapshot and disagg"): the dense mode (page_size=0), chunked prefill,
`submit_prefilled` and `snapshot_active_streams`.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.models.generate import SamplingParams, categorical
from ray_tpu_torch.models.llama import (LlamaConfig, LlamaModel, PagedKVCache,
                                        init_kv_caches)
from ray_tpu_torch.ops.paged_attention import PageAllocator

_NEG_INF = -1e30
_NOT_PORTED = ("is not ported yet (ROADMAP queue A: dense engine mode, "
               "chunked prefill, submit_prefilled/drain snapshot and disagg)")


@dataclass
class _Slot:
    request: "RequestHandle | None" = None
    generated: int = 0
    seq_id: str = ""  # allocator key owning this slot's pages


class RequestHandle:
    """Client-side stream of generated tokens for one request.

    The token queue is bounded (`max_buffered`): a consumer that stops
    draining while decode keeps producing parks the producing slot
    (backpressure) instead of growing host memory without limit."""

    def __init__(self, prompt_len: int, sampling: SamplingParams,
                 max_buffered: int = 256, tag: str = ""):
        self.prompt_len = prompt_len
        self.sampling = sampling
        self.tag = tag
        self._q: queue.Queue = queue.Queue(maxsize=max(1, max_buffered))
        self._done = threading.Event()
        self._submit_ts = time.monotonic()
        self.error: Exception | None = None

    def _offer(self, tok: int) -> bool:
        """Non-blocking enqueue; False = consumer backlog full (the engine
        parks the slot: it never blocks its loop on a slow consumer)."""
        try:
            self._q.put_nowait(tok)
            return True
        except queue.Full:
            return False

    def _finish(self, error: Exception | None = None) -> None:
        if error is not None and self.error is None:
            self.error = error
        self._done.set()

    def backlog_full(self) -> bool:
        return self._q.full()

    def __iter__(self):
        while True:
            try:
                yield self._q.get(timeout=0.05)
                continue
            except queue.Empty:
                pass
            if self._done.is_set():
                # Drain tokens that raced the done flag.
                while True:
                    try:
                        yield self._q.get_nowait()
                    except queue.Empty:
                        break
                if self.error is not None:
                    raise self.error
                return

    def tokens(self) -> list[int]:
        """Block until completion; all tokens as a list."""
        return list(self)


class LLMEngine:
    """Slot-based continuous-batching engine over a Llama-family model.

    params: the model's state_dict (models.convert.init_params or
    params_from_flax). device: None means CUDA and raises without a card.
    use_device_plane: kept for the signature of the JAX engine; the paged
    path hands KV from prefill to decode in place and never uses it."""

    def __init__(self, cfg: LlamaConfig, params, *, max_batch: int = 4,
                 max_len: int = 1024, decode_chunk: int = 8,
                 prefill_chunk: int = 0, rng_seed: int = 0,
                 page_size: int = 0, kv_pool_tokens: int = 0,
                 use_device_plane: bool = True, stream_buffer: int = 256,
                 device=None):
        if not page_size:
            raise NotImplementedError(f"dense engine mode (page_size=0) "
                                      f"{_NOT_PORTED}")
        if prefill_chunk:
            raise NotImplementedError(f"chunked prefill {_NOT_PORTED}")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self._stream_buffer = max(1, stream_buffer)
        # Steps per decode call: one host sync per chunk, not per token.
        self.decode_chunk = max(1, decode_chunk)
        self.model = LlamaModel.from_params(cfg, params, self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)
        K = self.decode_chunk
        # Overshoot margin: a chunk of K steps may run up to K-1 tokens
        # past a stream's max_new before the host sees it.
        pool_tokens = kv_pool_tokens or max_batch * (max_len + K)
        self._np_pages = -(-(max_len + K) // page_size)  # table width
        self._num_pages = -(-pool_tokens // page_size) + 1  # + dummy
        self._batch_prefill_width = min(8, max_batch)
        self._deferred: list = []  # pool-dry admissions, FIFO retry
        self._init_paged_state()

        self._lens = np.zeros(max_batch, np.int32)
        self._token = np.zeros(max_batch, np.int64)
        self._pos = np.zeros(max_batch, np.int64)
        self._temps = np.zeros(max_batch, np.float32)
        self._topks = np.zeros(max_batch, np.int64)
        self._topps = np.ones(max_batch, np.float32)
        self._slots = [_Slot() for _ in range(max_batch)]
        self._pending: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._ttft = deque(maxlen=256)  # seconds, submit -> first token
        self._parked_events = 0  # backpressure: offers rejected (q full)
        self.decode_steps = 0    # decode steps run (K per chunk)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ---- public API ------------------------------------------------------

    def submit(self, prompt_tokens, sampling: SamplingParams | None = None,
               tag: str = "") -> RequestHandle:
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        sp = sampling or SamplingParams()
        if len(prompt) + sp.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({sp.max_new_tokens})"
                f" exceeds engine max_len={self.max_len}")
        need = self._alloc.pages_needed(
            len(prompt) + sp.max_new_tokens + self.decode_chunk)
        if need > self._alloc.num_pages - 1:  # -1: dummy page
            raise ValueError(
                f"request needs {need} KV pages but the pool holds "
                f"{self._alloc.num_pages - 1}; raise kv_pool_tokens")
        handle = RequestHandle(len(prompt), sp,
                               max_buffered=self._stream_buffer, tag=tag)
        self._pending.put((prompt, handle))
        return handle

    def submit_prefilled(self, pack, sampling=None, tag: str = ""):
        raise NotImplementedError(f"submit_prefilled {_NOT_PORTED}")

    def snapshot_active_streams(self) -> dict:
        raise NotImplementedError(f"snapshot_active_streams {_NOT_PORTED}")

    def generate(self, prompt_tokens,
                 sampling: SamplingParams | None = None) -> list[int]:
        return self.submit(prompt_tokens, sampling).tokens()

    def num_active(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    def tokens_in_flight(self) -> int:
        """Remaining decode budget across active streams."""
        total = 0
        for st in self._slots:
            h = st.request
            if h is not None:
                total += max(0, h.sampling.max_new_tokens - st.generated)
        return total

    def queue_depth(self) -> int:
        return self._pending.qsize() + len(self._deferred)

    def report_metrics(self) -> dict:
        ttft = sorted(self._ttft)
        pick = lambda q: ttft[min(len(ttft) - 1,  # noqa: E731
                                  int(q * len(ttft)))] if ttft else 0.0
        return {
            "queue_depth": float(self.queue_depth()),
            "tokens_in_flight": float(self.tokens_in_flight()),
            "active_streams": float(self.num_active()),
            "parked_events": float(self._parked_events),
            "ttft_p50_ms": pick(0.5) * 1e3,
            "ttft_p99_ms": pick(0.99) * 1e3,
        }

    def shutdown(self):
        self._stop.set()
        self._thread.join(5.0)
        self._fail_all(RuntimeError("engine shut down"))

    def _fail_all(self, err: Exception):
        """Unblock every waiter: active slots, deferred and queued requests."""
        for i, st in enumerate(self._slots):
            if st.request is not None:
                st.request._finish(err)
                st.request = None
            self._free_slot_pages(i)
        for _prompt, handle in self._deferred:
            handle._finish(err)
        self._deferred.clear()
        while True:
            try:
                _prompt, handle = self._pending.get_nowait()
            except queue.Empty:
                break
            handle._finish(err)

    # ---- device programs -------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits, temps, top_ks, top_ps):
        """Per-row temperature / top-k / top-p on the device; top_ks == 0
        and top_ps == 1 disable the truncations. As in the JAX engine, the
        top-p cutoff comes from the softmax of the untruncated sorted
        logits."""
        V = logits.shape[-1]
        greedy = torch.argmax(logits, dim=-1)
        scaled = logits / temps.clamp_min(1e-6)[:, None]
        sorted_l = torch.sort(scaled, dim=-1, descending=True).values
        k_idx = (torch.where(top_ks > 0, top_ks, V) - 1).clamp(0, V - 1)
        kth = torch.gather(sorted_l, 1, k_idx[:, None])
        scaled = scaled.masked_fill(scaled < kth, _NEG_INF)
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        cut_idx = (cum < top_ps[:, None]).sum(-1).clamp(0, V - 1)
        cutoff = torch.gather(sorted_l, 1, cut_idx[:, None])
        scaled = scaled.masked_fill(scaled < cutoff, _NEG_INF)
        sampled = categorical(scaled, self._rng)
        return torch.where(temps <= 0.0, greedy, sampled)

    def _prefill_one(self, tokens):
        """tokens: (1, bucket) right-padded. Cache rows past the prompt
        hold K/V of pad tokens; decode masks keys by position and
        overwrites index `lens` before attending, so they are never read.
        Returns the (bucket, V) logits and per-layer (Hkv, max_len, D)."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        caches = init_kv_caches(self.cfg, 1, self.max_len, self.device)
        logits, new = self.model(tokens, positions, kv_caches=caches)
        return logits[0], [(k[0], v[0]) for k, v, _l in new]

    def _prefill_many(self, tokens, last_idx):
        """tokens: (W, bucket) right-padded; last_idx: (W,) index of each
        row's last prompt token. Returns each row's last-token logits
        (W, V) and the per-layer (W, Hkv, max_len, D) caches."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        caches = init_kv_caches(self.cfg, tokens.shape[0], self.max_len,
                                self.device)
        logits, new = self.model(tokens, positions, kv_caches=caches)
        last = logits[torch.arange(tokens.shape[0], device=self.device),
                      last_idx]
        return last, [(k, v) for k, v, _l in new]

    def _write_prompt_pages(self, kv_one, page_ids):
        """Scatter a prefill's (Hkv, max_len, D) caches into pool pages
        (pool layout (P, Hkv, page, D)), in place. page_ids entries past
        the prompt point at the dummy page."""
        ps = self.page_size
        for (kp, vp), (k1, v1) in zip(self._pools, kv_one):
            Hkv, L, D = k1.shape
            kp[page_ids] = k1.reshape(Hkv, L // ps, ps, D).transpose(0, 1)
            vp[page_ids] = v1.reshape(Hkv, L // ps, ps, D).transpose(0, 1)

    def _write_prompt_pages_many(self, kv_many, page_ids):
        """Batched _write_prompt_pages: kv_many per layer (W, Hkv, L, D),
        page_ids (W, L/ps); padding rows target the dummy page."""
        ps = self.page_size
        flat = page_ids.reshape(-1)
        for (kp, vp), (k1, v1) in zip(self._pools, kv_many):
            W, Hkv, L, D = k1.shape
            kp[flat] = k1.reshape(W, Hkv, L // ps, ps, D).transpose(1, 2) \
                .reshape(-1, Hkv, ps, D)
            vp[flat] = v1.reshape(W, Hkv, L // ps, ps, D).transpose(1, 2) \
                .reshape(-1, Hkv, ps, D)

    def _decode_chunk_paged(self, token, pos, tables, lens, temps, top_ks,
                            top_ps):
        """K decode steps for every slot; sampling stays on the device and
        the pools update in place. Returns the (K, B) tokens."""
        toks = []
        for _ in range(self.decode_chunk):
            caches = [PagedKVCache(k, v, tables, lens) for k, v in self._pools]
            logits, _ = self.model(token[:, None], pos[:, None],
                                   kv_caches=caches)
            token = self._sample(logits[:, 0], temps, top_ks, top_ps)
            toks.append(token)
            pos = pos + 1
            lens = lens + 1
        return torch.stack(toks)

    # ---- admission -------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _sampling_tensors(self, handles, width: int):
        """(temps, top_ks, top_ps) of `handles`, padded to `width` rows."""
        temps = np.zeros(width, np.float32)
        topks = np.zeros(width, np.int64)
        topps = np.ones(width, np.float32)
        for r, h in enumerate(handles):
            temps[r] = h.sampling.temperature
            topks[r] = h.sampling.top_k
            topps[r] = h.sampling.top_p
        return self._to_device(temps), self._to_device(topks), \
            self._to_device(topps)

    def _commit_first_token(self, slot: int, handle: RequestHandle,
                            first_logits, prompt_len: int):
        """Sample the first token and commit the slot's decode state."""
        tok = int(self._sample(first_logits[None],
                               *self._sampling_tensors([handle], 1))[0])
        self._commit_token(slot, handle, tok, prompt_len)

    def _commit_token(self, slot: int, handle: RequestHandle, tok: int,
                      prompt_len: int):
        """Commit an already-sampled first token + per-slot decode state."""
        sp = handle.sampling
        self._lens[slot] = prompt_len
        self._pos[slot] = prompt_len
        self._token[slot] = tok
        self._temps[slot] = sp.temperature
        self._topks[slot] = sp.top_k
        self._topps[slot] = sp.top_p
        st = self._slots[slot]
        st.request = handle
        st.generated = 0
        self._ttft.append(time.monotonic() - handle._submit_ts)
        self._emit(slot, tok)

    def _reserve_paged(self, slot: int, prompt: np.ndarray,
                       handle: RequestHandle) -> str:
        """Reserve pages for the stream's whole lifetime (prompt + max_new
        + chunk overshoot) up front, so decode never fails mid-stream on
        an empty pool; MemoryError defers the request instead."""
        seq_id = f"slot{slot}-{id(handle):x}"
        need = len(prompt) + handle.sampling.max_new_tokens + self.decode_chunk
        self._alloc.allocate(seq_id, need)  # MemoryError -> caller defers
        self._slots[slot].seq_id = seq_id
        return seq_id

    def _admit_paged_group(self, cands: list) -> None:
        """Prefill reserved candidates, batching same-bucket requests
        through _prefill_many (one call for up to W streams); singleton
        groups take _prefill_one. cands: (slot, seq_id, prompt, handle)
        with pages already reserved."""
        groups: dict = {}
        for c in cands:
            bucket = max(self._bucket(len(c[2])), self.page_size)
            groups.setdefault(bucket, []).append(c)
        for bucket, group in groups.items():
            while group:
                chunk = group[: self._batch_prefill_width]
                group = group[len(chunk):]
                if len(chunk) == 1:
                    slot, seq_id, prompt, handle = chunk[0]
                    try:
                        with record_function("llm.prefill_one"):
                            logits = self._prefill_into_pages(slot, seq_id,
                                                              prompt)
                            self._commit_first_token(
                                slot, handle, logits[len(prompt) - 1],
                                len(prompt))
                    except Exception as e:  # the request fails, not the loop
                        self._free_slot_pages(slot)
                        handle._finish(e)
                    continue
                W = self._batch_prefill_width
                tokens = np.zeros((W, bucket), np.int64)
                last_idx = np.zeros((W,), np.int64)
                page_rows = np.full((W, self.max_len // self.page_size),
                                    self._dummy_page, np.int64)
                rows = []
                for r, (slot, seq_id, prompt, handle) in enumerate(chunk):
                    tokens[r, : len(prompt)] = prompt
                    last_idx[r] = len(prompt) - 1
                    row = self._alloc.table(seq_id, self._np_pages).numpy()
                    rows.append(row)
                    npp = self._alloc.pages_needed(len(prompt))
                    page_rows[r, :npp] = row[:npp]
                try:
                    with record_function("llm.prefill_many"):
                        last_logits, kv_many = self._prefill_many(
                            self._to_device(tokens), self._to_device(last_idx))
                        self._write_prompt_pages_many(
                            kv_many, self._to_device(page_rows))
                        # One sampling call and one host read for the group.
                        toks = self._sample(
                            last_logits, *self._sampling_tensors(
                                [c[3] for c in chunk], W)).cpu().numpy()
                except Exception as e:
                    # A device failure sinks the whole group: fail every
                    # member and return their pages.
                    for slot, seq_id, prompt, handle in chunk:
                        self._free_slot_pages(slot)
                        handle._finish(e)
                    continue
                for r, (slot, seq_id, prompt, handle) in enumerate(chunk):
                    self._tables[slot] = rows[r]
                    self._commit_token(slot, handle, int(toks[r]),
                                       len(prompt))

    def _init_paged_state(self):
        """(Re)build the page pool: allocator + dummy page + zeroed
        per-layer pools + tables. Shared by __init__ and the
        decode-failure recovery path."""
        self._alloc = PageAllocator(self._num_pages, self.page_size)
        # Dummy page: inactive slots' writes and table padding land here,
        # never in a page a live sequence owns.
        self._dummy_page = self._alloc.allocate("__dummy__", 1)[0]
        shape = (self._num_pages, self.cfg.n_kv_heads, self.page_size,
                 self.cfg.head_dim)
        self._pools = [
            (torch.zeros(shape, dtype=self.cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=self.cfg.dtype, device=self.device))
            for _ in range(self.cfg.n_layers)]
        self._tables = np.full((self.max_batch, self._np_pages),
                               self._dummy_page, np.int32)

    def _prefill_into_pages(self, slot: int, seq_id: str,
                            prompt: np.ndarray):
        """Bucketed prefill of one prompt, scattered into its pages;
        returns the logits."""
        bucket = max(self._bucket(len(prompt)), self.page_size)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : len(prompt)] = prompt
        logits, kv_one = self._prefill_one(self._to_device(padded))
        row = self._alloc.table(seq_id, self._np_pages).numpy()
        n_prompt_pages = self._alloc.pages_needed(len(prompt))
        prompt_pages = np.full(self.max_len // self.page_size,
                               self._dummy_page, np.int64)
        prompt_pages[:n_prompt_pages] = row[:n_prompt_pages]
        self._write_prompt_pages(kv_one, self._to_device(prompt_pages))
        self._tables[slot] = row
        return logits

    def _free_slot_pages(self, slot: int):
        st = self._slots[slot]
        if st.seq_id:
            self._alloc.free(st.seq_id)
            self._tables[slot, :] = self._dummy_page
            st.seq_id = ""

    def _emit(self, slot: int, tok: int) -> bool:
        """Offer one token to the stream. False = the consumer's bounded
        queue is full: the caller must not commit the token (the slot
        parks and the same token is produced again next chunk)."""
        st = self._slots[slot]
        if not st.request._offer(tok):
            self._parked_events += 1
            return False
        st.generated += 1
        sp = st.request.sampling
        if (sp.eos_token is not None and tok == sp.eos_token) or \
                st.generated >= sp.max_new_tokens:
            st.request._finish()
            st.request = None
            # The stream's pages return to the pool at once: this is what
            # lets a deferred request admit on the next loop pass.
            self._free_slot_pages(slot)
        return True

    # ---- engine loop -----------------------------------------------------

    def _loop(self):
        with torch.no_grad(), device_context(self.device):
            while not self._stop.is_set():
                self._tick()

    def _admit_pending(self) -> None:
        """Admit as many pending requests as there are free slots, gated
        on pool pages (a dry pool defers the request, FIFO), and prefill
        the admissions of one pass together."""
        cands: list = []
        picked: set = set()
        while any(i not in picked and s.request is None
                  for i, s in enumerate(self._slots)):
            from_deferred = bool(self._deferred)
            if from_deferred:
                prompt, handle = self._deferred[0]
            else:
                try:
                    prompt, handle = self._pending.get(
                        block=(self.num_active() == 0 and not cands),
                        timeout=0.05)
                except queue.Empty:
                    break
            slot = next(i for i, s in enumerate(self._slots)
                        if s.request is None and i not in picked)
            try:
                seq_id = self._reserve_paged(slot, prompt, handle)
            except MemoryError:
                # Pool dry: keep FIFO order and stop admitting until a
                # completion frees pages.
                if not from_deferred:
                    self._deferred.append((prompt, handle))
                break
            if from_deferred:
                self._deferred.pop(0)
            picked.add(slot)
            cands.append((slot, seq_id, prompt, handle))
        if cands:
            self._admit_paged_group(cands)

    def _tick(self) -> None:
        self._admit_pending()
        decoding = [s for s in self._slots if s.request is not None]
        if not decoding:
            return
        # Backpressure: if every consumer's queue is full, a decode chunk
        # would produce only parked tokens; give the consumers time.
        if all(s.request.backlog_full() for s in decoding):
            self._stop.wait(0.002)
            return
        # One decode chunk for every slot (inactive slots compute garbage
        # on their stale state, into the dummy page; discarded here).
        try:
            with record_function("llm.decode_chunk"):
                toks = self._decode_chunk_paged(
                    self._to_device(self._token), self._to_device(self._pos),
                    self._to_device(self._tables), self._to_device(self._lens),
                    self._to_device(self._temps), self._to_device(self._topks),
                    self._to_device(self._topps)).cpu().numpy()  # (K, B)
        except Exception as e:
            # A decode failure must not strand waiters on a dead thread:
            # fail them all and keep serving on fresh state.
            self._fail_all(e)
            self._init_paged_state()
            return
        self.decode_steps += toks.shape[0]
        for i, st in enumerate(self._slots):
            if st.request is None:
                continue
            for kstep in range(toks.shape[0]):
                tok = int(toks[kstep, i])
                if not self._emit(i, tok):
                    # Consumer backlog full: park without committing;
                    # decode re-runs from the committed cursor next chunk
                    # (KV writes past it are rewritten before use).
                    break
                self._lens[i] += 1
                self._pos[i] += 1
                self._token[i] = tok
                if st.request is None:  # eos/max_new hit mid-chunk
                    break


# ---------------------------------------------------------------------------
# Serve integration
# ---------------------------------------------------------------------------


class LLMServer:
    """Deployment callable hosting one LLMEngine per replica.

        server = LLMServer(cfg, params, max_batch=8, max_len=2048,
                           page_size=64)
        for tok in server({"prompt_tokens": [...], "max_new_tokens": 32}):
            ...
    """

    def __init__(self, cfg: LlamaConfig, params, *, max_batch: int = 4,
                 max_len: int = 1024, decode_chunk: int = 8,
                 prefill_chunk: int = 0, page_size: int = 0,
                 kv_pool_tokens: int = 0, stream_buffer: int = 256,
                 device=None):
        self.engine = LLMEngine(cfg, params, max_batch=max_batch,
                                max_len=max_len, decode_chunk=decode_chunk,
                                prefill_chunk=prefill_chunk,
                                page_size=page_size,
                                kv_pool_tokens=kv_pool_tokens,
                                stream_buffer=stream_buffer, device=device)

    def report_metrics(self) -> dict:
        return self.engine.report_metrics()

    def __call__(self, payload: dict):
        sp = SamplingParams(
            max_new_tokens=int(payload.get("max_new_tokens", 64)),
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            eos_token=payload.get("eos_token"))
        handle = self.engine.submit(payload["prompt_tokens"], sp)
        for tok in handle:
            yield tok
