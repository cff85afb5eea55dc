"""Continuous-batching LLM engine over a dense or a paged KV cache. Port
of ray_tpu/serve/llm.py.

- **Slot-based continuous batching.** The decode batch is a fixed set of
  `max_batch` slots; new requests prefill into free slots while the other
  slots keep decoding.
- **Dense KV (page_size=0).** One (max_batch, Hkv, max_len, D) cache
  pair per layer; each slot writes its decode step at its own offset
  (the model's per-row cache offsets, the port of the reference's vmap
  over one sequence's decode step).
- **Paged KV (page_size > 0).** Slots share one pool of fixed-size KV
  pages per layer and attend over their page tables through the paged
  decode kernel (ops/paged_attention.py); `PageAllocator` keeps the free
  list on the host. Memory is bounded by `kv_pool_tokens` resident
  tokens: admission defers requests while the pool is dry, and pages
  return to the free list the moment a stream completes. Same-bucket
  admissions prefill together at a fixed width W = min(8, max_batch).
- **Chunked prefill (dense only, prefill_chunk > 0).** A prompt longer
  than a chunk prefills one chunk a tick, interleaved with decoding, so
  a long prompt does not stall the streams in flight.
- **Chunked decode.** Each engine tick runs `decode_chunk` steps with
  sampling on the device; only the (K, B) token block reaches the host.
  On CUDA the chunk is one captured CUDA graph per engine, replayed
  every tick (the reference's one jitted decode program): the host's
  slot state is copied into static device buffers, the graph replays,
  and its output buffer is read. On the CPU the chunk runs eagerly.
- **Streaming with backpressure.** `submit()` returns a handle whose
  bounded queue yields tokens as they are produced; a consumer that stops
  draining parks its slot.
- **Drain and resume.** `quiesce_for_drain()` pauses the loop at a tick
  boundary, `snapshot_active_streams()` copies each decoding stream's KV
  and cursor to the host, and `submit_prefilled()` resumes it in another
  engine (of either mode, or from the JAX engine's snapshot).

The engine thread owns the device: it makes the engine's device current,
launches on that thread's current stream and captures the decode graph.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch._private import device_objects
from ray_tpu_torch.models.generate import SamplingParams, categorical
from ray_tpu_torch.models.llama import (LlamaConfig, LlamaModel, PagedKVCache,
                                        init_kv_caches)
from ray_tpu_torch.ops.paged_attention import PageAllocator, launch_counts

_NEG_INF = -1e30


@dataclass
class _Slot:
    request: "RequestHandle | None" = None
    generated: int = 0
    # Chunked prefill in progress: the whole prompt and how much of it is
    # in this slot's cache row. None = decoding.
    prefill_prompt: "np.ndarray | None" = None
    prefill_pos: int = 0
    seq_id: str = ""  # paged mode: allocator key owning this slot's pages
    # Every token this stream has generated, the ones still queued in the
    # handle included: a drain snapshot ships it so that a resumed stream
    # can deliver again exactly the tokens its consumer never received.
    history: list = field(default_factory=list)


class _Prefilled:
    """Admission payload for a request whose prefill ran in another engine
    (a disaggregated prefill pool, or a stream resumed after a drain): the
    per-layer KV prefix and the decode cursor."""

    __slots__ = ("kv_layers", "token", "prompt_len", "lens", "generated",
                 "history", "emit_first")

    def __init__(self, kv_layers, token, prompt_len, lens, generated,
                 history, emit_first):
        # [(k, v)] per layer, each (Hkv, >= lens, D): numpy arrays or CPU
        # tensors (a snapshot's bf16 KV can only be a tensor).
        self.kv_layers = kv_layers
        self.token = int(token)      # next decode input (last sampled)
        self.prompt_len = int(prompt_len)
        self.lens = int(lens)        # valid KV entries
        self.generated = int(generated)
        self.history = list(history or [])
        self.emit_first = bool(emit_first)


class RequestHandle:
    """Client-side stream of generated tokens for one request.

    The token queue is bounded (`max_buffered`): a consumer that stops
    draining while decode keeps producing parks the producing slot
    (backpressure) instead of growing host memory without limit."""

    def __init__(self, prompt_len: int, sampling: SamplingParams,
                 max_buffered: int = 256, tag: str = ""):
        self.prompt_len = prompt_len
        self.sampling = sampling
        self.tag = tag  # snapshot key of the stream
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
    use_device_plane: a dense prefill hands its KV to decode through the
    device plane's same-process route (`device_objects.local_handoff`:
    the same tensors back, the plane's in_process and released counters
    ticked); False writes the slot row straight from the prefill."""

    def __init__(self, cfg: LlamaConfig, params, *, max_batch: int = 4,
                 max_len: int = 1024, decode_chunk: int = 8,
                 prefill_chunk: int = 0, rng_seed: int = 0,
                 page_size: int = 0, kv_pool_tokens: int = 0,
                 use_device_plane: bool = True, stream_buffer: int = 256,
                 device=None):
        if page_size:
            if max_len % page_size:
                raise ValueError(f"max_len={max_len} must be a multiple of "
                                 f"page_size={page_size}")
            if prefill_chunk:
                raise ValueError(
                    "chunked prefill is not supported in paged mode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.use_device_plane = use_device_plane
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        # >0: prompts longer than this prefill in chunks interleaved with
        # decode ticks. 0: whole-prompt bucketed prefill.
        self.prefill_chunk = prefill_chunk
        self._stream_buffer = max(1, stream_buffer)
        # Steps per decode call: one host sync per chunk, not per token.
        self.decode_chunk = max(1, decode_chunk)
        self.model = LlamaModel.from_params(cfg, params, self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(rng_seed)
        K, B = self.decode_chunk, max_batch
        self._deferred: list = []  # pool-dry admissions, FIFO retry
        if page_size:
            # Overshoot margin: a chunk of K steps may run up to K-1 tokens
            # past a stream's max_new before the host sees it.
            pool_tokens = kv_pool_tokens or max_batch * (max_len + K)
            self._np_pages = -(-(max_len + K) // page_size)  # table width
            self._num_pages = -(-pool_tokens // page_size) + 1  # + dummy
            self._batch_prefill_width = min(8, max_batch)
            shape = (self._num_pages, cfg.n_kv_heads, page_size,
                     cfg.head_dim)
            self._pools = [
                (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                 torch.zeros(shape, dtype=cfg.dtype, device=self.device))
                for _ in range(cfg.n_layers)]
            self._kv = None
        else:
            self._pools = None
            self._kv = [(k, v) for k, v, _l in
                        init_kv_caches(cfg, B, max_len, self.device)]

        # Decode inputs: host arrays the loop edits, each a view of a CPU
        # tensor (pinned on CUDA) copied every tick into a static device
        # buffer that the decode graph reads.
        self._staged: list = []
        self._token, token = self._staging((B,), torch.int64)
        self._pos, pos = self._staging((B,), torch.int64)
        self._lens, lens = self._staging((B,), torch.int32)
        self._temps, temps = self._staging((B,), torch.float32)
        self._topks, topks = self._staging((B,), torch.int64)
        self._topps, topps = self._staging((B,), torch.float32, 1.0)
        self._decode_args = (token, pos, lens, temps, topks, topps)
        if page_size:
            self._tables, tables = self._staging((B, self._np_pages),
                                                 torch.int32)
            self._decode_args += (tables,)
        self._reset_kv()
        self._graph = None       # the captured decode chunk (CUDA)
        self._graph_out = None   # its (K, B) output buffer
        # Kernel launches recorded in the graph, by wrapper (each replay
        # runs them again; the wrappers count only at capture), and the
        # number of replays.
        self.graph_launches: dict = {}
        self.graph_replays = 0

        self._slots = [_Slot() for _ in range(max_batch)]
        self._prefill_rr = 0  # round-robin cursor over prefilling slots
        self._pending: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # Drain handshake: _quiesce asks the loop to pause at a tick
        # boundary; the loop acks through _quiet, after which slot and KV
        # state is stable for snapshot_active_streams().
        self._quiesce = threading.Event()
        self._quiet = threading.Event()
        self._ttft = deque(maxlen=256)  # seconds, submit -> first token
        self._parked_events = 0  # backpressure: offers rejected (q full)
        self.decode_steps = 0    # decode steps run (K per chunk)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def _staging(self, shape, dtype, fill=0):
        """A host array and the static device buffer it is copied into."""
        host = torch.full(shape, fill, dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        dev = torch.empty(shape, dtype=dtype, device=self.device)
        self._staged.append((host, dev))
        return host.numpy(), dev

    def _reset_kv(self) -> None:
        """Empty KV state: a fresh allocator, dummy page and tables (paged),
        and every cache zeroed in place, since the decode graph holds their
        addresses. Shared by __init__ and the decode-failure recovery."""
        if self.page_size:
            self._alloc = PageAllocator(self._num_pages, self.page_size)
            # Dummy page: inactive slots' writes and table padding land
            # here, never in a page a live sequence owns.
            self._dummy_page = self._alloc.allocate("__dummy__", 1)[0]
            self._tables[:] = self._dummy_page
        for k, v in self._pools or self._kv:
            k.zero_()
            v.zero_()

    # ---- public API ------------------------------------------------------

    def submit(self, prompt_tokens, sampling: SamplingParams | None = None,
               tag: str = "") -> RequestHandle:
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        sp = sampling or SamplingParams()
        if len(prompt) + sp.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({sp.max_new_tokens})"
                f" exceeds engine max_len={self.max_len}")
        if self.page_size:
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

    def submit_prefilled(self, pack: _Prefilled,
                         sampling: SamplingParams | None = None,
                         tag: str = "",
                         stream_buffer: int | None = None) -> RequestHandle:
        """Admit a request whose prefill ran elsewhere (a prefill pool, or
        a drained stream being resumed): the KV prefix lands in a free
        slot and decoding continues from `pack.token` without running
        prefill here. `stream_buffer` bounds this stream's token queue
        (default: the engine's)."""
        sp = sampling or SamplingParams()
        budget = sp.max_new_tokens - pack.generated
        if budget <= 0:
            raise ValueError("prefilled request has no decode budget left")
        if pack.lens + budget > self.max_len:
            raise ValueError(
                f"kv_len({pack.lens}) + remaining({budget}) exceeds "
                f"engine max_len={self.max_len}")
        handle = RequestHandle(pack.prompt_len, sp,
                               max_buffered=stream_buffer
                               or self._stream_buffer, tag=tag)
        self._pending.put((pack, handle))
        return handle

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

    def quiesce_for_drain(self, timeout: float = 10.0) -> bool:
        """Pause the loop at a tick boundary so slot and KV state is stable
        for snapshot_active_streams(). True once the loop acked."""
        self._quiesce.set()
        return self._quiet.wait(timeout)

    def resume(self) -> None:
        self._quiesce.clear()
        self._quiet.clear()

    def snapshot_active_streams(self) -> dict:
        """Host-side snapshot of every decoding stream; quiesce first.
        Keyed by the handle's tag (else `slot{i}`); each value holds the
        per-layer KV trimmed to `lens` and the whole decode cursor, enough
        to rebuild the stream through submit_prefilled in another engine.
        The KV is (Hkv, lens, D) CPU tensors in the cache dtype, where
        the reference gives numpy: numpy has no bfloat16 of its own."""
        out: dict = {}
        with torch.no_grad(), device_context(self.device):
            for i, st in enumerate(self._slots):
                h = st.request
                if h is None or st.prefill_prompt is not None:
                    continue
                L = int(self._lens[i])
                kv = []
                if self.page_size:
                    ps = self.page_size
                    n = -(-L // ps)
                    row = torch.as_tensor(self._tables[i, :n],
                                          dtype=torch.long,
                                          device=self.device)
                    for kp, vp in self._pools:
                        Hkv, D = kp.shape[1], kp.shape[3]
                        kv.append(tuple(
                            p[row].transpose(0, 1).reshape(Hkv, n * ps, D)
                            [:, :L].to("cpu", copy=True) for p in (kp, vp)))
                else:
                    for kf, vf in self._kv:
                        kv.append((kf[i, :, :L].to("cpu", copy=True),
                                   vf[i, :, :L].to("cpu", copy=True)))
                sp = h.sampling
                out[h.tag or f"slot{i}"] = {
                    "kv": kv,
                    "prompt_len": int(h.prompt_len),
                    "lens": L,
                    "token": int(self._token[i]),
                    "generated": int(st.generated),
                    "history": list(st.history),
                    "sampling": {"max_new_tokens": sp.max_new_tokens,
                                 "temperature": sp.temperature,
                                 "top_k": sp.top_k, "top_p": sp.top_p,
                                 "eos_token": sp.eos_token},
                }
        return out

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
            st.prefill_prompt = None
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

    def _prefill_chunk(self, tokens, start: int, slot: int):
        """One chunk of a long prompt: tokens (1, C) at positions start..
        start+C, their KV written in place at the same offset of slot
        `slot`'s cache row. Returns the (C, V) logits."""
        positions = start + torch.arange(tokens.shape[1],
                                         device=self.device)[None]
        caches = [(k[slot:slot + 1], v[slot:slot + 1], start)
                  for k, v in self._kv]
        logits, _ = self.model(tokens, positions, kv_caches=caches)
        return logits[0]

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
        """Scatter a prefill's (Hkv, L, D) caches into pool pages (pool
        layout (P, Hkv, page, D)), in place. page_ids (L / page,) entries
        past the prompt point at the dummy page."""
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

    def _decode_chunk(self, token, pos, lens, temps, top_ks, top_ps,
                      tables=None):
        """K decode steps for every slot, each writing its KV at its own
        offset `lens`, in place: into the slot caches (dense), or through
        its page table into the pools (paged, given `tables`). Sampling
        stays on the device. Returns the (K, B) tokens."""
        toks = []
        for _ in range(self.decode_chunk):
            if tables is None:
                caches = [(k, v, lens) for k, v in self._kv]
            else:
                caches = [PagedKVCache(k, v, tables, lens)
                          for k, v in self._pools]
            logits, _ = self.model(token[:, None], pos[:, None],
                                   kv_caches=caches)
            token = self._sample(logits[:, 0], temps, top_ks, top_ps)
            toks.append(token)
            pos = pos + 1
            lens = lens + 1
        return torch.stack(toks)

    def _run_decode_chunk(self) -> np.ndarray:
        """One decode chunk from the host's slot state: (K, B) tokens. On
        CUDA a replay of the captured graph (captured on first use); a
        capture or replay that fails raises, there is no eager fallback."""
        for host, dev in self._staged:
            dev.copy_(host, non_blocking=True)
        if self.device.type != "cuda":
            return self._decode_chunk(*self._decode_args).numpy()
        if self._graph is None:
            self._capture_decode()
        self._graph.replay()
        self.graph_replays += 1
        return self._graph_out.cpu().numpy()

    def _capture_decode(self) -> None:
        """Capture the decode chunk as one CUDA graph, on this engine's own
        stream. An eager chunk on that stream first builds and loads the
        kernels and fills the host-side caches the kernel wrapper queries
        (device properties, resident clusters) and cuBLAS's workspace,
        none of which may happen during capture. Its tokens are discarded;
        its KV writes land at each slot's cursor, which the replay rewrites
        before anything reads them."""
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._decode_chunk(*self._decode_args)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # Each replay draws new noise from the engine's generator (an
        # unregistered generator would repeat one draw every replay).
        graph.register_generator_state(self._rng)
        before = dict(launch_counts)
        # thread_local: other engines' threads may use the card meanwhile.
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            out = self._decode_chunk(*self._decode_args)
        self.graph_launches = {k: n - before[k]
                               for k, n in launch_counts.items()}
        self._graph, self._graph_out = graph, out

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
        st.prefill_prompt = None
        st.history = []
        self._ttft.append(time.monotonic() - handle._submit_ts)
        self._emit(slot, tok)

    def _commit_prefilled(self, slot: int, handle: RequestHandle,
                          pack: _Prefilled):
        """Commit decode state for an externally prefilled stream. A fresh
        handoff (emit_first) emits the prefill's sampled first token as
        _commit_token does; a resume carries its history and cursor and
        emits nothing until decode advances."""
        sp = handle.sampling
        self._lens[slot] = pack.lens
        self._pos[slot] = pack.lens
        self._token[slot] = pack.token
        self._temps[slot] = sp.temperature
        self._topks[slot] = sp.top_k
        self._topps[slot] = sp.top_p
        st = self._slots[slot]
        st.request = handle
        st.generated = pack.generated
        st.prefill_prompt = None
        st.history = list(pack.history)
        if pack.emit_first:
            self._ttft.append(time.monotonic() - handle._submit_ts)
            self._emit(slot, pack.token)

    def _kv_prefix(self, a, length: int) -> torch.Tensor:
        """A snapshot's (Hkv, >= length, D) layer cache (numpy or CPU
        tensor) as the first `length` rows on the device, in the cache
        dtype."""
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a[:, :length]))  # writable copy
        return a[:, :length].to(self.device, self.cfg.dtype)

    def _admit(self, prompt, handle: RequestHandle) -> None:
        """Dense-mode admission into the first free slot."""
        slot = next(i for i, s in enumerate(self._slots) if s.request is None)
        if isinstance(prompt, _Prefilled):
            self._admit_prefilled_dense(slot, prompt, handle)
            return
        # Chunked only when the chunk grid fits the cache: the last chunk's
        # write window [start, start + C) must not run past max_len.
        # Otherwise the bucketed whole-prompt path (whose window is the
        # bucket) takes it.
        C = self.prefill_chunk
        grid_fits = C and -(-len(prompt) // C) * C <= self.max_len
        if C and len(prompt) > C and grid_fits:
            # Bookkeeping only: the loop advances one chunk a tick. The
            # slot's decode offset points at the cache's last index, so the
            # shared decode chunk's writes for this still-prefilling slot
            # land where nothing is read before it is written again.
            st = self._slots[slot]
            st.request = handle
            st.generated = 0
            st.prefill_prompt = prompt
            st.prefill_pos = 0
            st.history = []
            self._lens[slot] = self.max_len - 1
            self._temps[slot] = handle.sampling.temperature
            self._topks[slot] = handle.sampling.top_k
            self._topps[slot] = handle.sampling.top_p
            return
        padded = np.zeros((1, self._bucket(len(prompt))), np.int64)
        padded[0, : len(prompt)] = prompt
        with record_function("llm.prefill_one"):
            logits, kv_one = self._prefill_one(self._to_device(padded))
            if self.use_device_plane:
                kv_one = device_objects.local_handoff("llm-prefill-kv",
                                                      kv_one)
            # The slot row of every layer, written in place.
            for (kf, vf), (k1, v1) in zip(self._kv, kv_one):
                kf[slot].copy_(k1)
                vf[slot].copy_(v1)
            self._commit_first_token(slot, handle, logits[len(prompt) - 1],
                                     len(prompt))

    def _admit_prefilled_dense(self, slot: int, pack: _Prefilled,
                               handle: RequestHandle):
        """Land an external KV prefix in a dense slot row. Entries past
        `pack.lens` keep what they hold: decode masks keys by position and
        overwrites index lens before attending."""
        L = pack.lens
        for (kf, vf), (k1, v1) in zip(self._kv, pack.kv_layers):
            kf[slot, :, :L] = self._kv_prefix(k1, L)
            vf[slot, :, :L] = self._kv_prefix(v1, L)
        self._commit_prefilled(slot, handle, pack)

    def _admit_prefilled_paged(self, slot: int, seq_id: str,
                               pack: _Prefilled, handle: RequestHandle):
        """Scatter an external KV prefix into the sequence's reserved
        pages. The prefix is padded to the engine's bucket (a page
        multiple); pad pages go to the dummy page, never to a page a live
        sequence owns."""
        ps, L = self.page_size, pack.lens
        Lb = -(-max(self._bucket(L), ps) // ps) * ps
        n_real = -(-L // ps)
        row = self._alloc.table(seq_id, self._np_pages).numpy()
        page_ids = np.full(Lb // ps, self._dummy_page, np.int64)
        page_ids[:n_real] = row[:n_real]
        kv = [tuple(F.pad(self._kv_prefix(a, L), (0, 0, 0, Lb - L))
                    for a in layer) for layer in pack.kv_layers]
        self._write_prompt_pages(kv, self._to_device(page_ids))
        self._tables[slot] = row
        self._commit_prefilled(slot, handle, pack)

    def _reserve_paged(self, slot: int, prompt, handle: RequestHandle) -> str:
        """Reserve pages for the stream's whole lifetime (prompt + max_new
        + chunk overshoot) up front, so decode never fails mid-stream on
        an empty pool; MemoryError defers the request instead."""
        sp = handle.sampling
        seq_id = f"slot{slot}-{id(handle):x}"
        if isinstance(prompt, _Prefilled):
            need = prompt.lens + (sp.max_new_tokens - prompt.generated) \
                + self.decode_chunk
        else:
            need = len(prompt) + sp.max_new_tokens + self.decode_chunk
        self._alloc.allocate(seq_id, need)  # MemoryError -> caller defers
        self._slots[slot].seq_id = seq_id
        return seq_id

    def _admit_paged_group(self, cands: list) -> None:
        """Prefill reserved candidates, batching same-bucket requests
        through _prefill_many (one call for up to W streams); singleton
        groups take _prefill_one, and externally prefilled streams only
        scatter their KV. cands: (slot, seq_id, prompt or _Prefilled,
        handle) with pages already reserved."""
        for slot, seq_id, pack, handle in \
                [c for c in cands if isinstance(c[2], _Prefilled)]:
            try:
                self._admit_prefilled_paged(slot, seq_id, pack, handle)
            except Exception as e:  # the request fails, not the loop
                self._free_slot_pages(slot)
                handle._finish(e)
        groups: dict = {}
        for c in cands:
            if isinstance(c[2], _Prefilled):
                continue
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

    def _advance_prefill(self, slot: int):
        """Write one chunk of a long prompt into the slot's cache row; on
        the last chunk, sample the first token and switch to decoding."""
        st = self._slots[slot]
        prompt, C, start = st.prefill_prompt, self.prefill_chunk, \
            st.prefill_pos
        n = min(C, len(prompt) - start)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :n] = prompt[start: start + n]
        with record_function("llm.prefill_chunk"):
            logits = self._prefill_chunk(self._to_device(chunk), start, slot)
        st.prefill_pos = start + n
        if st.prefill_pos < len(prompt):
            return
        # Prompt complete: the first token from the last real position.
        self._commit_first_token(slot, st.request, logits[n - 1],
                                 len(prompt))

    def _emit(self, slot: int, tok: int) -> bool:
        """Offer one token to the stream. False = the consumer's bounded
        queue is full: the caller must not commit the token (the slot
        parks and the same token is produced again next chunk)."""
        st = self._slots[slot]
        if not st.request._offer(tok):
            self._parked_events += 1
            return False
        st.generated += 1
        st.history.append(tok)
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
        """Admit as many pending requests as there are free slots. Dense
        mode prefills each at once; paged mode gates on pool pages (a dry
        pool defers the request, FIFO) and prefills the admissions of one
        pass together."""
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
            if not self.page_size:
                try:
                    self._admit(prompt, handle)
                except Exception as e:  # the request fails, not the loop
                    handle._finish(e)
                continue
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
        # Drain: ack and idle at a tick boundary, where every token of the
        # last chunk is committed, so slot and KV state is a consistent
        # snapshot.
        if self._quiesce.is_set():
            self._quiet.set()
            self._stop.wait(0.01)
            return
        self._admit_pending()
        # One chunk of one prefilling slot a tick, round-robin: long
        # prompts interleave with decoding instead of stalling it.
        prefilling = [i for i, s in enumerate(self._slots)
                      if s.request is not None and s.prefill_prompt is not None]
        if prefilling:
            idx = prefilling[self._prefill_rr % len(prefilling)]
            self._prefill_rr += 1
            try:
                self._advance_prefill(idx)
            except Exception as e:  # the request fails, not the loop
                st = self._slots[idx]
                if st.request is not None:
                    st.request._finish(e)
                    st.request = None
                    st.prefill_prompt = None
        decoding = [s for s in self._slots
                    if s.request is not None and s.prefill_prompt is None]
        if not decoding:
            return
        # Backpressure: if every consumer's queue is full, a decode chunk
        # would produce only parked tokens; give the consumers time.
        if all(s.request.backlog_full() for s in decoding):
            self._stop.wait(0.002)
            return
        # One decode chunk for every slot (inactive and prefilling slots
        # compute garbage on their stale state, discarded here).
        try:
            with record_function("llm.decode_chunk"):
                toks = self._run_decode_chunk()  # (K, B)
        except Exception as e:
            # A decode failure must not strand waiters on a dead thread:
            # fail them all and keep serving on fresh state.
            self._fail_all(e)
            self._reset_kv()
            return
        self.decode_steps += toks.shape[0]
        for i, st in enumerate(self._slots):
            if st.request is None or st.prefill_prompt is not None:
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
