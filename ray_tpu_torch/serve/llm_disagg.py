"""Disaggregated LLM serving: prefill and decode as separate replica
pools. Port of ray_tpu/serve/llm_disagg.py (reference: the vLLM-style
disaggregated prefill/decode deployments that Serve LLM apps wrap).

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
- **Prefill pool** (`PrefillServer`): one engine thread behind a queue,
  so `queue_depth` is an honest autoscaling signal. The router calls
  `prefill` with `tensor_transport="device"`: the per-request KV stays
  pinned on the prefill replica's card and only its descriptor travels.
- **Decode pool** (`DecodeServer`): a continuous-batching `LLMEngine`.
  `decode_stream` resolves the prefill's KV in its own process, by the
  device plane's cheapest route (ipc on one host's card), and admits it
  by `submit_prefilled`.
- **Router** (`DisaggHandle`): picks a prefill replica, hands the
  unresolved device ref to a decode replica and streams the tokens back.
  A decode replica lost mid-stream resumes with no token lost or
  repeated: a drained node's evacuation preparer snapshots each stream
  (KV, cursor, history) and the drain re-homes it to the router, which
  replays the tokens the consumer never saw and resubmits the stream on
  a surviving replica; a hard crash falls back to re-prefilling the
  prompt plus the delivered tokens.
- **`deploy_disagg`**: the two pools as Serve deployments, each
  autoscaled on its own replica-reported metric (queue depth or TTFT for
  prefill, tokens in flight for decode).

The reference's serve-disagg gauges (util/metrics, ROADMAP A1's second
part) are the module-level `disagg_counts` here, counted in the process
that notes them.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import OrderedDict, deque

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.models.generate import SamplingParams, sample_logits
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel, init_kv_caches
from ray_tpu_torch.serve.llm import LLMEngine, _Prefilled

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


def _weights(params):
    """A state_dict, or a zero-argument callable that builds one in the
    replica's own process (so large weights need not travel through the
    object store)."""
    return params() if callable(params) else params


def _pack_kv(kv) -> torch.Tensor:
    """[(k, v)] per layer, each (Hkv, n, D), as one (L, 2, Hkv, n, D)
    tensor: a hand-off by the device plane then moves one tensor (one
    IPC handle on a card) where it would move 2 L."""
    return torch.stack([torch.stack(pair) for pair in kv])


def _unpack_kv(packed) -> list:
    return [(layer[0], layer[1]) for layer in packed]


def _quantile(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))] if v else 0.0


def _sampling_from(payload: dict) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=int(payload.get("max_new_tokens", 64)),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=int(payload.get("top_k", 0)),
        top_p=float(payload.get("top_p", 1.0)),
        eos_token=payload.get("eos_token"))


class PrefillServer:
    """Prefill-pool deployment callable.

    Requests funnel through a queue served by ONE engine thread (the
    engine's cache is single-stream; the queue also keeps queue_depth an
    honest autoscaling signal while the replica actor runs several
    concurrency lanes). The router calls `prefill` with
    tensor_transport="device", so the returned KV, packed into one
    (L, 2, Hkv, n, D) tensor, pins HERE and reaches the decode replica by
    the device plane. On a card the engine
    thread synchronises its device before it hands a result over: the pin
    must not let a descriptor out while a stream still writes the KV."""

    def __init__(self, cfg: LlamaConfig, params, *, max_len: int = 1024,
                 prefix_cache_size: int = 32, rng_seed: int = 0,
                 device=None):
        self.engine = PrefillEngine(cfg, _weights(params), max_len=max_len,
                                    rng_seed=rng_seed, device=device)
        self.cache = PrefixCache(prefix_cache_size)
        self._q: queue.Queue = queue.Queue()
        self._ttft = deque(maxlen=256)
        self._prefill_s = deque(maxlen=256)   # compute alone, no queue
        self._served = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="prefill-engine")
        self._thread.start()

    def _loop(self):
        dev = self.engine.device
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            payload, done, holder, t0 = item
            try:
                sp = _sampling_from(payload)
                t1 = time.monotonic()
                result = self.engine.prefill(payload["prompt_tokens"], sp,
                                             self.cache)
                result["kv"] = _pack_kv(result["kv"])
                holder["result"] = result
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._prefill_s.append(time.monotonic() - t1)
            except BaseException as e:  # noqa: BLE001
                holder["error"] = e
            self._ttft.append(time.monotonic() - t0)
            self._served += 1
            done.set()

    def prefill(self, payload: dict) -> dict:
        done = threading.Event()
        holder: dict = {}
        self._q.put((payload, done, holder, time.monotonic()))
        if not done.wait(timeout=300):
            raise TimeoutError("prefill queue wait exceeded 300s")
        if "error" in holder:
            raise holder["error"]
        return holder["result"]

    def report_metrics(self) -> dict:
        out = {
            "queue_depth": float(self._q.qsize()),
            "served": float(self._served),
            "ttft_p50_ms": _quantile(self._ttft, 0.5) * 1e3,
            "ttft_p99_ms": _quantile(self._ttft, 0.99) * 1e3,
            "prefill_ms_p50": _quantile(self._prefill_s, 0.5) * 1e3,
        }
        for k, v in self.cache.stats().items():
            out[f"prefix_cache_{k}"] = float(v)
        from ray_tpu_torch._private import device_objects

        out["plane_counters"] = device_objects.counters()
        return out

    def prepare_drain(self):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and self._q.qsize():
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# Decode pool
# ---------------------------------------------------------------------------


class DecodeServer:
    """Decode-pool deployment callable hosting one continuous-batching
    LLMEngine. `decode_stream` resolves the prefill pool's device-object
    KV in THIS process and admits it through submit_prefilled: the KV
    never passes through the router.

    A drain loses no token: the evacuation preparer (`_evacuate_streams`,
    run inside device_objects.evacuate before it gathers the pins)
    quiesces the engine, snapshots every in-flight stream (KV gathered
    from its pages by its page table, cursor, history) and pins each
    snapshot with the ROUTER as ref owner, so the drain ships it to the
    router for the resume. The engine stays parked: the node is about to
    die, and a stream that went on here would repeat tokens after the
    resume."""

    def __init__(self, cfg: LlamaConfig, params, *, max_batch: int = 4,
                 max_len: int = 1024, decode_chunk: int = 8,
                 page_size: int = 0, kv_pool_tokens: int = 0,
                 stream_buffer: int = 256, device=None):
        self.cfg = cfg
        self.engine = LLMEngine(cfg, _weights(params), max_batch=max_batch,
                                max_len=max_len, decode_chunk=decode_chunk,
                                page_size=page_size,
                                kv_pool_tokens=kv_pool_tokens,
                                stream_buffer=stream_buffer, device=device)
        self._router_wires: dict[str, object] = {}
        self._evac_streams = 0
        self._decode_requests = 0
        # (seconds, bytes) of each KV hand-off this replica resolved.
        self._handoffs = deque(maxlen=256)
        try:
            from ray_tpu_torch._private import device_objects

            # Inside evacuate(), before the pins are gathered: a
            # DrainNotice listener would lose the race against the
            # raylet's evacuation step, which follows the notice within
            # milliseconds.
            device_objects.add_evacuation_preparer(self._evacuate_streams)
        except Exception:
            pass

    def _evacuate_streams(self):
        try:
            if not self.engine.quiesce_for_drain(timeout=8.0):
                return
            snaps = self.engine.snapshot_active_streams()
            if not snaps:
                return
            from ray_tpu_torch._private import device_objects
            from ray_tpu_torch._private.api_internal import get_core_worker

            cw = get_core_worker()
            reg = device_objects.registry()
            for tag, snap in snaps.items():
                wire = self._router_wires.get(tag)
                if wire is None:
                    continue
                prefix = f"disagg:{tag}"
                i = 0
                for k, v in snap["kv"]:
                    reg.pin(f"{prefix}#{i}", k, cw)
                    reg.pin(f"{prefix}#{i + 1}", v, cw)
                    i += 2
                state = torch.tensor([snap["lens"], snap["token"],
                                      snap["generated"], snap["prompt_len"]],
                                     dtype=torch.int64)
                reg.pin(f"{prefix}#{i}", state, cw)
                # History LAST: the router polls this key as the sentinel
                # that every leaf has landed.
                hist = torch.tensor(snap["history"], dtype=torch.int64)
                reg.pin(f"{prefix}#{i + 1}", hist, cw)
                reg.note_ref_owner(prefix, wire)
                self._evac_streams += 1
                _note("streams_evacuated")
        except Exception:
            pass  # the router's re-prefill fallback still covers the stream

    def decode_stream(self, meta: dict, kv_ref):
        import ray_tpu_torch

        # The hand-off's time starts once the prefill's result exists.
        ray_tpu_torch.wait([kv_ref], timeout=300)
        t0 = time.monotonic()
        kv_obj = ray_tpu_torch.get(kv_ref)  # device stubs resolve HERE
        packed = kv_obj["kv"]
        self._handoffs.append((time.monotonic() - t0,
                               packed.numel() * packed.element_size()))
        kv = _unpack_kv(packed)
        sp = _sampling_from(meta)
        resume = meta.get("resume")
        if resume:
            pack = _Prefilled(kv, resume["token"],
                              kv_obj["prompt_len"], resume["lens"],
                              resume["generated"], resume["history"],
                              emit_first=False)
        else:
            pack = _Prefilled(kv, kv_obj["first_token"],
                              kv_obj["prompt_len"], kv_obj["kv_len"], 0, [],
                              emit_first=True)
        del kv_obj, packed, kv
        tag = meta.get("rsid", "")
        if meta.get("router_wire") is not None:
            self._router_wires[tag] = meta["router_wire"]
        handle = self.engine.submit_prefilled(
            pack, sp, tag=tag, stream_buffer=meta.get("stream_buffer"))
        self._decode_requests += 1
        try:
            for tok in handle:
                yield tok
        finally:
            self._router_wires.pop(tag, None)

    def report_metrics(self) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch._private import device_objects

        out = self.engine.report_metrics()
        out["decode_requests"] = float(self._decode_requests)
        out["streams_evacuated"] = float(self._evac_streams)
        seconds = [s for s, _b in self._handoffs]
        total_s = sum(seconds)
        out["kv_handoff_ms_p50"] = _quantile(seconds, 0.5) * 1e3
        out["kv_handoff_gb_s"] = (sum(b for _s, b in self._handoffs)
                                  / total_s / 1e9) if total_s else 0.0
        out["plane_counters"] = device_objects.counters()
        try:
            out["node_id"] = ray_tpu_torch.get_runtime_context().node_id
        except Exception:
            pass
        return out

    def prepare_drain(self):
        """Controller scale-in: wait for in-flight streams to finish (they
        keep draining over the replica's other concurrency lanes while
        this call blocks)."""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if self.engine.num_active() == 0 and \
                    self.engine.queue_depth() == 0:
                return
            time.sleep(0.1)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


class DisaggHandle:
    """Routes one request across the two pools: prefill (a device-object
    return of the KV), then decode (streamed tokens), and resumes a stream
    whose decode replica died mid-way with no token lost or repeated."""

    def __init__(self, prefill_handle, decode_handle, *, n_layers: int,
                 prefill_name: str = "", decode_name: str = "",
                 evac_wait_s: float = 6.0, max_resumes: int = 3):
        self._prefill = prefill_handle
        self._decode = decode_handle
        self._n_layers = n_layers
        self.prefill_name = prefill_name
        self.decode_name = decode_name
        self._evac_wait_s = evac_wait_s
        self._max_resumes = max_resumes
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "completed": 0, "resumes": 0,
                      "replayed_tokens": 0, "evac_resumes": 0,
                      "fallback_reprefills": 0}
        try:
            from ray_tpu_torch._private.api_internal import get_core_worker

            self._wire = get_core_worker().address.to_wire()
        except Exception:
            self._wire = None

    def _tick(self, key: str, event: str | None = None, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n
        if event:
            _note(event, n)

    # -- pool plumbing --

    def _prefill_ref(self, payload: dict):
        """Run prefill on a prefill replica with a device-object return:
        the KV pins on the prefill worker with THIS process as ref owner;
        only the descriptor travels."""
        idx, replica = self._prefill._pick_replica()
        try:
            return replica.handle_request.options(
                tensor_transport="device").remote(
                    "prefill", [payload], {}, "")
        finally:
            # The prefill pool scales on its replica-reported metrics,
            # not on the handle's outstanding counts.
            self._prefill._done(idx)

    def _decode_gen(self, meta: dict, kv_ref, attempts: int = 1):
        """Submit one decode stream. attempts > 1 rides out the window
        after a replica death where the handle can still pick the dead
        replica (the controller needs a health tick or two to push the
        new set)."""
        last = None
        for _ in range(max(1, attempts)):
            try:
                return self._decode.options(
                    stream=True,
                    method_name="decode_stream").remote(meta, kv_ref)
            except Exception as e:  # dead replica / empty set mid-recreate
                last = e
                self._decode._last_refresh = 0.0
                time.sleep(0.5)
        raise last

    def _read_evacuated(self, rsid: str) -> dict | None:
        """Poll this process's registry for a drain-evacuated stream
        snapshot (device_objects.handle_repin pins it here under its
        original keys). None when none arrived within the window: the
        caller falls back to re-prefill."""
        from ray_tpu_torch._private import device_objects

        reg = device_objects.registry()
        prefix = f"disagg:{rsid}"
        last_key = f"{prefix}#{2 * self._n_layers + 1}"
        deadline = time.monotonic() + self._evac_wait_s
        while reg.get(last_key) is None:
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)
        kv = []
        for li in range(self._n_layers):
            k = reg.get(f"{prefix}#{2 * li}")
            v = reg.get(f"{prefix}#{2 * li + 1}")
            if k is None or v is None:
                return None
            kv.append((k, v))
        state = [int(x) for x in reg.get(f"{prefix}#{2 * self._n_layers}")]
        hist = [int(t) for t in reg.get(last_key)]
        reg.release_prefix(prefix, counted=False)
        return {"kv": kv, "lens": state[0], "token": state[1],
                "generated": state[2], "prompt_len": state[3],
                "history": hist}

    def _reship_kv(self, snap: dict):
        """Pin the evacuated KV in THIS process (on its card, where it has
        one) and hand the new decode replica a device ref to it: the
        resume's hand-off rides the same plane as the first one."""
        from ray_tpu_torch._private import device_objects

        dev = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
        return device_objects.device_put({
            "kv": _pack_kv(snap["kv"]).to(dev),
            "prompt_len": snap["prompt_len"],
            "kv_len": snap["lens"], "first_token": snap["token"]})

    # -- request path --

    def stream(self, payload: dict):
        """Generator of tokens for one request across both pools. A
        payload's `stream_buffer` bounds the stream's token queue in the
        decode replica (default: the deployment's)."""
        rsid = uuid.uuid4().hex
        self._tick("requests", "streams_started")
        meta = {"rsid": rsid, "router_wire": self._wire,
                **{k: payload[k] for k in ("max_new_tokens", "temperature",
                                           "top_k", "top_p", "eos_token",
                                           "stream_buffer")
                   if k in payload}}
        max_new = int(payload.get("max_new_tokens", 64))
        eos = payload.get("eos_token")

        def finished(delivered):
            return len(delivered) >= max_new or (
                eos is not None and delivered and delivered[-1] == eos)

        gen = self._decode_gen(meta, self._prefill_ref(payload))
        delivered: list[int] = []
        # A fallback re-prefill starts a fresh engine lineage whose
        # history and generated counts are its own: `base` maps that
        # lineage's token 0 onto the stream's position.
        base = 0
        resumes = 0
        while True:
            try:
                for tok in gen:
                    delivered.append(tok)
                    yield tok
                self._tick("completed", "streams_completed")
                return
            except Exception:
                if resumes >= self._max_resumes:
                    raise
                resumes += 1
                self._tick("resumes", "stream_resumes")
                try:
                    gen.cancel()
                except Exception:
                    pass
                if finished(delivered):
                    # The replica died between the last token and the
                    # done signal: nothing left to resume.
                    self._tick("completed", "streams_completed")
                    return
                snap = self._read_evacuated(rsid)
                if snap is not None:
                    self._tick("evac_resumes")
                    # Replay the tokens the consumer never saw (the
                    # engine's history holds ones still queued or in a
                    # lost next_chunks reply).
                    for tok in snap["history"][len(delivered) - base:]:
                        delivered.append(tok)
                        self._tick("replayed_tokens")
                        yield tok
                    if finished(delivered):
                        self._tick("completed", "streams_completed")
                        return
                    meta = dict(meta, resume={
                        "token": snap["token"], "lens": snap["lens"],
                        "generated": snap["generated"],
                        "history": snap["history"]})
                    gen = self._decode_gen(meta, self._reship_kv(snap),
                                           attempts=24)
                else:
                    # No evacuation landed (a hard crash): re-prefill the
                    # prompt plus the delivered tokens. Both the prefill
                    # payload and the decode meta get the shrunk budget:
                    # the new stream starts at generated=0.
                    self._tick("fallback_reprefills", "fallback_reprefills")
                    base = len(delivered)
                    payload2 = dict(payload)
                    payload2["prompt_tokens"] = [int(t) for t in np.asarray(
                        payload["prompt_tokens"]).reshape(-1)] + delivered
                    payload2["max_new_tokens"] = max_new - base
                    meta = dict(meta, max_new_tokens=max_new - base)
                    meta.pop("resume", None)
                    gen = self._decode_gen(meta, self._prefill_ref(payload2),
                                           attempts=24)

    def generate(self, payload: dict) -> list[int]:
        return list(self.stream(payload))

    def pool_metrics(self) -> dict:
        """Replica-reported metrics of both pools (one poll fan-out)."""
        import ray_tpu_torch

        out: dict = {}
        for label, handle in (("prefill", self._prefill),
                              ("decode", self._decode)):
            rows = []
            for r in handle._get_replicas():
                try:
                    rows.append(ray_tpu_torch.get(r.report_metrics.remote(),
                                                  timeout=10))
                except Exception:
                    pass
            out[label] = rows
        return out


# ---------------------------------------------------------------------------
# Deployment helper
# ---------------------------------------------------------------------------


def deploy_disagg(cfg: LlamaConfig, params, *, name: str = "llm",
                  prefill_replicas: int = 2, decode_replicas: int = 2,
                  max_batch: int = 4, max_len: int = 512,
                  decode_chunk: int = 4, page_size: int = 0,
                  kv_pool_tokens: int = 0, prefix_cache_size: int = 32,
                  stream_buffer: int = 256,
                  prefill_autoscaling: dict | None = None,
                  decode_autoscaling: dict | None = None,
                  prefill_actor_options: dict | None = None,
                  decode_actor_options: dict | None = None,
                  prefill_cls=PrefillServer, decode_cls=DecodeServer,
                  device=None) -> DisaggHandle:
    """Deploy the two pools under one router and return a DisaggHandle.

    params: the model's state_dict, or a zero-argument callable each
    replica calls to build it on its own device. The pools' autoscaling
    configs default to their named metrics: prefill scales on
    queue_depth, decode on tokens_in_flight. Replicas run with
    max_concurrency > 1, so a prepare_drain that blocks until streams
    finish cannot deadlock the next_chunks pulls those streams need. A
    replica takes its card through `num_gpus` in its actor options.
    `prefill_cls` and `decode_cls` take subclasses of the two servers;
    `device` (None: CUDA) is the replicas' device."""
    from ray_tpu_torch import serve

    prefill_asc = prefill_autoscaling
    if prefill_asc is None:
        prefill_asc = {"min_replicas": prefill_replicas,
                       "max_replicas": prefill_replicas}
    prefill_asc.setdefault("metric", "queue_depth")
    prefill_asc.setdefault("target_value", 4.0)
    decode_asc = decode_autoscaling
    if decode_asc is None:
        decode_asc = {"min_replicas": decode_replicas,
                      "max_replicas": decode_replicas}
    decode_asc.setdefault("metric", "tokens_in_flight")
    decode_asc.setdefault("target_value", float(max_batch * 64))

    prefill_dep = serve.deployment(
        prefill_cls, name=f"{name}-prefill",
        num_replicas=prefill_replicas,
        ray_actor_options={"max_concurrency": 8,
                           **(prefill_actor_options or {})},
        autoscaling_config=prefill_asc,
    ).bind(cfg, params, max_len=max_len,
           prefix_cache_size=prefix_cache_size, device=device)
    decode_dep = serve.deployment(
        decode_cls, name=f"{name}-decode",
        num_replicas=decode_replicas,
        ray_actor_options={"max_concurrency": 16,
                           **(decode_actor_options or {})},
        autoscaling_config=decode_asc,
    ).bind(cfg, params, max_batch=max_batch, max_len=max_len,
           decode_chunk=decode_chunk, page_size=page_size,
           kv_pool_tokens=kv_pool_tokens, stream_buffer=stream_buffer,
           device=device)
    prefill_handle = serve.run(prefill_dep)
    decode_handle = serve.run(decode_dep)
    return DisaggHandle(prefill_handle, decode_handle,
                        n_layers=cfg.n_layers,
                        prefill_name=f"{name}-prefill",
                        decode_name=f"{name}-decode")
