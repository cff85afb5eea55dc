"""Paged decode attention: single-query attention over a block-table KV
pool, and the host-side page allocator.

Port of ray_tpu/ops/paged_attention.py. The KV cache is a shared pool of
fixed-size pages, (P, Hkv, page_size, D), and each sequence owns a row of
pool indices (its page table). The three TPU kernels become one CUDA
source, `csrc/paged_decode.cu`: K2 and K3 one launch of a kernel that
splits each (sequence, KV head)'s table over a thread-block cluster and
merges the splits inside it (`cluster_splits`), K4 (`fused_heads=True`)
a split kernel and a second kernel that merges the splits
(`split_pages`).

Each public function has a plain PyTorch version (`*_reference`). A
wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device, raising on anything the kernel does
not take. `launch_counts` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_SMEM_BYTES = 232448  # per block on sm_90, as dynamic shared memory

# Kernel launches by wrapper; only a CUDA launch adds to a count.
launch_counts = {
    "paged_decode_attention": 0,
    "paged_decode_attention_batch": 0,
    "paged_decode_attention_batch_fused": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("paged_decode")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                     i32, i32, i32, i32, i32, i32, i32,
                                     ctypes.c_float, i32, ptr]
        lib.paged_decode.restype = i32
        lib.paged_decode_split.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                           ptr, i32, i32, i32, i32, i32, i32,
                                           ctypes.c_float, i32, i32, ptr]
        lib.paged_decode_split.restype = i32
        lib.paged_decode_tile.argtypes = [i32, i32, i32, i32, i32,
                                          ctypes.POINTER(i32),
                                          ctypes.POINTER(i32)]
        lib.paged_decode_tile.restype = i32
        lib.paged_decode_resident_clusters.argtypes = [i32] * 6
        lib.paged_decode_resident_clusters.restype = i32
        lib.paged_decode_smem_bytes.argtypes = [i32, i32, i32, i32, i32, i32]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_error_string.argtypes = [i32]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def paged_decode_attention_batch_reference(q, k_pool, v_pool, page_tables,
                                           lengths, *,
                                           sm_scale: float | None = None):
    """Gathers each sequence's NP pages and runs a masked f32 softmax.

    Same result as the paged kernels (they walk the same pages with an
    online softmax). A length of 0 averages V over the table's pages, as
    the TPU kernels and the CUDA kernels do."""
    B, H, D = q.shape
    _, Hkv, page_size, _ = k_pool.shape
    G = H // Hkv
    NP = page_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    idx = page_tables.long()

    def gather(pool):  # (B, NP, Hkv, page, D) -> (B, Hkv, NP * page, D)
        return pool[idx].float().permute(0, 2, 1, 3, 4).reshape(
            B, Hkv, NP * page_size, D)

    keys, values = gather(k_pool), gather(v_pool)
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, keys) * sm_scale
    tok = torch.arange(NP * page_size, device=q.device)
    valid = tok[None, :] < lengths.to(q.device)[:, None]   # (B, T)
    s = s.masked_fill(~valid[:, None, None, :], _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgt,bhtd->bhgd", p, values)
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_reference(q, k_pool, v_pool, page_table, length,
                                     *, sm_scale: float | None = None):
    """Single-sequence form of paged_decode_attention_batch_reference."""
    return paged_decode_attention_batch_reference(
        q[None], k_pool, v_pool, page_table[None], length.reshape(1),
        sm_scale=sm_scale)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def split_pages(batch: int, kv_heads: int, table_pages: int,
                sm_count: int) -> tuple[int, int]:
    """(splits, pages per split) of the fused-heads kernel K4, whose grid
    is (batch, kv_heads, splits): the fewest splits, of equal pages but
    the last, that give the grid at least two blocks an SM, and no more
    than one a page. Split s covers the table's pages [s * per,
    min((s + 1) * per, table_pages)); every split covers at least one
    page, and every page lies in exactly one split."""
    want = max(1, min(table_pages, -(-2 * sm_count // (batch * kv_heads))))
    per = -(-table_pages // want)
    while per > 1 and -(-table_pages // per) < want:
        per -= 1
    return -(-table_pages // per), per


MAX_CLUSTER = 8  # the portable thread-block cluster size


def cluster_splits(clusters: int, units: int, resident) -> int:
    """Splits of each page table for the K2/K3 kernel, whose grid is
    `clusters` (sequence, KV head, query-row group) triples, each a
    thread-block cluster of one block per split: the most, up to the
    cluster's 8 and the table's `units` chunks, that keep the whole grid
    resident at once (`resident[s - 1]`: how many clusters of s blocks
    the card holds at once, as the CUDA runtime counts them), since a
    block's fixed costs (its first cold reads, the merge) would be paid
    again by a second wave; at least 1. Split s owns the chunks
    [s * units // splits, (s + 1) * units // splits)."""
    fit = [s for s in range(1, min(MAX_CLUSTER, units) + 1)
           if clusters <= resident[s - 1]]
    return max(fit, default=1)


@functools.lru_cache(maxsize=None)
def _resident_clusters(code: int, G: int, D: int, page: int, NP: int,
                       device: int) -> tuple[int, ...]:
    """How many clusters of 1-8 blocks of the K2/K3 kernel CUDA device
    `device` (current when called) holds at once for these shapes."""
    lib = _kernels()
    counts = tuple(lib.paged_decode_resident_clusters(code, G, D, page, NP, s)
                   for s in range(1, MAX_CLUSTER + 1))
    if min(counts) < 0:
        raise RuntimeError(
            "paged decode occupancy query failed: "
            + lib.paged_decode_error_string(-min(counts)).decode())
    return counts


def _launch(q, k_pool, v_pool, tables, lengths, *, sm_scale, fused_heads):
    """Checks the kernel's inputs, launches it on the current stream of
    q's device and returns the (B, H, D) output."""
    if q.device.type != "cuda":
        raise ValueError(
            f"paged decode kernel needs CUDA or CPU tensors, got {q.device}")
    B, H, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool must both be (P, Hkv, page, D), "
                         f"got {tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _, Hkv, page_size, Dk = k_pool.shape
    NP = tables.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes "
                         "float32, bfloat16 and float16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q, k_pool and v_pool must share one dtype")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page tables and lengths must be int32")
    if Dk != D or H % Hkv or tables.shape != (B, NP) \
            or lengths.shape != (B,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, tables {tuple(tables.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if not 16 <= D <= 256 or D % 8 or not 8 <= page_size <= 128:
        raise ValueError(f"head dim {D} (16-256, a multiple of 8) or page "
                         f"size {page_size} (8-128) out of the kernel's range")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, tables,
                                           lengths)):
        raise ValueError("paged decode kernel inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("k_pool and v_pool must be 16-byte aligned")
    lib = _kernels()
    smem = lib.paged_decode_smem_bytes(H // Hkv, D, page_size,
                                       q.element_size(), NP, int(fused_heads))
    if not 0 < smem <= _MAX_SMEM_BYTES:
        raise ValueError(f"G={H // Hkv}, D={D}, page={page_size}, {NP} "
                         "pages a table: the block's shared memory does not "
                         "fit")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    code = _DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        if fused_heads:
            splits, per = split_pages(B, Hkv, NP, sms)
            part = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                               device=q.device)
            err = lib.paged_decode_split(
                code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                part.data_ptr(), B, H, Hkv, D, page_size, NP, float(sm_scale),
                splits, per, stream)
        else:
            units, row_blocks = ctypes.c_int(), ctypes.c_int()
            lib.paged_decode_tile(H // Hkv, D, page_size, q.element_size(),
                                  NP, ctypes.byref(units),
                                  ctypes.byref(row_blocks))
            splits = cluster_splits(
                B * Hkv * row_blocks.value, units.value,
                _resident_clusters(code, H // Hkv, D, page_size, NP,
                                   q.device.index))
            err = lib.paged_decode(
                code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H,
                Hkv, D, page_size, NP, k_pool.shape[0], float(sm_scale),
                splits, stream)
    if err:
        raise RuntimeError("paged decode kernel launch failed: "
                           + lib.paged_decode_error_string(err).decode())
    return out


def paged_decode_attention(q, k_pool, v_pool, page_table, length,
                           *, sm_scale: float | None = None):
    """Single-token decode attention over paged KV for one sequence.

    q: (H, D); k_pool/v_pool: (P, Hkv, page_size, D); page_table: (NP,)
    int32 pool indices (entries past the live length may be any valid
    index); length: () int32 valid tokens, the current one included.
    Returns (H, D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, page_table, length, sm_scale=sm_scale)
    out = _launch(q[None], k_pool, v_pool, page_table[None],
                  length.reshape(1), sm_scale=sm_scale, fused_heads=False)
    launch_counts["paged_decode_attention"] += 1
    return out[0]


def paged_decode_attention_batch(q, k_pool, v_pool, page_tables, lengths,
                                 *, sm_scale: float | None = None,
                                 fused_heads: bool = False):
    """Batched single-token decode attention over paged KV.

    q: (B, H, D); k_pool/v_pool: (P, Hkv, page_size, D) shared by every
    sequence; page_tables: (B, NP) int32; lengths: (B,) int32 (current
    tokens included). fused_heads: K4, the TPU's fused-heads kernel, which
    here splits each page table over several blocks and merges the splits
    in a second kernel through an f32 workspace (`split_pages`), where K3
    merges them inside one launch (`cluster_splits`).
    Returns (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_batch_reference(
            q, k_pool, v_pool, page_tables, lengths, sm_scale=sm_scale)
    out = _launch(q, k_pool, v_pool, page_tables, lengths,
                  sm_scale=sm_scale, fused_heads=fused_heads)
    launch_counts["paged_decode_attention_batch_fused" if fused_heads
                  else "paged_decode_attention_batch"] += 1
    return out


class PageAllocator:
    """Host-side free-list allocator for KV pool pages (one per engine):
    sequences grow page by page; freeing a sequence returns its pages."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))
        self._owned: dict[str, list[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def allocate(self, seq_id: str, num_tokens: int) -> list[int]:
        """Reserve pages so `seq_id` can hold num_tokens in all; grows an
        existing reservation. Raises MemoryError when the pool is dry
        (callers queue the request: admission control)."""
        owned = self._owned.setdefault(seq_id, [])
        need = self.pages_needed(num_tokens) - len(owned)
        if need > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {need} pages, {len(self._free)} free")
        for _ in range(max(0, need)):
            owned.append(self._free.pop())
        return list(owned)

    def table(self, seq_id: str, npages: int) -> torch.Tensor:
        """Fixed-width CPU int32 page table, padded with the last owned
        page so every entry is a valid index; `length` masks the pad."""
        owned = self._owned.get(seq_id, [])
        pad = owned[-1] if owned else 0
        rows = (owned + [pad] * npages)[:npages]
        return torch.tensor(rows, dtype=torch.int32)

    def free(self, seq_id: str) -> None:
        self._free.extend(reversed(self._owned.pop(seq_id, [])))
