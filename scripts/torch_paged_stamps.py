"""Where a block of the K2/K3 paged decode kernel spends its time, on one
NVIDIA GPU, from timestamps taken inside the kernel.

Builds a copy of ray_tpu_torch/ops/csrc/paged_decode.cu whose bf16/f16
kernel reads the card's global timer (thread 0 of each block) at its
start, after its set-up, when its first chunk has landed, after its walk
over the chunks, around the merge's steps and at its end, and loads it in
place of the built library. Then, for B in {1, 8, 32} at chip_smoke.py's
kernel inputs (LLAMA3_8B engine shapes, bf16, the full-table sequence
alone for B 1), it flushes L2, launches the kernel once and prints one
JSON line of medians and maxima over the blocks, in microseconds: each
step's time since the stamp before it ("start": since the first block's
start). The stamps cost a few instructions a block; the kernel's times
are chip_smoke.py's, not these.

    python3 scripts/torch_paged_stamps.py [--stages N] [--splits N]
                                          [--batch B ...]

--stages builds the ring with N stages instead of the source's; --splits
forces the split count instead of `cluster_splits`' choice.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
import chip_smoke  # noqa: E402
from ray_tpu_torch import _build  # noqa: E402
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402

# The stamps, in the order a block takes them.
POINTS = ("start", "setup", "first_chunk", "walk", "parts", "block_merge",
          "cluster_barrier", "remote_reads", "end")


def _stamp(k: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
            "g_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
            f"blockIdx.x) * 16 + {k}] = t; }}\n")


def _insert(src: str, after: str, code: str, start: int) -> str:
    at = src.index(after, start) + len(after)
    return src[:at] + code + src[at:]


def stamped_source(stages: int | None) -> str:
    src = (_build.CSRC / "paged_decode.cu").read_text()
    src = src.replace(
        "namespace {\n",
        "namespace {\n__device__ unsigned long long* g_stamps;\n", 1)
    if stages:
        src = src.replace("constexpr int kStages = 2;",
                          f"constexpr int kStages = {stages};")
    k = src.index("paged_decode_cluster_kernel(const __grid_constant__")
    src = _insert(src, "extern __shared__ uint8_t smem_raw[];\n", _stamp(0), k)
    setup = "const Block blk = setup<T>(a, smem, &k_map, &v_map);\n"
    src = _insert(src, setup,
                  _stamp(1) + "  if (threadIdx.x == 0 && blk.n > 0) "
                  "mbar_wait(blk.bars, 0);\n" + _stamp(2), k)
    at = src.index("  // This warp's part: rows lane/4", k)
    src = src[:at] + _stamp(3) + src[at:]
    at = src.index("  merge_and_store<T>(a, blk, smem);\n", k)
    src = src[:at] + _stamp(4) + src[at:]
    src = _insert(src, "  merge_and_store<T>(a, blk, smem);\n", _stamp(8), k)
    m = src.index("__device__ void merge_and_store(")
    for idx, before in ((5, "  cluster_sync();  // every block's"),
                        (6, "  // Each split's copy of the area"),
                        (7, "  cluster_sync();  // peers are done")):
        at = src.index(before, m)
        src = src[:at] + _stamp(idx) + src[at:]
    return src + ('\nextern "C" int paged_decode_set_stamps(void* p) {\n'
                  "  return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")


def build(stages: int | None) -> ctypes.CDLL:
    out = _build.BUILD_ROOT / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "paged_decode_stamps.cu", out / f"lib_stamps{stages}.so"
    src.write_text(stamped_source(stages))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def main(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int)
    ap.add_argument("--splits", type=int)
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 32])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_paged_stamps: no CUDA device available")
    lib = build(args.stages)
    pa._lib = None
    real_load = _build.load
    _build.load = lambda name: lib if name == "paged_decode" else \
        real_load(name)
    if args.splits:
        pa.cluster_splits = lambda *_: args.splits
    stamps = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
    lib.paged_decode_set_stamps.argtypes = [ctypes.c_void_p]
    if lib.paged_decode_set_stamps(stamps.data_ptr()):
        sys.exit("torch_paged_stamps: cudaMemcpyToSymbol failed")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    print(chip_smoke.card_line(), flush=True)
    for B in args.batch:
        inputs, lengths = chip_smoke.kernel_inputs(
            max(B, chip_smoke.MAX_BATCH), torch.bfloat16, seed=8)
        if B == 1:
            full = lengths.index(chip_smoke.NP * chip_smoke.PAGE)
            inputs = tuple(t[full:full + 1] if i in (0, 3, 4) else t
                           for i, t in enumerate(inputs))
        for _ in range(3):  # the last launch is read
            stamps.zero_()
            flush.zero_()
            torch.cuda._sleep(chip_smoke.Timer.SPIN_CYCLES)
            pa.paged_decode_attention_batch(*inputs)
            torch.cuda.synchronize()
        rows = stamps.view(-1, 16)
        t = rows[rows[:, 0] != 0][:, :len(POINTS)].cpu()
        t = (t - t[:, 0].min()).double() / 1e3  # ns since the first start

        def stat(x):
            return {"med": round(x.median().item(), 2),
                    "max": round(x.max().item(), 2)}

        line = {"batch": B, "blocks": t.shape[0],
                "span_us": round(t[:, -1].max().item(), 2),
                "start": stat(t[:, 0])}
        for k in range(1, len(POINTS)):
            line[POINTS[k]] = stat(t[:, k] - t[:, k - 1])
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
